"""Streaming point sets, port against reference (the single-device cases of
``tests/test_streaming.py``).

A reference plan's state — the streaming state included (``alive``, the
per-slot Morton ``codes`` and their box, ``peak_alive``,
``pending_layout``) — crosses over as numpy arrays
(``convert.plan_from_reference_arrays``); both packages then take the
same deletes and inserts and must agree:

* integer artifacts exactly: ``pi``, ``inv``, ``alive``, the codes, the
  cluster-order COO, ``col_idx``, ``nbr_mask``, ``last_inserted_idx``,
  ``pending_layout`` and every integer and string field of
  ``RefreshStats``;
* float results to float32 ``rtol 1e-5``: ``vals``, the γ and fill fields
  of ``RefreshStats`` (the guard's γ is a float32 sum in another order),
  and the products, with an ``atol`` scaled to their largest magnitude.

A compaction is a fresh build on the survivors in each package, whose PCA
start and QR signs differ (ROADMAP C4), so after one only the
ordering-independent results are compared: the pattern in original order,
``compact_map``, the telemetry and the original-order products.

Arrivals are re-embedded and coded by each package's own float32
projection; on the seeded inputs below every arrival's code agrees
(asserted through the exact ``codes`` comparison).

The points are wide clusters, whose kNN gaps stand above float32
rounding. One compaction at the mixture's default spread meets the
near-ties of ROADMAP C17: its differing rows are named, shown to be
near-ties in both packages, and left out of an otherwise exact check.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close, assert_knn_near_ties, tn, tt
from _torch_parity import stream_plan_from_reference as cross_over

from repro import api as ref_api
from repro.core import blocksparse as ref_bs
from repro.core import hierarchy as ref_hier
from repro.core import ordering as ref_ord
from repro.data.pipeline import feature_mixture
from repro_torch import api as t_api
from repro_torch import convert as t_convert
from repro_torch.core import blocksparse as t_bs
from repro_torch.core import hierarchy as t_hier
from repro_torch.core import ordering as t_ord

N, D, K = 512, 32, 8
FLOAT_STATS = ("fill0", "gamma0", "last_migrated_frac",
               "ordering_drift_frac")


def _points(seed=0):
    return feature_mixture(N, D, n_clusters=8, seed=seed, spread=1.0)


def _fresh(m, seed):
    return feature_mixture(max(m, 8), D, n_clusters=8, seed=seed,
                           spread=1.0)[:m]


def _ref_plan(x, **kw):
    kw = {"k": K, "bs": 16, "sb": 4, "backend": "bsr", "ell_slack": 8,
          **kw}
    return ref_api.build_plan(x, **kw)


@pytest.fixture(scope="module")
def points():
    return _points()


@pytest.fixture(scope="module")
def ref_plan(points):
    return _ref_plan(points)


@pytest.fixture(scope="module")
def ref_cap_plan(points):
    """Built with 64 pre-allocated holes (spread through the ordering)."""
    return _ref_plan(points, capacity=N + 64)


def _scaled(got, want, rtol=1e-5):
    scale = max(float(np.abs(tn(want)).max()), 1e-30)
    assert_close(got, want, rtol=rtol, atol=rtol * scale)


def _assert_stats_alike(t, r, same_order=True):
    got, want = dataclasses.asdict(t.refresh_stats), \
        dataclasses.asdict(r.refresh_stats)
    for f, w in want.items():
        if f == "fill0" and not same_order:
            continue                     # the fill of another ordering
        if f in FLOAT_STATS and w is not None:
            assert got[f] == pytest.approx(w, rel=1e-5), f
        else:
            assert got[f] == w, f


def _assert_products_alike(t, r, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((r.n, 2)).astype(np.float32)
    _scaled(t.matvec(tt(x)), r.matvec(jnp.asarray(x), backend="bsr"))


def _orig_edges(p):
    r, c, v = p.coo
    pi = np.asarray(p.host.pi)
    key = pi[r].astype(np.int64) * p.n + pi[c]
    order = np.argsort(key)
    return key[order], np.asarray(v)[order]


def assert_streamed_alike(t, r, *, same_order=True):
    """The port's successor ``t`` of a streaming step against the
    reference's ``r``."""
    _assert_stats_alike(t, r, same_order)
    ht, hr = t.host, r.host
    assert t.n == r.n and t.n_alive == r.n_alive
    np.testing.assert_array_equal(t.alive, np.asarray(r.alive))
    assert ht.pending_layout == hr.pending_layout
    for name in ("last_inserted_idx", "compact_map"):
        a, b = getattr(ht, name), getattr(hr, name)
        assert (a is None) == (b is None), name
        if b is not None:
            np.testing.assert_array_equal(a, np.asarray(b))
    if same_order:
        assert ht.peak_alive == hr.peak_alive
        for name in ("pi", "inv", "codes", "code_lo", "code_hi"):
            a, b = getattr(ht, name), getattr(hr, name)
            assert (a is None) == (b is None), name
            if b is not None:
                np.testing.assert_array_equal(a, np.asarray(b))
                assert np.asarray(a).dtype == np.asarray(b).dtype, name
        for a, b in zip(t.coo[:2], r.coo[:2]):
            np.testing.assert_array_equal(a, np.asarray(b))
        assert_close(t.coo[2], r.coo[2], rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(tn(t.bsr.col_idx),
                                      np.asarray(r.bsr.col_idx))
        np.testing.assert_array_equal(tn(t.bsr.nbr_mask),
                                      np.asarray(r.bsr.nbr_mask))
        assert_close(t.bsr.vals, r.bsr.vals, rtol=1e-5, atol=1e-6)
        assert t.fill == pytest.approx(r.fill, rel=1e-12)
    else:
        kt, vt = _orig_edges(t)
        kr, vr = _orig_edges(r)
        np.testing.assert_array_equal(kt, kr)
        assert_close(vt, vr, rtol=1e-5, atol=1e-6)
    _assert_products_alike(t, r)


# ---------------------------------------------------------------------------
# building blocks, exact on the same numpy inputs
# ---------------------------------------------------------------------------


def test_insertion_positions_matches_reference():
    rng = np.random.default_rng(0)
    cases = [
        (np.array([1, 3, 3, 7, 9, 20], np.uint64),
         np.array([0, 4, 50, 3], np.uint64)),
        # non-monotone (stale hole codes): the running-max envelope
        (np.array([1, 9, 3, 20], np.uint64), np.array([4, 9], np.uint64)),
        (np.empty(0, np.uint64), np.array([5], np.uint64)),
        # codes above 2**53: float64 comparison would merge them
        (np.sort(rng.integers(0, 2**63, 300, dtype=np.int64)
                 ).astype(np.uint64) + np.uint64(2**63),
         rng.integers(0, 2**63, 40, dtype=np.int64).astype(np.uint64)
         + np.uint64(2**63)),
        (rng.integers(0, 1 << 30, 400).astype(np.uint64),
         rng.integers(0, 1 << 30, 50).astype(np.uint64)),
    ]
    for codes, new in cases:
        got = t_hier.insertion_positions(codes, new)
        np.testing.assert_array_equal(
            got, ref_hier.insertion_positions(codes, new))
        assert got.dtype == np.int64


def test_claim_free_slots_matches_reference():
    rng = np.random.default_rng(1)
    free = np.sort(rng.choice(5000, 300, replace=False))
    targets = rng.integers(0, 5000, 250)
    targets[:20] = targets[20]                  # many claims on one spot
    got = t_ord.claim_free_slots(free, targets)
    np.testing.assert_array_equal(got, ref_ord.claim_free_slots(free,
                                                                targets))
    assert len(set(got.tolist())) == len(got)
    got = t_ord.claim_free_slots(np.array([2, 10, 11, 40]),
                                 np.array([10, 10, 3, 39]))
    assert got.tolist() == [10, 11, 2, 40]
    with pytest.raises(ValueError) as e_t:
        t_ord.claim_free_slots(np.array([1]), np.array([0, 1]))
    with pytest.raises(ValueError) as e_r:
        ref_ord.claim_free_slots(np.array([1]), np.array([0, 1]))
    assert str(e_t.value) == str(e_r.value)


def test_stream_rebucket_matches_reference():
    rng = np.random.default_rng(2)
    n = 400
    pi = rng.permutation(n)
    codes = rng.integers(0, 60, n).astype(np.uint64)     # ties: stability
    rows = rng.integers(0, n, 3000)
    cols = rng.integers(0, n, 3000)
    got = t_ord.stream_rebucket(pi, codes, rows, cols, n)
    want = ref_ord.stream_rebucket(pi, codes, rows, cols, n)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("with_vals", [True, False])
def test_tombstone_rows_matches_reference(with_vals):
    rng = np.random.default_rng(3)
    n, bs = 160, 16
    rows = rng.integers(0, n, 700)
    cols = rng.integers(0, n, 700)
    vals = rng.standard_normal(700).astype(np.float32) if with_vals else None
    ref_b = ref_bs.build_bsr(rows, cols, vals, n, bs=bs, sb=4)
    t_b = t_convert.bsr_from_arrays(
        bs, 4, n, np.asarray(ref_b.col_idx), np.asarray(ref_b.nbr_mask),
        np.asarray(ref_b.vals), fill=ref_b.fill, device="cpu")
    dead = np.array([5, 17, 70, 159])
    want = ref_bs.tombstone_rows(ref_b, rows, cols, vals, dead)
    got = t_bs.tombstone_rows(t_b, rows, cols, vals, dead)
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(a, np.asarray(b))
    np.testing.assert_array_equal(tn(got[0].col_idx),
                                  np.asarray(want[0].col_idx))
    np.testing.assert_array_equal(tn(got[0].nbr_mask),
                                  np.asarray(want[0].nbr_mask))
    assert_close(got[0].vals, want[0].vals, rtol=1e-5, atol=1e-6)
    assert got[0].fill == pytest.approx(want[0].fill, rel=1e-12)
    d = got[0].to_dense()
    assert not d[dead].any() and not d[:, dead].any()
    # a storage primitive on patch_bsr: it writes the input's tensors
    assert got[0].vals is t_b.vals
    # nothing dead: nothing touched
    same = t_bs.tombstone_rows(t_b, rows, cols, vals, np.empty(0, int))
    assert same[0] is t_b and same[4].size == 0
    with pytest.raises(ValueError, match="out of range"):
        t_bs.tombstone_rows(t_b, rows, cols, vals, np.array([n]))


def test_seed_hole_codes_and_stream_codes_match_reference(ref_cap_plan,
                                                          ref_plan):
    rng = np.random.default_rng(4)
    live = rng.integers(0, 1 << 30, 333).astype(np.uint64)
    for n_holes in (1, 7, 333, 1000):
        np.testing.assert_array_equal(
            t_api._seed_hole_codes(live, n_holes),
            ref_api._seed_hole_codes(live, n_holes))
    # lazily derived codes (live embedding against the live box, holes
    # seeded): a plan with holes and deleted slots, and one without
    rp = ref_plan.delete(rng.choice(N, 30, replace=False))
    for r in (rp, ref_cap_plan):
        h = dataclasses.replace(r.host, codes=None)
        tp = cross_over(r)
        tp.host.codes = None
        want = ref_api._stream_codes(h, r.config)
        got = t_api._stream_codes(tp.host, tp.config, "cpu")
        np.testing.assert_array_equal(got[0], want[0])
        assert got[0].dtype == np.uint64
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[2], want[2])


@pytest.mark.parametrize("values_fn", [False, True])
def test_route_dead_edges_matches_reference(points, values_fn):
    def fn(r, c, d2):
        return (1.0 + (7 * r + c) % 5 + d2).astype(np.float32)

    rp = _ref_plan(points, values=fn if values_fn else None)
    h = rp.host
    r2, c2, v2 = (np.asarray(a) for a in h.coo)
    rng = np.random.default_rng(5)
    dead_cl = np.asarray(h.inv)[rng.choice(N, 40, replace=False)]
    want = ref_api._route_dead_edges(r2, c2, v2, dead_cl, rp.n, h, h.x,
                                     h.pi, rp.config)
    got = t_api._route_dead_edges(r2, c2, v2, dead_cl, rp.n, h, h.x,
                                  h.pi, rp.config)
    assert want[0].size > 0
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_adopt_arrivals_matches_reference(ref_plan):
    h, cfg = ref_plan.host, ref_plan.config
    r2, c2, v2 = (np.asarray(a) for a in h.coo)
    rng = np.random.default_rng(6)
    # arrivals at the positions of 12 existing points, nudged; their
    # forward edges to the existing points' neighbours
    src = rng.choice(N, 12, replace=False)
    sel = np.isin(r2, np.asarray(h.inv)[src])
    rn = r2[sel]
    cn = c2[sel]
    d2 = rng.random(rn.size).astype(np.float32) * 50.0
    want = ref_api._adopt_arrivals(r2, c2, v2, rn, cn, d2, h, h.x, h.pi,
                                   ref_plan.n, cfg)
    got = t_api._adopt_arrivals(r2, c2, v2, rn, cn, d2, h, h.x, h.pi,
                                ref_plan.n, cfg)
    assert want[3].size > 0
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_guard_gamma_matches_reference(ref_cap_plan):
    r2, c2, _ = ref_cap_plan.coo
    alive = np.asarray(ref_cap_plan.alive)[ref_cap_plan.host.pi]
    for mask in (alive, np.ones_like(alive)):
        want = ref_api._guard_gamma(r2, c2, mask, ref_cap_plan.host.sigma,
                                    ref_cap_plan.n)
        got = t_api._guard_gamma(r2, c2, mask, ref_cap_plan.host.sigma,
                                 ref_cap_plan.n, "cpu")
        assert got == pytest.approx(want, rel=1e-5)


# ---------------------------------------------------------------------------
# the tiers, on reference plans carried across
# ---------------------------------------------------------------------------


def test_build_with_capacity_matches_reference(points, ref_cap_plan):
    """``build_plan(capacity=)`` = grow + spread holes: on the reference's
    fresh build crossed over (the same ordering), the port's
    ``_spread_holes(_grow_plan(...))`` gives the reference's layout."""
    r0 = _ref_plan(points)
    t = t_api._spread_holes(t_api._grow_plan(cross_over(r0), N + 64))
    assert_streamed_alike(t, ref_cap_plan)
    assert t.capacity == N + 64 and t.n_alive == N and t.tree is None
    own = t_api.build_plan(points, k=K, bs=16, sb=4, backend="bsr",
                           ell_slack=8, capacity=N + 64, device="cpu")
    assert own.capacity == N + 64 and own.n_alive == N
    assert own.host.codes.dtype == np.uint64
    with pytest.raises(ValueError, match="capacity=500 < n=512"):
        t_api.build_plan(points, k=K, capacity=500, device="cpu")


def _delete_only(ref_plan, ref_cap_plan):
    kill = np.random.default_rng(1).choice(N, 25, replace=False)
    return ref_plan, dict(delete=kill)


def _insert_into_holes(ref_plan, ref_cap_plan):
    kill = np.random.default_rng(2).choice(N, 30, replace=False)
    return ref_plan.delete(kill), dict(insert=_fresh(30, 5))


def _insert_grows(ref_plan, ref_cap_plan):
    return ref_plan, dict(insert=_fresh(20, 6), policy="append")


def _combined(ref_plan, ref_cap_plan):
    kill = np.random.default_rng(3).choice(N, 12, replace=False)
    return ref_plan, dict(insert=_fresh(12, 7), delete=kill)


def _insert_into_capacity(ref_plan, ref_cap_plan):
    return ref_cap_plan, dict(insert=_fresh(40, 7))


def _debris_compact(ref_plan, ref_cap_plan):
    kill = np.random.default_rng(5).choice(N, int(N * 0.30), replace=False)
    return ref_plan, dict(delete=kill)


def _forced_compact(ref_plan, ref_cap_plan):
    kill = np.random.default_rng(4).choice(N, 40, replace=False)
    p = ref_plan.delete(kill)
    p, _ = p.insert(_fresh(10, 8))
    return p, dict(policy="compact")


def _defer_compact(ref_plan, ref_cap_plan):
    kill = np.random.default_rng(12).choice(N, int(0.30 * N), replace=False)
    return ref_plan, dict(delete=kill, defer_layout=True)


@pytest.mark.parametrize("scenario", [
    _delete_only, _insert_into_holes, _insert_grows, _combined,
    _insert_into_capacity, _debris_compact, _forced_compact,
    _defer_compact], ids=lambda f: f.__name__.strip("_"))
def test_streaming_tier_matches_reference(ref_plan, ref_cap_plan, scenario):
    rp, kw = scenario(ref_plan, ref_cap_plan)
    tp = cross_over(rp)
    r2 = ref_api.update_plan(rp, **kw)
    t2 = t_api.update_plan(tp, **kw)
    action = r2.refresh_stats.last_action
    assert t2.refresh_stats.last_action == action
    assert_streamed_alike(t2, r2, same_order=action != "compact")
    expect = {"delete_only": "tombstone", "debris_compact": "compact",
              "forced_compact": "compact", "defer_compact": "tombstone"}
    name = scenario.__name__.strip("_")
    assert action == expect.get(name, "append")
    if name == "insert_grows":
        assert t2.refresh_stats.grows == 1 and t2.capacity > N
    if name == "insert_into_holes":
        assert sorted(t2.host.last_inserted_idx.tolist()) == \
            sorted(np.nonzero(~np.asarray(rp.alive))[0].tolist())
    if name == "defer_compact":
        assert t2.host.pending_layout == "compact"
        r3 = ref_api.apply_pending_layout(r2)
        t3 = t_api.apply_pending_layout(t2)
        assert t3.host.pending_layout is None
        assert_streamed_alike(t3, r3, same_order=False)
        assert t_api.apply_pending_layout(t3) is t3


# survivors of ``_debris_compact`` over ``_points`` at the mixture's default
# spread whose k-th and (k+1)-th neighbours are a float32 near-tie
# (ROADMAP C17)
DEFAULT_SPREAD_NEAR_TIES = (38, 114, 242)


def test_compact_at_default_spread_matches_reference_off_near_ties():
    """The data above use wide clusters. At the mixture's default spread
    a compaction's fresh kNN meets float32 near-ties: the rows named in
    ``DEFAULT_SPREAD_NEAR_TIES`` differ, and only those; every other
    edge, value and product equals the reference's."""
    x = feature_mixture(N, D, n_clusters=8, seed=0)
    rp = _ref_plan(x)
    kill = np.random.default_rng(5).choice(N, int(N * 0.30), replace=False)
    r2 = ref_api.update_plan(rp, delete=kill)
    t2 = t_api.update_plan(cross_over(rp), delete=kill)
    assert t2.refresh_stats.last_action == \
        r2.refresh_stats.last_action == "compact"
    _assert_stats_alike(t2, r2, same_order=False)
    np.testing.assert_array_equal(t2.host.compact_map,
                                  np.asarray(r2.host.compact_map))
    survivors = x[np.asarray(r2.host.compact_map) >= 0]
    np.testing.assert_array_equal(t2.host.x, survivors)
    assert_knn_near_ties(survivors, DEFAULT_SPREAD_NEAR_TIES, K)
    (kt, vt), (kr, vr) = _orig_edges(t2), _orig_edges(r2)
    ties = np.isin(kt // t2.n, DEFAULT_SPREAD_NEAR_TIES)
    assert ties.sum() == K * len(DEFAULT_SPREAD_NEAR_TIES)
    tied_ref = np.isin(kr // r2.n, DEFAULT_SPREAD_NEAR_TIES)
    np.testing.assert_array_equal(kt[~ties], kr[~tied_ref])
    assert_close(vt[~ties], vr[~tied_ref], rtol=1e-5, atol=1e-6)
    assert not np.array_equal(kt[ties], kr[tied_ref])
    xv = np.random.default_rng(3).standard_normal((t2.n, 2)) \
        .astype(np.float32)
    keep = np.setdiff1d(np.arange(t2.n), DEFAULT_SPREAD_NEAR_TIES)
    _scaled(tn(t2.matvec(tt(xv)))[keep],
            np.asarray(r2.matvec(jnp.asarray(xv), backend="bsr"))[keep])


def test_ell_overflow_restripes_like_reference(points):
    """Zero slack: free slots inside the widest (already ELL-full) blocks,
    then far-away arrivals claim them and overflow the width — the storage
    is restriped (ordering kept, width re-derived), or refused under a
    forced in-place policy, in both packages."""
    rp = _ref_plan(points, ell_slack=0)
    widths = np.asarray(rp.bsr.nbr_mask).sum(1)
    wide = np.argsort(widths)[::-1][:8]
    victims = rp.host.pi[np.concatenate(
        [np.arange(rb * 16, rb * 16 + 2) for rb in wide])]
    rp2 = rp.delete(victims)
    tp2 = cross_over(rp2)
    # the arrivals sit apart by more than the float32 cancellation noise
    # of |a|^2 + |b|^2 - 2ab at their distance from the origin, which the
    # two packages' matrix products round differently (ROADMAP C17)
    far = np.tile(points.max(0) * 4.0, (len(victims), 1)) \
        + _fresh(len(victims), seed=9)
    r3 = ref_api.update_plan(rp2, insert=far)
    t3 = t_api.update_plan(tp2, insert=far)
    assert t3.refresh_stats.restripes == 1
    assert t3.bsr.max_nbr > tp2.bsr.max_nbr
    np.testing.assert_array_equal(t3.host.pi, tp2.host.pi)
    assert t3.host.last_patch_rb is None
    assert_streamed_alike(t3, r3)
    with pytest.raises(ValueError) as e_t:
        t_api.update_plan(tp2, insert=far, policy="append")
    with pytest.raises(ValueError) as e_r:
        ref_api.update_plan(rp2, insert=far, policy="append")
    assert str(e_t.value) == str(e_r.value)


@pytest.mark.parametrize("defer", [False, True])
def test_gamma_drift_rebucket_matches_reference(points, defer):
    """The γ guard, armed by scoring the plan once, re-sorts the slots by
    their maintained codes when displaced inserts decay the ordering — or,
    under ``defer_layout``, records a pending rebucket that
    ``apply_pending_layout`` runs."""
    rp = _ref_plan(points, capacity=N + 64, gamma_tol=1e-4)
    _ = rp.gamma
    tp = cross_over(rp)
    _ = tp.gamma                         # arms the port's guard alike
    rng = np.random.default_rng(14)
    seen = set()
    for step in range(4):
        kill = rng.choice(np.nonzero(np.asarray(rp.alive))[0], 8,
                          replace=False)
        kw = dict(insert=_fresh(8, 20 + step), delete=kill,
                  defer_layout=defer)
        rp = ref_api.update_plan(rp, **kw)
        tp = t_api.update_plan(tp, **kw)
        assert_streamed_alike(tp, rp)
        seen.add(tp.host.pending_layout if defer
                 else tp.refresh_stats.rebuckets)
        if defer and tp.host.pending_layout == "rebucket":
            rp = ref_api.apply_pending_layout(rp)
            tp = t_api.apply_pending_layout(tp)
            assert tp.refresh_stats.last_action == "rebucket"
            assert tp.host.pending_layout is None and tp.tree is None
            assert_streamed_alike(tp, rp)
    assert ("rebucket" in seen) if defer else (max(seen) >= 1)


def _error(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


def test_streaming_errors_match_reference(points, ref_plan):
    tp = cross_over(ref_plan)
    pairs = [
        (lambda p: p.delete([N + 3])),
        (lambda p: p.delete(np.arange(N - K))),
        (lambda p: p.insert(np.ones((3, D + 1), np.float32))),
        (lambda p: p.update(delete=[0], policy="nope")),
        (lambda p: p.delete([7]).delete([7])),
    ]
    for call in pairs:
        assert _error(lambda: call(tp)) == _error(lambda: call(ref_plan))
    # not streamable: no embedding map; fixed values; fixed sources
    r_prof = ref_api.build_plan(points, k=K, ordering="scattered",
                                with_bsr=False)
    t_prof = t_api.build_plan(points, k=K, ordering="scattered",
                              with_bsr=False, device="cpu")
    assert _error(lambda: t_api.update_plan(t_prof, delete=[0])) == \
        _error(lambda: ref_api.update_plan(r_prof, delete=[0]))
    vals = np.ones(N * K, np.float32)
    r_frozen = _ref_plan(points, values=vals)
    assert _error(lambda: cross_over(r_frozen).delete([0])) == \
        _error(lambda: r_frozen.delete([0]))
    r_src = _ref_plan(points, sources=points[::-1].copy())
    assert _error(lambda: cross_over(r_src).delete([0])) == \
        _error(lambda: r_src.delete([0]))
    # nothing to do returns the plan itself
    assert t_api.update_plan(tp) is tp
    assert tp.update(insert=np.empty((0, D), np.float32), delete=[]) is tp
    with pytest.raises(ValueError, match="unknown pending layout"):
        t_convert.plan_from_reference_arrays(
            {}, 4, np.arange(4), np.arange(4), None, None, None, None, 1.0,
            pending_layout="restripe", device="cpu")


def test_streamed_reference_plan_goes_on_streaming(ref_plan):
    """A plan the reference streamed (holes, codes, peak) crosses over and
    its next steps agree with the reference's."""
    rng = np.random.default_rng(21)
    rp = ref_plan
    for step in range(2):
        kill = rng.choice(np.nonzero(np.asarray(rp.alive))[0], 10,
                          replace=False)
        rp = ref_api.update_plan(rp, insert=_fresh(6, 40 + step),
                                 delete=kill)
    assert rp.host.codes is not None and rp.host.peak_alive is not None
    tp = cross_over(rp)
    for step in range(2):
        kill = rng.choice(np.nonzero(np.asarray(rp.alive))[0], 9,
                          replace=False)
        kw = dict(insert=_fresh(11, 50 + step), delete=kill)
        rp, tp = ref_api.update_plan(rp, **kw), t_api.update_plan(tp, **kw)
        assert_streamed_alike(tp, rp)


# ---------------------------------------------------------------------------
# the port against itself
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def own_plan(points):
    return t_api.build_plan(points, k=K, bs=16, sb=4, backend="bsr",
                            ell_slack=8, device="cpu")


def _dense_matvec(plan, xv):
    """y = A x off the stored tiles, original order, in float64."""
    a = plan.bsr.to_dense().astype(np.float64)
    return (a @ np.asarray(xv, np.float64)[plan.host.pi])[plan.host.inv]


def test_sustained_churn_keeps_matvec_equal_to_the_stored_tiles(own_plan):
    rng = np.random.default_rng(7)
    p = own_plan
    for step in range(6):
        live = np.nonzero(p.alive)[0]
        kill = rng.choice(live, 12, replace=False)
        p = t_api.update_plan(p, insert=_fresh(12, 100 + step), delete=kill)
        xv = rng.standard_normal(p.n).astype(np.float32)
        y = tn(p.matvec(xv))
        np.testing.assert_allclose(y, _dense_matvec(p, xv), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(y, tn(p.matvec(xv, backend="csr")),
                                   atol=1e-4)
        assert not y[~p.alive].any()          # dead rows exactly 0
    st = p.refresh_stats
    assert st.inserted_total == 72 and st.deleted_total == 72
    assert st.appends + st.compactions >= 6


def test_compact_is_bit_equal_to_a_fresh_build(own_plan):
    rng = np.random.default_rng(4)
    p2 = own_plan.delete(rng.choice(N, 40, replace=False))
    p3, ids = p2.insert(_fresh(10, seed=8))
    p4 = p3.compact()
    assert p4.refresh_stats.last_action == "compact"
    assert p4.capacity == p4.n_alive == N - 30
    fresh = t_api.build_plan(p3.host.x[p3.alive], config=p3.config,
                             device="cpu")
    for name in ("col_idx", "nbr_mask", "vals"):
        assert torch.equal(getattr(p4.bsr, name), getattr(fresh.bsr, name))
    assert torch.equal(p4.pi, fresh.pi)
    xv = rng.standard_normal(p4.n).astype(np.float32)
    assert torch.equal(p4.matvec(xv), fresh.matvec(xv))
    cmap = p4.host.compact_map
    np.testing.assert_array_equal(cmap == -1, ~p3.alive)
    surv = np.nonzero(cmap >= 0)[0]
    np.testing.assert_array_equal(p4.host.x[cmap[surv]], p3.host.x[surv])


def test_update_leaves_the_input_plan_valid(own_plan):
    """ROADMAP C6: every streaming tier writes a copy of the tiles, so the
    input plan's ``matvec`` is bit-equal before and after the step."""
    rng = np.random.default_rng(9)
    xv = rng.standard_normal(N).astype(np.float32)
    before = own_plan.matvec(xv).clone()
    tensors = [t.clone() for t in (own_plan.bsr.col_idx,
                                   own_plan.bsr.nbr_mask,
                                   own_plan.bsr.vals)]
    kill = rng.choice(N, 20, replace=False)
    p2 = own_plan.delete(kill)                          # tombstone tier
    p3, _ = p2.insert(_fresh(20, 31))                   # append tier
    y2 = p2.matvec(xv).clone()
    p4 = t_api.update_plan(p3, insert=_fresh(8, 32),
                           delete=np.nonzero(p3.alive)[0][:8])
    assert torch.equal(own_plan.matvec(xv), before)
    assert torch.equal(p2.matvec(xv), y2)
    for a, b in zip(tensors, (own_plan.bsr.col_idx, own_plan.bsr.nbr_mask,
                              own_plan.bsr.vals)):
        assert torch.equal(a, b)
    assert p4.bsr.vals.data_ptr() != p3.bsr.vals.data_ptr()
    assert own_plan.host.alive is None and own_plan.n_alive == N


def test_patch_refresh_leaves_the_input_plan_valid(points):
    """ROADMAP C6 at the refresh tier: after ``plan.refresh(...,
    policy="patch")`` the input plan's ``matvec`` is bit-equal to its
    result from before, and the two plans own separate tiles."""
    plan = t_api.build_plan(points, k=K, bs=16, sb=4, backend="bsr",
                            ell_slack=8, device="cpu")
    rng = np.random.default_rng(10)
    x2 = points.copy()
    mv = rng.choice(N, 15, replace=False)
    x2[mv] = points[(mv + N // 2) % N]
    xv = rng.standard_normal((N, 2)).astype(np.float32)
    before = plan.matvec(xv).clone()
    p2 = plan.refresh(x2, policy="patch")
    assert p2.refresh_stats.last_action == "patch"
    assert p2.refresh_stats.patched_rows > 0
    assert torch.equal(plan.matvec(xv), before)
    assert not torch.equal(p2.matvec(xv), before)
    assert p2.bsr.vals.data_ptr() != plan.bsr.vals.data_ptr()
    assert p2.host.codes is None and p2.host.last_patch_rb.size > 0


def test_insert_lands_in_preallocated_holes(points):
    p = t_api.build_plan(points, k=K, bs=16, sb=4, backend="bsr",
                         ell_slack=8, capacity=N + 64, device="cpu")
    assert p.dead_frac > 0
    p2, ids = p.insert(_fresh(40, seed=7))
    assert p2.capacity == N + 64 and p2.refresh_stats.grows == 0
    assert not p.alive[ids].any() and p2.alive[ids].all()
    np.testing.assert_array_equal(p2.host.x[ids], _fresh(40, seed=7))
    r2, _, _ = p2.coo
    for i in ids[:5]:
        assert (r2 == p2.host.inv[i]).sum() == K
    # a point re-inserted at a deleted point's coordinates claims its hole
    p3 = p2.delete([123])
    _, ids = p3.insert(p2.host.x[[123]])
    assert ids.tolist() == [123]


def test_gamma_ignores_dead_rows(own_plan, points):
    kill = np.random.default_rng(6).choice(N, 50, replace=False)
    p2 = own_plan.delete(kill)
    fresh = t_api.build_plan(points[p2.alive], config=own_plan.config,
                             device="cpu")
    assert p2.gamma == pytest.approx(fresh.gamma, rel=0.25)


def test_stream_twin_example_on_cpu():
    """``examples/stream_torch.py`` keeps every assertion of
    ``examples/stream.py``: γ within 0.9-1.1 of a fresh build, and
    ``compact()`` equal to a fresh build on the survivors."""
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(root / "src"), os.environ.get("PYTHONPATH", "")]))
    r = subprocess.run([sys.executable,
                        str(root / "examples" / "stream_torch.py"),
                        "--device", "cpu", "--n", "2048", "--steps", "10"],
                       cwd=root, env=env, capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr[-2000:]
    assert "compact == fresh build on survivors (bit-exact)" in r.stdout
    assert "streamed plan OK" in r.stdout
