"""The refresh tiers of the plan lifecycle, port against reference.

A reference plan's state — lifecycle included — crosses over as numpy
arrays (``convert.plan_from_reference_arrays``); both packages then
refresh it with the same moved points and must agree:

* integer artifacts exactly: the tier chosen, the drift and migration
  masks (hence the fractions), ``pi`` after a rebucket, ``col_idx`` /
  ``nbr_mask`` after a patch and the reordered COO;
* float results to float32 ``rtol 1e-5`` with an ``atol`` scaled to the
  output's largest magnitude (sums taken in another order): ``matvec``,
  ``tsne_attractive``, edge values.

Morton cells: the moved points are re-embedded by each package's own
float32 projection. The seeded mixtures below were checked to keep every
point away from a cell edge; ``_codes_agree`` asserts it for each case
(equal full-resolution codes from the two projections), so a failure
there names the data, not the tiers.

A rebuild runs each package's own PCA, whose start and QR signs differ
(ROADMAP C4), so after a rebuild only the ordering-independent results
are compared: the tier, the fractions, the pattern in original order and
the original-order products.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close, tn, tt
from _torch_parity import stream_plan_from_reference as cross_over

from repro import api as ref_api
from repro.core import blocksparse as ref_bs
from repro.core import hierarchy as ref_hier
from repro.core import measures as ref_meas
from repro.core.ordering import stable_partial_reorder as ref_spr
from repro.data.pipeline import feature_mixture
from repro_torch import api as t_api
from repro_torch import convert as t_convert
from repro_torch.core import blocksparse as t_bs
from repro_torch.core import hierarchy as t_hier
from repro_torch.core import measures as t_meas
from repro_torch.core.embedding import apply_pca_map as t_apply_pca_map
from repro_torch.core.ordering import stable_partial_reorder as t_spr

N, D, K = 512, 32, 8
STAT_FIELDS = ("builds", "patches", "rebuckets", "rebuilds", "last_action",
               "last_migrated_frac", "ordering_drift_frac", "patched_rows",
               "degraded")


def _points(seed=0):
    # wide clusters: neighbor distances stay large against the float32
    # cancellation noise of |a|^2 + |b|^2 - 2ab, which the two packages'
    # matrix products round differently — so near-ties do not flip a
    # neighbor between them
    return feature_mixture(N, D, n_clusters=8, seed=seed, spread=1.0)


def _teleport(x, frac, seed=1):
    """Move a fraction of points onto other clusters' locations."""
    rng = np.random.default_rng(seed)
    x2 = x.copy()
    mv = rng.choice(len(x), size=max(int(len(x) * frac), 1), replace=False)
    x2[mv] = x[(mv + len(x) // 2) % len(x)]
    x2[mv] += 0.01 * rng.standard_normal((len(mv), x.shape[1])
                                         ).astype(np.float32)
    return x2


def _projections(rp, tp, x_new):
    y_ref = np.asarray(ref_api.apply_pca_map(
        jnp.asarray(x_new), jnp.asarray(rp.host.embed_mean),
        jnp.asarray(rp.host.embed_axes)))
    y_t = tn(t_apply_pca_map(x_new, tp.host.embed_mean, tp.host.embed_axes,
                             device="cpu"))
    return y_ref, y_t


def _codes_agree(rp, tp, x_new):
    """Precondition on the data: both projections quantize alike."""
    y_ref, y_t = _projections(rp, tp, x_new)
    bits = rp.config.bits
    np.testing.assert_array_equal(
        tn(t_hier.morton_codes(y_t, bits, device="cpu")),
        np.asarray(ref_hier.morton_codes(jnp.asarray(y_ref), bits)))
    return y_ref, y_t


def _masks_agree(rp, tp, x_new):
    """The drift and migration masks of both packages are equal."""
    y_ref, y_t = _codes_agree(rp, tp, x_new)
    cfg, hr, ht = rp.config, rp.host, tp.host
    shift = ref_api._cmp_shift(rp.n, y_ref.shape[1], cfg.bits, hr.tree,
                               cfg.leaf_size)
    assert t_api._cmp_shift(tp.n, y_t.shape[1], cfg.bits, ht.tree,
                            cfg.leaf_size) == shift
    for base_r, base_t in ((hr.embedding, ht.embedding),
                           (hr.y_last, ht.y_last)):
        want = ref_api._cell_migration(base_r, y_ref, cfg.bits, shift)
        got = t_api._cell_migration(base_t, y_t, cfg.bits, shift, "cpu")
        np.testing.assert_array_equal(got, want)


def _orig_edges(p):
    r, c, v = p.coo
    key = np.asarray(p.host.pi)[r].astype(np.int64) * p.n + \
        np.asarray(p.host.pi)[c]
    order = np.argsort(key)
    return key[order], np.asarray(v)[order]


def _scaled(got, want, rtol=1e-5):
    """float32 sums in another order: rtol with an atol scaled to the
    result's largest magnitude."""
    scale = max(float(np.abs(tn(want)).max()), 1e-30)
    assert_close(got, want, rtol=rtol, atol=rtol * scale)


def assert_refreshed_alike(r2, t2, *, same_order=True, x_seed=5):
    for f in STAT_FIELDS:
        assert getattr(t2.refresh_stats, f) == \
            getattr(r2.refresh_stats, f), f
    if same_order:
        np.testing.assert_array_equal(t2.host.pi, np.asarray(r2.host.pi))
        np.testing.assert_array_equal(t2.host.inv, np.asarray(r2.host.inv))
        rr, rc, rv = r2.coo
        tr, tc, tv = t2.coo
        np.testing.assert_array_equal(tr, rr)
        np.testing.assert_array_equal(tc, rc)
        assert_close(tv, rv, rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(tn(t2.bsr.col_idx),
                                      np.asarray(r2.bsr.col_idx))
        np.testing.assert_array_equal(tn(t2.bsr.nbr_mask),
                                      np.asarray(r2.bsr.nbr_mask))
        assert_close(t2.bsr.vals, r2.bsr.vals, rtol=1e-5, atol=1e-6)
        assert t2.fill == pytest.approx(r2.fill, rel=1e-12)
        assert t2.refresh_stats.fill0 == pytest.approx(
            r2.refresh_stats.fill0, rel=1e-12)
        if r2.tree is not None:
            assert len(t2.tree.levels) == len(r2.tree.levels)
            for a, b in zip(t2.tree.levels, r2.tree.levels):
                np.testing.assert_array_equal(a, b)
    else:
        kt, vt = _orig_edges(t2)
        kr, vr = _orig_edges(r2)
        np.testing.assert_array_equal(kt, kr)
        assert_close(vt, vr, rtol=1e-5, atol=1e-6)
    # the products, in original order (ordering-independent)
    rng = np.random.default_rng(x_seed)
    x = rng.standard_normal((r2.n, 3)).astype(np.float32)
    _scaled(t2.matvec(tt(x)), r2.matvec(jnp.asarray(x), backend="bsr"))
    y = rng.standard_normal((r2.n, 2)).astype(np.float32)
    want = r2.unpermute(r2.tsne_attractive(r2.permute(jnp.asarray(y))))
    got = t2.unpermute(t2.tsne_attractive(t2.permute(tt(y))))
    _scaled(got, want)


def _knn_plans(x, **kw):
    rp = ref_api.build_plan(x, k=K, bs=16, sb=4, backend="bsr", ell_slack=8,
                            **kw)
    return rp, cross_over(rp)


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------


def test_stable_partial_reorder_matches_reference():
    rng = np.random.default_rng(0)
    n = 300
    pi = rng.permutation(n)
    keys = rng.integers(0, 40, n)               # many ties: tiebreak shows
    np.testing.assert_array_equal(t_spr(pi, keys), ref_spr(pi, keys))


def test_tree_rebucket_matches_reference():
    rng = np.random.default_rng(1)
    y = rng.standard_normal((700, 3)).astype(np.float32)
    prev_r = ref_hier.build_tree(y, bits=10, leaf_size=32)
    prev_t = t_hier.Tree(perm=np.asarray(prev_r.perm),
                         levels=[np.asarray(lv) for lv in prev_r.levels],
                         d=prev_r.d, bits=prev_r.bits)
    y2 = y.copy()
    mv = rng.choice(700, 60, replace=False)
    y2[mv] = rng.standard_normal((60, 3)).astype(np.float32)
    want = ref_hier.rebucket(y2, prev_r, leaf_size=32)
    got = t_hier.rebucket(y2, prev_t, leaf_size=32, device="cpu")
    np.testing.assert_array_equal(got.perm, np.asarray(want.perm))
    assert len(got.levels) == len(want.levels)
    for a, b in zip(got.levels, want.levels):
        np.testing.assert_array_equal(a, b)


def _random_coo(seed, n, per_row):
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), per_row)
    # near-diagonal columns, like an ordered kNN pattern
    cols = np.clip(rows + rng.integers(-40, 41, len(rows)), 0, n - 1)
    key = rows.astype(np.int64) * n + cols
    _, first = np.unique(key, return_index=True)
    rows, cols = rows[first], cols[first]
    return rows, cols, rng.random(len(rows)).astype(np.float32)


@pytest.mark.parametrize("with_vals", [True, False])
def test_patch_bsr_matches_reference(with_vals):
    n, bs, sb = 300, 16, 4
    rows, cols, vals = _random_coo(3, n, 6)
    rb_ref = ref_bs.build_bsr(rows, cols, vals, n, bs=bs, sb=sb, slack=3)
    rb_t = t_convert.bsr_from_arrays(
        bs, sb, n, np.asarray(rb_ref.col_idx), np.asarray(rb_ref.nbr_mask),
        np.asarray(rb_ref.vals), fill=rb_ref.fill, device="cpu")
    # rows 40..71 get a new neighborhood 100 columns away
    rng = np.random.default_rng(4)
    keep = ~((rows >= 40) & (rows < 72))
    new_r = np.repeat(np.arange(40, 72), 5)
    new_c = new_r + 100 + rng.integers(-20, 21, len(new_r))
    key = new_r.astype(np.int64) * n + new_c
    _, first = np.unique(key, return_index=True)
    r2 = np.concatenate([rows[keep], new_r[first]])
    c2 = np.concatenate([cols[keep], new_c[first]])
    v2 = (np.concatenate([vals[keep], rng.random(len(first))]
                         ).astype(np.float32) if with_vals else None)
    touched = np.unique(np.concatenate([np.arange(40, 72) // bs]))
    want = ref_bs.patch_bsr(rb_ref, r2, c2, v2, touched)
    got = t_bs.patch_bsr(rb_t, r2, c2, v2, touched)
    np.testing.assert_array_equal(tn(got.col_idx), np.asarray(want.col_idx))
    np.testing.assert_array_equal(tn(got.nbr_mask),
                                  np.asarray(want.nbr_mask))
    # one value per tile entry, scattered onto zeros: exact
    np.testing.assert_array_equal(tn(got.vals), np.asarray(want.vals))
    assert got.fill == want.fill and got.max_nbr == want.max_nbr
    # and the patch equals a fresh build at the pinned width
    fresh = t_bs.build_bsr(r2, c2, v2, n, bs=bs, sb=sb,
                           max_nbr=rb_t.max_nbr, device="cpu")
    np.testing.assert_array_equal(tn(got.col_idx), tn(fresh.col_idx))
    np.testing.assert_array_equal(tn(got.vals)[touched],
                                  tn(fresh.vals)[touched])


def test_patch_bsr_updates_the_resident_tensors_in_place():
    """The port's stated divergence: the patched BSR shares its tensors
    with the input (no copy of the tile tensor)."""
    n, bs = 200, 16
    rows, cols, vals = _random_coo(5, n, 4)
    b = t_bs.build_bsr(rows, cols, vals, n, bs=bs, sb=4, slack=2,
                       device="cpu")
    ptr = b.vals.data_ptr()
    keep = rows >= bs
    got = t_bs.patch_bsr(b, rows[keep], cols[keep], vals[keep],
                         np.array([0]))
    assert got.vals.data_ptr() == ptr and got.vals is b.vals
    assert not b.vals[0].any() and not b.nbr_mask[0].any()
    assert t_bs.patch_bsr(b, rows, cols, vals, np.empty(0, int)) is b


def test_patch_bsr_overflow_raises_like_reference():
    n, bs = 128, 16
    rows = np.repeat(np.arange(n), 2)
    cols = np.clip(rows + np.tile([0, 1], n), 0, n - 1)
    rb_ref = ref_bs.build_bsr(rows, cols, None, n, bs=bs, sb=4)
    rb_t = t_bs.build_bsr(rows, cols, None, n, bs=bs, sb=4, device="cpu")
    before = tn(rb_t.vals).copy()
    # row-block 0 suddenly touches every column block
    r2 = np.concatenate([rows, np.zeros(8, int)])
    c2 = np.concatenate([cols, np.arange(8) * bs])
    with pytest.raises(ValueError) as e_ref:
        ref_bs.patch_bsr(rb_ref, r2, c2, None, np.array([0]))
    with pytest.raises(ValueError) as e_t:
        t_bs.patch_bsr(rb_t, r2, c2, None, np.array([0]))
    assert str(e_t.value) == str(e_ref.value)
    assert "rebuild the BSR" in str(e_t.value)
    np.testing.assert_array_equal(tn(rb_t.vals), before)   # untouched
    with pytest.raises(ValueError, match="out of range"):
        t_bs.patch_bsr(rb_t, rows, cols, None, np.array([rb_t.n_rb]))


@pytest.mark.parametrize("ref,now", [
    (None, 1.0), (1.0, None), (0.0, 1.0), (2.0, 1.5), (2.0, 2.5),
    (-4.0, -3.0), (0.35, 0.35)])
def test_drift_measures_match_reference(ref, now):
    assert t_meas.gamma_drift(ref, now) == ref_meas.gamma_drift(ref, now)
    assert t_meas.fill_drift(ref, now) == ref_meas.fill_drift(ref, now)


# ---------------------------------------------------------------------------
# refresh_plan on plans carried across
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("policy,frac,seed", [
    ("patch", 0.03, 1), ("rebucket", 0.03, 5), ("rebuild", 0.03, 6),
    ("auto", 0.0, 0), ("auto", 0.03, 1), ("auto", 0.3, 3)])
def test_refresh_tier_matches_reference(policy, frac, seed):
    x = _points()
    rp, tp = _knn_plans(x)
    x2 = _teleport(x, frac, seed) if frac else x.copy()
    _masks_agree(rp, tp, x2)
    pol = None if policy == "auto" else policy
    r2 = rp.refresh(x2, policy=pol)
    t2 = tp.refresh(x2, policy=pol)
    expect = {"patch": "patch", "rebucket": "rebucket",
              "rebuild": "rebuild"}.get(policy)
    if expect:
        assert r2.refresh_stats.last_action == expect
    if frac == 0.0:
        assert t2.refresh_stats.last_migrated_frac == 0.0
        assert t2.bsr is tp.bsr          # nothing to patch: storage shared
    assert_refreshed_alike(
        r2, t2, same_order=r2.refresh_stats.last_action != "rebuild")


def test_refresh_auto_tiers_cover_all_three():
    """The three auto cases above land on three different tiers."""
    x = _points()
    rp, _ = _knn_plans(x)
    tiers = {rp.refresh(_teleport(x, f, s) if f else x).refresh_stats
             .last_action for f, s in ((0.0, 0), (0.15, 2), (0.6, 3))}
    assert tiers == {"patch", "rebucket", "rebuild"}
    _, tp = _knn_plans(x)
    assert {tp.refresh(_teleport(x, f, s) if f else x).refresh_stats
            .last_action for f, s in ((0.0, 0), (0.15, 2), (0.6, 3))} \
        == tiers


def test_refresh_lineage_carried_across():
    """patch -> rebucket -> patch on one lineage: every step agrees, and
    the values callable re-dresses migrated rows in both packages."""
    x = _points()

    def fn(r, c, d2):
        # a function of the edge itself, so both packages compute the same
        # float32 values (kNN distances carry float32 cancellation noise,
        # |a|^2 + |b|^2 - 2ab, that the two packages round differently)
        return (1.0 + (7 * r + c) % 5).astype(np.float32)

    rp, tp = _knn_plans(x, values=fn)
    assert tp.host.values_mode == "fn"
    xs = x
    for i, (policy, frac, seed) in enumerate(
            (("patch", 0.03, 9), ("rebucket", 0.04, 10),
             ("patch", 0.02, 11))):
        xs = _teleport(xs, frac, seed)
        _masks_agree(rp, tp, xs)
        rp = rp.refresh(xs, policy=policy)
        tp = tp.refresh(xs, policy=policy)
        assert tp.refresh_stats.last_action == policy
        assert_refreshed_alike(rp, tp, x_seed=i)
    assert tp.refresh_stats.patches == 2 and tp.refresh_stats.rebuckets == 1


def test_refresh_sources_mode_matches_reference():
    x = _points()
    rng = np.random.default_rng(17)
    t = x + 0.05 * rng.standard_normal(x.shape).astype(np.float32)
    rp, tp = _knn_plans(t, sources=x)
    assert tp.host.sources is not None
    t2 = t.copy()
    mv = rng.choice(N, 12, replace=False)
    t2[mv] = x[(mv + N // 2) % N]
    _masks_agree(rp, tp, t2)
    # tp is refreshed by both policies in turn: the patch tier leaves its
    # input plan valid (ROADMAP C6)
    for policy in ("patch", None):
        r2 = rp.refresh(t2, policy=policy)
        t2p = tp.refresh(t2, policy=policy)
        assert_refreshed_alike(r2, t2p)
        src = rng.standard_normal((N, D)).astype(np.float32)
        want = r2.meanshift_step(r2.permute(jnp.asarray(t2)),
                                 r2.permute(jnp.asarray(src)), 2.0)
        got = t2p.meanshift_step(t2p.permute(tt(t2)), t2p.permute(tt(src)),
                                 2.0)
        _scaled(got, want)


@pytest.mark.parametrize("policy,frac", [(None, 0.3), ("rebucket", 0.05),
                                         ("patch", 0.05)])
def test_refresh_fixed_pattern_matches_reference(policy, frac):
    """from_coo plans (externally fixed pattern) refresh their ordering
    only: edges and values stay, in original order."""
    x = _points()
    rows, cols, vals = _random_coo(7, N, K)
    perm = np.random.default_rng(8).permutation(N)   # not ordered yet
    rows, cols = perm[rows], perm[cols]
    rp = ref_api.InteractionPlan.from_coo(rows, cols, vals, N, x=x, bs=16,
                                          sb=4)
    tp = cross_over(rp)
    assert not tp.host.pattern_from_knn
    x2 = _teleport(x, frac, seed=8)
    _masks_agree(rp, tp, x2)
    r2 = rp.refresh(x2, policy=policy)
    t2 = tp.refresh(x2, policy=policy)
    assert_refreshed_alike(
        r2, t2, same_order=r2.refresh_stats.last_action != "rebuild")
    np.testing.assert_array_equal(_orig_edges(t2)[0], _orig_edges(tp)[0])


def test_refresh_errors_match_reference():
    x = _points()
    rp, tp = _knn_plans(x)

    def err(fn):
        with pytest.raises(ValueError) as e:
            fn()
        return str(e.value)

    assert err(lambda: tp.refresh(x, policy="nope")) == \
        err(lambda: rp.refresh(x, policy="nope"))
    assert err(lambda: tp.refresh(x[:-1])) == err(lambda: rp.refresh(x[:-1]))
    assert err(lambda: tp.refresh(x[:, :-1])) == \
        err(lambda: rp.refresh(x[:, :-1]))
    prof_r = ref_api.build_plan(x, k=K, ordering="scattered", with_bsr=False)
    prof_t = t_api.build_plan(x, k=K, ordering="scattered", with_bsr=False,
                              device="cpu")
    assert err(lambda: t_api.refresh_plan(prof_t, x)) == \
        err(lambda: ref_api.refresh_plan(prof_r, x))
    with pytest.raises(ValueError, match="values_fn"):
        t_convert.plan_from_reference_arrays(
            {}, 4, np.arange(4), np.arange(4), None, None, None, None, 1.0,
            values_mode="fn", device="cpu")
    with pytest.raises(ValueError, match="unknown RefreshStats fields"):
        t_convert.plan_from_reference_arrays(
            {}, 4, np.arange(4), np.arange(4), None, None, None, None, 1.0,
            refresh={"patchez": 1}, device="cpu")


def test_rebucket_without_tree_arrays_reorders_like_reference():
    """A host restored without its tree levels still refreshes its
    ordering, by a stable re-sort of the new codes
    (``stable_partial_reorder``), as the reference's fallback does."""
    x = _points()
    rp, _ = _knn_plans(x)
    rp = ref_api.InteractionPlan(rp.config, rp.n, rp.bsr, rp.pi, rp.inv,
                                 dataclasses.replace(rp.host, tree=None))
    tp = cross_over(rp)
    assert tp.host.tree is None
    x2 = _teleport(x, 0.03, seed=5)
    _masks_agree(rp, tp, x2)
    r2 = rp.refresh(x2, policy="rebucket")
    t2 = tp.refresh(x2, policy="rebucket")
    assert t2.refresh_stats.last_action == "rebucket" and t2.tree is None
    assert_refreshed_alike(r2, t2)


def test_patch_overflow_escalates_like_reference():
    """With no ELL slack a large forced patch overflows the pinned width:
    both packages escalate to rebucket."""
    x = _points()
    rp = ref_api.build_plan(x, k=K, bs=16, sb=4, backend="bsr")
    tp = cross_over(rp)
    x2 = _teleport(x, 0.2, seed=12)
    _masks_agree(rp, tp, x2)
    r2 = rp.refresh(x2, policy="patch")
    t2 = tp.refresh(x2, policy="patch")
    assert r2.refresh_stats.last_action == "rebucket"
    assert_refreshed_alike(r2, t2)


def test_gamma_drift_monitor_matches_reference():
    x = _points()
    rp, tp = _knn_plans(x)
    assert tp.gamma_drift() == 0.0 == rp.gamma_drift()   # pins γ0
    assert tp.refresh_stats.gamma0 == pytest.approx(rp.refresh_stats.gamma0,
                                                    rel=1e-5)
    x2 = _teleport(x, 0.05, seed=10)
    _masks_agree(rp, tp, x2)
    r2 = rp.refresh(x2, policy="patch")
    t2 = tp.refresh(x2, policy="patch")
    assert t2.refresh_stats.gamma0 == pytest.approx(rp.gamma, rel=1e-5)
    assert t2.gamma_drift() == pytest.approx(r2.gamma_drift(), abs=1e-5)
