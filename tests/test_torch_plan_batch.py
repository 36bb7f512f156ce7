"""Batched plans: ``PlanBatch`` / ``build_plan_batch`` against the reference.

Reference members cross over as numpy arrays (``convert``) and are stacked
by both packages: the stacked ``pi``/``inv``/``col_idx``/``nbr_mask`` must be
exactly equal, tiles equal, and the batched ``matvec``/``apply`` equal to
float32 ``rtol 1e-5`` on every batched backend. The port's own
``build_plan_batch`` (other random draws in its embedding, so other
permutations) is held to invariants: each member's matvec equals its own
dense ``A @ x``.

Lockstep streaming (``PlanBatch.update``): members of a reference batch
cross over with their streaming state; both packages pad ragged members
to the pow2 capacity and take the same per-member deletes and inserts,
and the stacked integer tensors must stay exactly equal. Against itself,
the port's batch must equal single-plan updates of its members, and the
input batch must keep its ``matvec`` bit for bit (ROADMAP C6).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import TOL, assert_close, plan_from_reference, tn
from _torch_parity import assert_knn_near_ties, stream_plan_from_reference

from repro import api as ref_api
from repro.core import clusterkv as ref_ckv
from repro.data.pipeline import feature_mixture
from repro_torch import api as t_api
from repro_torch.core import clusterkv as t_ckv
from repro_torch.kernels import bsr_spmv as t_bsr


@pytest.fixture(scope="module")
def batches():
    """A reference batch of six 96-point members (ELL widths differ, so
    stacking pads) and the port's stack of the same members."""
    rng = np.random.default_rng(0)
    xs = [feature_mixture(96, 8, n_clusters=1 + i, seed=i) if i % 2
          else rng.standard_normal((96, 8)).astype(np.float32)
          for i in range(6)]
    ref_plans = [ref_api.build_plan(x, k=5, bs=16, sb=4, backend="bsr")
                 for x in xs]
    rb = ref_api.PlanBatch.from_plans(ref_plans)
    tb = t_api.PlanBatch.from_plans([plan_from_reference(p) for p in ref_plans])
    return ref_plans, rb, tb


def test_stacking_is_exact(batches):
    ref_plans, rb, tb = batches
    widths = {p.bsr.max_nbr for p in ref_plans}
    assert len(widths) > 1, "the members should need ELL padding"
    assert tb.spec.shape_key == rb.spec.shape_key
    assert tb.batch == rb.batch == 6 and tb.capacity == rb.capacity
    for name in ("pi", "inv", "col_idx", "nbr_mask"):
        np.testing.assert_array_equal(tn(getattr(tb.data, name)),
                                      np.asarray(getattr(rb.data, name)))
    np.testing.assert_array_equal(tn(tb.data.vals), np.asarray(rb.data.vals))
    assert tb.data.alive is None and rb.data.alive is None
    np.testing.assert_array_equal(tb.n_alive, rb.n_alive)
    assert tb.stats["max_nbr"] == rb.stats["max_nbr"]
    assert tb.stats["fill_mean"] == pytest.approx(rb.stats["fill_mean"])


@pytest.mark.parametrize("backend", ["bsr", "bsr_ml", "cuda"])
@pytest.mark.parametrize("f", [None, 3])
@pytest.mark.parametrize("mode", ["matvec", "apply"])
def test_batched_products_match_reference(batches, backend, f, mode):
    _, rb, tb = batches
    rng = np.random.default_rng(1)
    shape = (tb.batch, tb.capacity) + (() if f is None else (f,))
    x = rng.standard_normal(shape).astype(np.float32)
    want = getattr(rb, mode)(jnp.asarray(x), backend="bsr")
    got = getattr(tb, mode)(x, backend=backend)
    assert tuple(got.shape) == shape
    assert_close(got, want)
    serial = getattr(tb, mode)(x, backend=backend, serial=True)
    assert_close(serial, want)


def test_cuda_batched_backend_is_one_call_for_the_whole_batch(batches,
                                                              monkeypatch):
    """``backend="cuda"`` hands the whole stack to the batched kernel
    wrapper once, with the stacked ``nbr_mask`` and without the per-call
    index check (on the CPU it returns its plain version)."""
    _, _, tb = batches
    calls = []
    real = t_bsr.bsr_spmv_batched

    def spy(vals, col_idx, xs, nbr_mask=None, **kw):
        calls.append((tuple(vals.shape), tuple(nbr_mask.shape), kw))
        return real(vals, col_idx, xs, nbr_mask, **kw)

    monkeypatch.setattr(t_bsr, "bsr_spmv_batched", spy)
    x = np.ones((tb.batch, tb.capacity), np.float32)
    y = tb.matvec(x, backend="cuda")
    assert calls == [(tuple(tb.data.vals.shape),
                      tuple(tb.data.nbr_mask.shape),
                      {"indices_checked": True})]
    assert_close(y, tb.matvec(x, backend="bsr"))


def test_members_are_working_plans(batches):
    ref_plans, rb, tb = batches
    x = np.random.default_rng(2).standard_normal(
        (tb.batch, tb.capacity)).astype(np.float32)
    yb = tb.matvec(x)
    assert tb.resolve_backend() == "bsr"        # the config's backend
    for i, m in enumerate(tb.members()):
        assert m.n == tb.capacity and m.bsr.max_nbr == tb.spec.max_nbr
        assert_close(m.matvec(x[i]), yb[i])
        assert_close(m.matvec(x[i]),
                     ref_plans[i].matvec(jnp.asarray(x[i])))
    assert len(tb) == 6 and "PlanBatch(B=6" in repr(tb)
    assert len(tb.refresh_stats) == 6


def test_pad_charges_and_charge_validation(batches):
    _, rb, tb = batches
    ch = [np.arange(tb.capacity, dtype=np.float32) + i for i in range(6)]
    np.testing.assert_array_equal(tn(tb.pad_charges(ch)),
                                  np.asarray(rb.pad_charges(ch)))
    with pytest.raises(ValueError, match="charge arrays for batch"):
        tb.pad_charges(ch[:2])
    with pytest.raises(ValueError, match="batched charges must be"):
        tb.matvec(np.ones((6, tb.capacity + 1), np.float32))
    with pytest.raises(ValueError, match="cannot run batched"):
        tb.matvec(np.ones((6, tb.capacity), np.float32), backend="csr")
    with pytest.raises(ValueError, match="unknown SpMV backend"):
        tb.matvec(np.ones((6, tb.capacity), np.float32), backend="bsrr")


@pytest.mark.parametrize("n", [1, 2, 3, 17, 64, 65, 100, 1000, 4097])
@pytest.mark.parametrize("bs", [8, 32])
def test_pow2_capacity_matches_reference(n, bs):
    assert t_api._pow2_capacity(n, bs) == ref_api._pow2_capacity(n, bs)


def test_from_plans_rejects_mixed_members():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((64, 6)).astype(np.float32)
    a = t_api.build_plan(x, k=4, bs=8, sb=2, device="cpu")
    b = t_api.build_plan(x, k=5, bs=8, sb=2, device="cpu")
    prof = t_api.build_plan(x, k=4, bs=8, sb=2, device="cpu", with_bsr=False)
    with pytest.raises(ValueError, match="share one PlanConfig"):
        t_api.PlanBatch.from_plans([a, b])
    with pytest.raises(ValueError, match="cannot mix profile-only"):
        t_api.PlanBatch.from_plans([a, prof])
    with pytest.raises(ValueError, match="at least one plan"):
        t_api.PlanBatch.from_plans([])
    with pytest.raises(ValueError, match="capacity=32 < largest"):
        t_api.PlanBatch.from_plans([a], capacity=32)
    pb = t_api.PlanBatch.from_plans([prof, prof])
    with pytest.raises(ValueError, match="profile-only batch"):
        pb.matvec(np.ones((2, 64), np.float32))
    # a step with nothing to stream re-stacks the members unchanged
    assert pb.update(insert=None).spec == pb.spec
    with pytest.raises(ValueError, match="profile-only batch"):
        pb.solve(np.ones((2, 64), np.float32))


def test_build_plan_batch_matches_dense_products():
    rng = np.random.default_rng(4)
    xs = rng.standard_normal((5, 128, 12)).astype(np.float32)
    pb = t_api.build_plan_batch(xs, k=6, bs=16, sb=4, backend="bsr",
                                values=lambda r, c, d2: np.exp(-d2),
                                device="cpu")
    assert pb.batch == 5 and pb.capacity == 128
    x = rng.standard_normal((5, 128, 2)).astype(np.float32)
    y = tn(pb.matvec(x, backend="cuda"))
    for i, m in enumerate(pb.members()):
        r, c, v = m.coo
        dense = np.zeros((128, 128))
        np.add.at(dense, (m.host.pi[r], m.host.pi[c]), v)
        np.testing.assert_allclose(y[i], dense @ x[i], rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="must be None or a callable"):
        t_api.build_plan_batch(xs, values=np.ones(3), device="cpu")


def test_kv_plan_batch_orders_every_head():
    """``kv_plan_batch`` builds one plan per (batch, kv head) and
    ``plan_batch_perm`` stacks their orderings like the reference's."""
    rng = np.random.default_rng(5)
    k = rng.standard_normal((2, 3, 64, 16)).astype(np.float32)
    tb = t_ckv.kv_plan_batch(torch.from_numpy(k), with_bsr=True)
    rb = ref_ckv.kv_plan_batch(jnp.asarray(k), with_bsr=True)
    assert tb.batch == rb.batch == 6
    assert tb.spec.config == t_api.PlanConfig(**dataclasses.asdict(
        rb.spec.config))
    perm = t_ckv.plan_batch_perm(tb, (2, 3))
    assert tuple(perm.shape) == (2, 3, 64) and perm.dtype == torch.int64
    for row in tn(perm).reshape(6, 64):
        np.testing.assert_array_equal(np.sort(row), np.arange(64))
    with pytest.raises(ValueError, match="needs 4"):
        t_ckv.plan_batch_perm(tb, (2, 2))
    # the reference's members carried across stack to its exact orderings
    tb2 = t_api.PlanBatch.from_plans([plan_from_reference(p) for p in rb.members()])
    np.testing.assert_array_equal(
        tn(t_ckv.plan_batch_perm(tb2, (2, 3))),
        np.asarray(ref_ckv.plan_batch_perm(rb, (2, 3))))
    x = rng.standard_normal((6, 64)).astype(np.float32)
    assert_close(tb2.matvec(x, backend="cuda"),
                 rb.matvec(jnp.asarray(x), backend="bsr"), **TOL["f32"])


# ---------------------------------------------------------------------------
# members of different sizes and lockstep streaming
# ---------------------------------------------------------------------------

SB, SN, SD, SK = 3, 256, 32, 8


def _stream_points(seed0=60, n=SN, b=SB):
    # wide clusters: kNN distances stand above the float32 cancellation
    # noise that the two packages' matrix products round differently
    return [feature_mixture(n, SD, n_clusters=8, seed=seed0 + s, spread=1.0)
            for s in range(b)]


def _arrivals(m, seed):
    return feature_mixture(max(m, 8), SD, n_clusters=8, seed=seed,
                           spread=1.0)[:m]


@pytest.fixture(scope="module")
def stream_batches():
    """A reference batch built with 64 spare slots per member, and the
    port's stack of the same members (streaming state included)."""
    rb = ref_api.build_plan_batch(_stream_points(), k=SK, bs=16, sb=4,
                                  backend="bsr", ell_slack=4,
                                  capacity=SN + 64)
    tb = t_api.PlanBatch.from_plans(
        [stream_plan_from_reference(m) for m in rb.members()])
    return rb, tb


def _assert_stacks_equal(tb, rb, members=None):
    """The stacked tensors of ``members`` (default: all) exactly equal,
    tiles to float32 ``rtol 1e-5``."""
    assert tb.spec.shape_key == rb.spec.shape_key
    idx = list(range(tb.batch)) if members is None else list(members)
    for name in ("pi", "inv", "col_idx", "nbr_mask", "alive"):
        np.testing.assert_array_equal(
            tn(getattr(tb.data, name))[idx],
            np.asarray(getattr(rb.data, name))[idx])
    assert_close(tn(tb.data.vals)[idx], np.asarray(rb.data.vals)[idx],
                 rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(tb.n_alive, rb.n_alive)
    for i in idx:
        np.testing.assert_array_equal(tb.hosts[i].codes, rb.hosts[i].codes)
    for ht, hr in zip(tb.hosts, rb.hosts):
        assert ht.refresh.last_action == hr.refresh.last_action


def test_ragged_members_pad_to_pow2_capacity_like_reference():
    """Members of 100, 200 and 300 points stack at capacity 512: each is
    grown and its holes spread through its ordering, as the reference
    pads them (the same layout, exactly)."""
    sizes = [100, 200, 300]
    xs = [feature_mixture(n, SD, n_clusters=4, seed=s, spread=1.0)
          for s, n in enumerate(sizes)]
    ref_plans = [ref_api.build_plan(x, k=SK, bs=16, sb=4, backend="bsr")
                 for x in xs]
    rb = ref_api.PlanBatch.from_plans(ref_plans)
    tb = t_api.PlanBatch.from_plans(
        [stream_plan_from_reference(p) for p in ref_plans])
    assert tb.capacity == rb.capacity == 512
    _assert_stacks_equal(tb, rb)
    rng = np.random.default_rng(2)
    ch = [rng.standard_normal(n).astype(np.float32) for n in sizes]
    y = tn(tb.matvec(tb.pad_charges(ch)))
    assert_close(y, rb.matvec(rb.pad_charges(ch)), rtol=1e-5, atol=1e-5)
    for i, n in enumerate(sizes):
        assert_close(y[i, :n], ref_plans[i].matvec(jnp.asarray(ch[i])),
                     rtol=1e-5, atol=1e-5)
        assert not y[i, n:].any()                # dead capacity is zero
    # the port's own build pads alike (its own orderings: C4)
    own = t_api.build_plan_batch(xs, k=SK, bs=16, sb=4, backend="bsr",
                                 device="cpu")
    assert own.capacity == 512
    np.testing.assert_array_equal(own.n_alive, sizes)
    y = tn(own.matvec(own.pad_charges(ch)))
    for i, n in enumerate(sizes):
        assert not y[i, n:].any()


# the compacted member 0's row whose k-th and (k+1)-th neighbours are a
# float32 near-tie (ROADMAP C17)
C17_ROW = 156


def test_lockstep_update_matches_reference(stream_batches):
    rb, tb = stream_batches
    _assert_stacks_equal(tb, rb)
    rng = np.random.default_rng(7)
    kills = [rng.choice(SN, 8, replace=False) for _ in range(SB)]
    arrivals = [_arrivals(8, 100 + i) for i in range(SB)]
    rb2 = rb.update(insert=arrivals, delete=kills)
    tb2 = tb.update(insert=arrivals, delete=kills)
    _assert_stacks_equal(tb2, rb2)
    for ht, hr in zip(tb2.hosts, rb2.hosts):
        np.testing.assert_array_equal(ht.last_inserted_idx,
                                      hr.last_inserted_idx)
    x = rng.standard_normal((SB, tb2.capacity, 2)).astype(np.float32)
    assert_close(tb2.matvec(x), rb2.matvec(jnp.asarray(x), backend="bsr"),
                 rtol=1e-5, atol=1e-5)
    # a second step: member 0 outgrows the shared capacity; its restriped
    # layout shows fill drift, so it compacts (a fresh build in each
    # package: its own ordering, ROADMAP C4), and the others re-pad
    big = _arrivals(96, 300)
    rb3, ids_r = rb2.insert([big, None, None])
    tb3, ids_t = tb2.insert([big, None, None])
    assert tb3.capacity == rb3.capacity > tb2.capacity
    assert tb3.refresh_stats[0].grows == 1
    assert tb3.refresh_stats[0].last_action == "compact"
    _assert_stacks_equal(tb3, rb3, members=[1, 2])
    np.testing.assert_array_equal(ids_t[0], ids_r[0])
    np.testing.assert_array_equal(tb3.hosts[0].compact_map,
                                  rb3.hosts[0].compact_map)
    assert ids_t[1:] == [None, None] == ids_r[1:]
    x = rng.standard_normal((SB, tb3.capacity)).astype(np.float32)
    y = tn(tb3.matvec(x))
    yr = np.asarray(rb3.matvec(jnp.asarray(x), backend="bsr"))
    assert_close(y[1:], yr[1:], rtol=1e-5, atol=1e-5)
    # member 0's fresh kNN breaks one float32 near-tie the other way
    # (ROADMAP C17): one product of the batch differs, by 0.45 (rel 0.26),
    # and every other row of member 0 equals the reference's
    off = np.argwhere(~np.isclose(y, yr, rtol=1e-5, atol=1e-5)).tolist()
    assert off == [[0, C17_ROW]]
    err = abs(float(y[0, C17_ROW]) - float(yr[0, C17_ROW]))
    assert err == pytest.approx(0.45, abs=0.005)
    assert err / abs(float(yr[0, C17_ROW])) == pytest.approx(0.26, abs=0.005)
    assert_close(np.delete(y[0], C17_ROW), np.delete(yr[0], C17_ROW),
                 rtol=1e-5, atol=1e-5)
    h0 = tb3.hosts[0]
    live = int(h0.alive.sum())
    assert h0.alive[:live].all()          # compacted: rows 0..live-1
    assert_knn_near_ties(h0.x[:live], [C17_ROW], SK)
    assert_close(y[0], tb3.member(0).matvec(x[0], backend="csr"),
                 rtol=1e-5, atol=1e-5)


def test_lockstep_update_matches_single_plan_updates(stream_batches):
    _, pb = stream_batches
    rng = np.random.default_rng(8)
    kills = [rng.choice(SN, 8, replace=False) for _ in range(SB)]
    arrivals = [_arrivals(8, 200 + i) for i in range(SB)]
    pb2 = pb.update(insert=arrivals, delete=kills)
    assert (pb2.n_alive == SN).all()
    x = rng.standard_normal(pb2.capacity).astype(np.float32)
    y = pb2.matvec(np.broadcast_to(x, (SB, pb2.capacity)).copy())
    for i in range(SB):
        single = t_api.update_plan(pb.member(i), insert=arrivals[i],
                                   delete=kills[i])
        assert_close(y[i], single.matvec(x), rtol=1e-5, atol=1e-5)
        assert torch.equal(pb2.member(i).bsr.col_idx, single.bsr.col_idx)


def test_batch_update_leaves_the_input_batch_valid(stream_batches):
    """ROADMAP C6: a member's update patches a copy of its tiles, never
    the stacked tensors its view slices, so the input batch's ``matvec``
    is bit-equal before and after ``batch.update``."""
    _, pb = stream_batches
    rng = np.random.default_rng(9)
    x = rng.standard_normal((SB, pb.capacity)).astype(np.float32)
    before = pb.matvec(x).clone()
    vals = pb.data.vals.clone()
    kills = [rng.choice(SN, 6, replace=False) for _ in range(SB)]
    pb2 = pb.delete(kills)                        # tombstone tier
    pb3 = pb2.update(insert=[_arrivals(6, 400 + i) for i in range(SB)])
    assert torch.equal(pb.matvec(x), before)
    assert torch.equal(pb.data.vals, vals)
    assert all(st.last_action == "append" for st in pb3.refresh_stats)
    assert not torch.equal(pb2.matvec(x), before)


def test_update_keeps_spec_and_tuned_when_no_member_escalates(
        stream_batches):
    """The spec, and with it the resolved ``"auto"`` backend, holds while
    no member escalates; a member that grows re-unifies it."""
    _, pb = stream_batches
    rng = np.random.default_rng(8)
    pb2 = pb.delete([rng.choice(SN, 4, replace=False) for _ in range(SB)])
    assert pb2.spec == pb.spec
    assert pb2.resolve_backend("auto") == pb.resolve_backend("auto") == "bsr"
    assert all(st.tombstones == 1 for st in pb2.refresh_stats)
    pb3, _ = pb2.insert([_arrivals(96, 500), None, None])   # grows
    assert pb3.spec != pb2.spec and pb3.capacity > pb2.capacity
    assert pb3.refresh_stats[0].grows == 1
    assert pb3.refresh_stats[1].grows == 0
    with pytest.raises(ValueError, match="insert has 2 entries"):
        pb.update(insert=[None, None])
    with pytest.raises(ValueError, match="leading axis 2 != batch 3"):
        pb.update(delete=np.zeros((2, 3), np.int64))


def test_padding_holes_are_not_compaction_debris():
    """Pow2 padding leaves member 0 mostly holes; a small delete streams
    through the tombstone tier (debris is measured against the live peak,
    not the capacity), while real debris still compacts."""
    sizes = [100, 200, 300]
    xs = [feature_mixture(n, SD, n_clusters=4, seed=s)
          for s, n in enumerate(sizes)]
    pb = t_api.build_plan_batch(xs, k=SK, bs=16, sb=4, backend="bsr",
                                ell_slack=4, device="cpu")
    assert pb.capacity == 512
    rng = np.random.default_rng(13)
    pb2 = pb.delete([rng.choice(n, 5, replace=False) for n in sizes])
    for st in pb2.refresh_stats:
        assert st.compactions == 0 and st.tombstones == 1
    np.testing.assert_array_equal(pb2.n_alive, np.array(sizes) - 5)
    big_kill = rng.choice(np.nonzero(pb2.member(2).alive)[0], 140,
                          replace=False)
    pb3 = pb2.update(delete=[None, None, big_kill])
    assert pb3.refresh_stats[2].compactions == 1
    assert [st.compactions for st in pb3.refresh_stats[:2]] == [0, 0]


def test_batch_compact_is_a_fresh_build_per_member(stream_batches):
    """Each member goes through the compaction tier (a fresh build on its
    survivors); the batch then re-pads to its capacity (a hole spread,
    i.e. a reordering), so the live rows' products equal a fresh build's
    to float32 summation order."""
    _, pb = stream_batches
    rng = np.random.default_rng(11)
    pb2 = pb.delete([rng.choice(SN, 16, replace=False)
                     for _ in range(SB)]).compact()
    assert all(st.compactions == 1 for st in pb2.refresh_stats)
    assert (pb2.n_alive == SN - 16).all() and pb2.capacity == pb.capacity
    x = rng.standard_normal(pb2.capacity).astype(np.float32)
    for i in range(SB):
        m = pb2.member(i)
        live = m.alive
        fresh = t_api.build_plan(m.host.x[live], config=m.config,
                                 device="cpu")
        assert_close(tn(m.matvec(x))[live], fresh.matvec(x[live]),
                     rtol=1e-5, atol=1e-5)


def test_kv_plan_batch_capacity_matches_reference():
    """``kv_plan_batch(capacity=)``: every head over-allocated to the
    given slot count with spread holes. The reference's members carried
    across stack to its exact layout; the port's own batch streams."""
    rng = np.random.default_rng(12)
    k = rng.standard_normal((1, 2, 64, 16)).astype(np.float32)
    rb = ref_ckv.kv_plan_batch(jnp.asarray(k), with_bsr=True, capacity=128)
    tb = t_ckv.kv_plan_batch(torch.from_numpy(k), with_bsr=True,
                             capacity=128)
    assert tb.capacity == rb.capacity == 128
    np.testing.assert_array_equal(tb.n_alive, rb.n_alive)
    tb2 = t_api.PlanBatch.from_plans(
        [stream_plan_from_reference(m) for m in rb.members()])
    _assert_stacks_equal(tb2, rb)
    new_keys = rng.standard_normal((2, 4, 16)).astype(np.float32)
    tb3, ids = tb.insert(list(new_keys))
    assert tb3.capacity == 128 and (tb3.n_alive == 68).all()
    assert all(i.shape == (4,) for i in ids)
    x = rng.standard_normal((2, 128)).astype(np.float32)
    y = tn(tb3.matvec(x, backend="cuda"))
    for i, m in enumerate(tb3.members()):
        r, c, v = m.coo
        dense = np.zeros((128, 128))
        np.add.at(dense, (m.host.pi[r], m.host.pi[c]), v)
        np.testing.assert_allclose(y[i], dense @ x[i], rtol=1e-5, atol=1e-5)
