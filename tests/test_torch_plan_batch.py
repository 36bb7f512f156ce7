"""Batched plans: ``PlanBatch`` / ``build_plan_batch`` against the reference.

Reference members cross over as numpy arrays (``convert``) and are stacked
by both packages: the stacked ``pi``/``inv``/``col_idx``/``nbr_mask`` must be
exactly equal, tiles equal, and the batched ``matvec``/``apply`` equal to
float32 ``rtol 1e-5`` on every batched backend. The port's own
``build_plan_batch`` (other random draws in its embedding, so other
permutations) is held to invariants: each member's matvec equals its own
dense ``A @ x``.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import TOL, assert_close, plan_from_reference, tn

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
    with pytest.raises(NotImplementedError, match="A6b"):
        pb.update(insert=None)
    with pytest.raises(NotImplementedError, match="A8"):
        pb.solve(None)


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
