"""Storage (``core/blocksparse.py``) and the plain SpMV paths
(``core/interact.py``, ``core/registry.py``) of the port against the
reference, on identical numpy inputs.

Integer artifacts of the layout (``col_idx``, ``nbr_mask``, ``max_nbr``)
and ``fill`` must be exactly equal; tile values are sums of the same
float32 edge values (exact unless duplicates are summed in another order:
``rtol=1e-6``); products are float32 ``rtol=1e-5``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close, random_ell, tn, tt

from repro.core import blocksparse as ref_bs
from repro.core import interact as ref_it
from repro_torch.core import blocksparse as t_bs
from repro_torch.core import interact as t_it
from repro_torch.core import registry as t_reg


def _coo(seed, n, nnz, dup=0):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n, nnz)
    cols = rng.integers(0, n, nnz)
    if dup:
        rows = np.concatenate([rows, rows[:dup]])
        cols = np.concatenate([cols, cols[:dup]])
    vals = rng.standard_normal(len(rows)).astype(np.float32)
    return rows, cols, vals


def _assert_same_bsr(got, want):
    assert (got.bs, got.sb, got.n, got.n_rb, got.n_cb, got.max_nbr) == \
        (want.bs, want.sb, want.n, want.n_rb, want.n_cb, want.max_nbr)
    assert got.col_idx.dtype == torch.int32
    assert got.nbr_mask.dtype == torch.bool
    np.testing.assert_array_equal(tn(got.col_idx), np.asarray(want.col_idx))
    np.testing.assert_array_equal(tn(got.nbr_mask), np.asarray(want.nbr_mask))
    np.testing.assert_allclose(tn(got.vals), np.asarray(want.vals),
                               rtol=1e-6, atol=0)
    assert got.fill == want.fill


@pytest.mark.parametrize("n,bs,sb", [(100, 8, 2), (250, 16, 4), (64, 8, 8)])
def test_build_bsr_layout_exactly_equal(n, bs, sb):
    rows, cols, vals = _coo(n, n, 6 * n)
    want = ref_bs.build_bsr(rows, cols, vals, n, bs=bs, sb=sb)
    got = t_bs.build_bsr(rows, cols, vals, n, bs=bs, sb=sb, device="cpu")
    _assert_same_bsr(got, want)
    np.testing.assert_allclose(got.to_dense(), want.to_dense(), rtol=1e-6)
    np.testing.assert_array_equal(got.rowblock_cols(1, 3),
                                  want.rowblock_cols(1, 3))


def test_build_bsr_sums_duplicates_and_defaults_to_ones():
    n = 90
    rows, cols, vals = _coo(1, n, 300, dup=40)
    want = ref_bs.build_bsr(rows, cols, vals, n, bs=8, sb=2)
    got = t_bs.build_bsr(rows, cols, vals, n, bs=8, sb=2, device="cpu")
    _assert_same_bsr(got, want)
    dense = np.zeros((n, n), np.float32)
    np.add.at(dense, (rows, cols), vals)
    np.testing.assert_allclose(got.to_dense(), dense, rtol=1e-5, atol=1e-6)
    ones = t_bs.build_bsr(rows, cols, None, n, bs=8, sb=2, device="cpu")
    _assert_same_bsr(ones, ref_bs.build_bsr(rows, cols, None, n, bs=8, sb=2))


def test_build_bsr_slack_and_max_nbr():
    n = 120
    rows, cols, vals = _coo(2, n, 500)
    base = t_bs.build_bsr(rows, cols, vals, n, bs=8, sb=4, device="cpu")
    want = ref_bs.build_bsr(rows, cols, vals, n, bs=8, sb=4, slack=3)
    got = t_bs.build_bsr(rows, cols, vals, n, bs=8, sb=4, slack=3,
                         device="cpu")
    _assert_same_bsr(got, want)
    assert got.max_nbr == base.max_nbr + 3
    pinned = t_bs.build_bsr(rows, cols, vals, n, bs=8, sb=4,
                            max_nbr=base.max_nbr + 1, slack=5, device="cpu")
    assert pinned.max_nbr == base.max_nbr + 1      # max_nbr wins over slack
    with pytest.raises(ValueError, match="max_nbr"):
        t_bs.build_bsr(rows, cols, vals, n, bs=8, sb=4,
                       max_nbr=base.max_nbr - 1, device="cpu")
    with pytest.raises(ValueError, match="max_nbr"):
        ref_bs.build_bsr(rows, cols, vals, n, bs=8, sb=4,
                         max_nbr=base.max_nbr - 1)


def test_build_bsr_empty_pattern():
    e = np.empty(0, np.int64)
    want = ref_bs.build_bsr(e, e, None, 40, bs=8, sb=2)
    got = t_bs.build_bsr(e, e, None, 40, bs=8, sb=2, device="cpu")
    _assert_same_bsr(got, want)
    assert not tn(got.vals).any()


@pytest.mark.parametrize("banded", [False, True])
def test_random_bsr_identical_from_seed(banded):
    want = ref_bs.random_bsr(7, 200, 8, 5, sb=4, banded=banded)
    got = t_bs.random_bsr(7, 200, 8, 5, sb=4, banded=banded, device="cpu")
    assert (got.n_rb, got.n_cb, got.max_nbr, got.fill, got.sb) == \
        (want.n_rb, want.n_cb, want.max_nbr, want.fill, want.sb)
    np.testing.assert_array_equal(tn(got.col_idx), np.asarray(want.col_idx))
    np.testing.assert_array_equal(tn(got.vals), np.asarray(want.vals))
    assert tn(got.nbr_mask).all()


# -- plain SpMV paths --------------------------------------------------------


@pytest.mark.parametrize("ndim", [1, 2])
def test_spmv_csr_bsr_bsr_ml_match_reference(ndim):
    n, bs, sb = 203, 8, 4                   # n_rb = 26: not a multiple of sb
    rows, cols, vals = _coo(3, n, 1500)
    rb = ref_bs.build_bsr(rows, cols, vals, n, bs=bs, sb=sb)
    tb = t_bs.build_bsr(rows, cols, vals, n, bs=bs, sb=sb, device="cpu")
    shape = (n,) if ndim == 1 else (n, 3)
    x = np.random.default_rng(4).standard_normal(shape).astype(np.float32)
    xj, xt = jnp.asarray(x), tt(x)

    want = ref_it.spmv_csr(jnp.asarray(vals), jnp.asarray(rows),
                           jnp.asarray(cols), xj, n)
    got = t_it.spmv_csr(tt(vals), tt(rows), tt(cols), xt, n)
    assert_close(got, want, atol=1e-4)      # scatter order differs

    want = ref_it.spmv_bsr(rb.vals, rb.col_idx, xj, n)
    got = t_it.spmv_bsr(tb.vals, tb.col_idx, xt, n)
    assert tuple(got.shape) == shape
    assert_close(got, want)

    want = ref_it.spmv_bsr_ml(rb.vals, rb.col_idx, xj, n, sb)
    got = t_it.spmv_bsr_ml(tb.vals, tb.col_idx, xt, n, sb)
    assert tuple(got.shape) == shape
    assert_close(got, want)

    dense = tb.to_dense() @ x
    assert_close(got, dense, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("f", [None, 1, 5])
def test_batched_paths_match_reference(f):
    B, n_rb, nbr, bs, sb = 3, 7, 4, 8, 4
    vals, col = random_ell(17, B, n_rb, nbr, bs, pad_slots=1)
    n = n_rb * bs - 3
    shape = (B, n) if f is None else (B, n, f)
    xs = np.random.default_rng(5).standard_normal(shape).astype(np.float32)
    vj, cj, xj = jnp.asarray(vals), jnp.asarray(col), jnp.asarray(xs)
    want = ref_it.spmv_bsr_batched(vj, cj, xj)
    got = t_it.spmv_bsr_batched(tt(vals), tt(col), tt(xs))
    assert tuple(got.shape) == shape
    assert_close(got, want)
    want = ref_it.spmv_bsr_ml_batched(vj, cj, xj, sb)
    got = t_it.spmv_bsr_ml_batched(tt(vals), tt(col), tt(xs), sb)
    assert tuple(got.shape) == shape
    assert_close(got, want)


def test_flat_gather_and_tile_contraction_match_reference():
    B, n_rb, nbr, bs = 2, 5, 3, 8
    vals, col = random_ell(19, B, n_rb, nbr, bs)
    for f in (1, 4):
        xs = np.random.default_rng(f).standard_normal(
            (B, n_rb * bs - 2, f)).astype(np.float32)
        seg_w = ref_it._flat_gather_segments(jnp.asarray(xs),
                                             jnp.asarray(col), bs)
        seg_g = t_it._flat_gather_segments(tt(xs), tt(col), bs)
        np.testing.assert_array_equal(tn(seg_g), np.asarray(seg_w))
        want = ref_it._tiles_times_segments(jnp.asarray(vals), seg_w)
        got = t_it._tiles_times_segments(tt(vals), seg_g)
        assert_close(got, want)


# -- registry ----------------------------------------------------------------


def test_registry_names_duplicates_and_did_you_mean():
    assert t_reg.backend_names() == ("bsr", "bsr_ml", "csr", "cuda", "dist")
    for name in ("bsr", "bsr_ml", "cuda"):
        assert t_reg.get_batched_backend(name) is not None
    assert t_reg.get_batched_backend("csr") is None
    with pytest.raises(ValueError, match="did you mean 'bsr_ml'"):
        t_reg.get_backend("bsr_m")
    with pytest.raises(ValueError, match="already registered"):
        t_reg.register_backend("bsr", lambda plan, x: x)
    with pytest.raises(ValueError, match="already registered"):
        t_reg.register_batched_backend("bsr", lambda s, d, x: x)
    same = t_reg.get_backend("bsr")
    assert t_reg.register_backend("bsr", same) is same     # no-op

    def mine(plan, x, **_kw):
        return x

    try:
        t_reg.register_backend("mine_test_only", mine)
        assert "mine_test_only" in t_reg.backend_names()
        t_reg.register_backend("mine_test_only", lambda p, x: x,
                               overwrite=True)
    finally:
        t_reg._BACKENDS.pop("mine_test_only", None)
    assert t_reg.preconditioner_names() == ("block_jacobi", "identity",
                                            "jacobi")
