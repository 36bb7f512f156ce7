"""Kernels B1/B2/B3 of the port against the reference's Pallas kernels.

On this CPU the port's wrappers take their plain versions (the tensors lie
on the CPU) and the reference runs its kernels in interpret mode through
``repro.kernels.ops``. The CUDA kernels themselves are held against the
plain versions on a card by ``chip_smoke.py`` and by the ``requires_cuda``
tests of ``tests/test_torch_cuda.py``.

Tolerance: float32 ``rtol=1e-5`` (``atol=1e-5`` at unit-scale charges) —
the arithmetic is the same, only the summation order differs.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close, ell_masks, random_ell, tn, tt

from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_ref
from repro_torch import api as t_api
from repro_torch import convert as t_convert
from repro_torch.core import blocksparse as t_bs
from repro_torch.data import pipeline as t_pipeline
from repro_torch.kernels import bsr_spmv as t_bsr
from repro_torch.kernels import gamma_score as t_gs
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import ref as t_ref


# -- B1: bsr_spmv_batched ----------------------------------------------------


@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("f", [1, 3, 8])
def test_bsr_spmv_batched_matches_reference(B, f):
    # n_rb = 7 is a multiple of nothing convenient; one padded ELL slot
    bs, n_rb, nbr = 8, 7, 4
    vals, col = random_ell(10 * B + f, B, n_rb, nbr, bs, pad_slots=1)
    xs = np.random.default_rng(f).standard_normal(
        (B, n_rb * bs, f)).astype(np.float32)
    want = ref_ops.bsr_spmv_batched(jnp.asarray(vals), jnp.asarray(col),
                                    jnp.asarray(xs))
    got = t_ops.bsr_spmv_batched(tt(vals), tt(col), tt(xs))
    assert tuple(got.shape) == tuple(want.shape)
    assert_close(got, want)
    # and against the reference's own oracle, member by member
    for b in range(B):
        oracle = ref_ref.bsr_spmv_ref(jnp.asarray(vals[b]),
                                      jnp.asarray(col[b]),
                                      jnp.asarray(xs[b]))
        assert_close(got[b], oracle)


@pytest.mark.parametrize("B", [1, 4])
def test_bsr_spmv_batched_1d_charges(B):
    bs, n_rb, nbr = 16, 5, 3
    vals, col = random_ell(3 + B, B, n_rb, nbr, bs)
    xs = np.random.default_rng(1).standard_normal(
        (B, n_rb * bs)).astype(np.float32)
    want = ref_ops.bsr_spmv_batched(jnp.asarray(vals), jnp.asarray(col),
                                    jnp.asarray(xs))
    got = t_ops.bsr_spmv_batched(tt(vals), tt(col), tt(xs))
    assert tuple(got.shape) == (B, n_rb * bs)
    assert_close(got, want)


@pytest.mark.parametrize("f", [1, 3])
def test_bsr_spmv_batched_capacity_padded_shape_key(f):
    """Charges shorter than the plan's column range: ``shape_key`` names
    the full column-block count, the output is sliced to the charges."""
    bs, n_rb, nbr, B = 8, 6, 3, 2
    n = n_rb * bs - 5                      # live charge length < capacity
    vals, col = random_ell(21, B, n_rb, nbr, bs, pad_slots=1,
                           dead_rows=(n_rb - 1,))
    # tiles of the last (dead) column block must not be referenced by live
    # rows beyond the charge length: keep columns inside the live range
    col = np.minimum(col, n_rb - 2).astype(np.int32)
    xs = np.random.default_rng(2).standard_normal((B, n, f)).astype(
        np.float32)
    key = (n_rb * bs, bs, 8, n_rb, n_rb, nbr)
    want = ref_ops.bsr_spmv_batched(jnp.asarray(vals), jnp.asarray(col),
                                    jnp.asarray(xs), shape_key=key)
    got = t_ops.bsr_spmv_batched(tt(vals), tt(col), tt(xs), shape_key=key)
    assert tuple(got.shape) == (B, n, f)
    assert_close(got, want)


def test_bsr_spmv_batched_dead_rows_exactly_zero():
    bs, n_rb, nbr, B = 8, 7, 4, 3
    dead = (2, 6)
    vals, col = random_ell(5, B, n_rb, nbr, bs, dead_rows=dead)
    xs = np.random.default_rng(3).standard_normal(
        (B, n_rb * bs, 3)).astype(np.float32)
    got = tn(t_ops.bsr_spmv_batched(tt(vals), tt(col), tt(xs)))
    for r in dead:
        assert (got[:, r * bs:(r + 1) * bs] == 0.0).all()
    assert np.abs(got).max() > 0


def test_bsr_spmv_batched_wrapper_rejects_bad_input():
    vals, col = random_ell(0, 1, 3, 2, 8)
    xs = np.zeros((1, 24, 1), np.float32)
    with pytest.raises(TypeError, match="float32"):
        t_bsr.bsr_spmv_batched(tt(vals).double(), tt(col), tt(xs))
    with pytest.raises(TypeError, match="int32"):
        t_bsr.bsr_spmv_batched(tt(vals), tt(col).long(), tt(xs))
    bad = col.copy()
    bad[0, 0, 0] = 3                       # only 3 column blocks: 0..2
    with pytest.raises(ValueError, match="col_idx range"):
        t_bsr.bsr_spmv_batched(tt(vals), tt(bad), tt(xs))
    with pytest.raises(ValueError, match="whole number"):
        t_bsr.bsr_spmv_batched(tt(vals), tt(col), tt(xs)[:, :20])


# -- B1/B2 over the kept slots (nbr_mask) ------------------------------------


def _port_bsr(source):
    """A BSR made by one of the port's storage writers, on the CPU, with
    its own mask: ``build_bsr`` with ELL slack, ``patch_bsr`` (row blocks
    re-patched with fewer tiles, one left with none) or ``append_rows``
    (new empty row blocks and spare slots)."""
    n, bs = 150, 8
    rng = np.random.default_rng(11)
    rows = rng.integers(0, n, 900)
    cols = np.clip(rows + rng.integers(-40, 41, 900), 0, n - 1)
    vals = rng.standard_normal(900).astype(np.float32)
    b = t_bs.build_bsr(rows, cols, vals, n, bs=bs, sb=4, slack=2,
                       device="cpu")
    if source == "patch":
        touched = np.array([2, 5, 6])
        drop = np.isin(rows // bs, touched) & ((rows % 3 != 0)
                                              | (rows // bs == 6))
        b = t_bs.patch_bsr(b, rows[~drop], cols[~drop], vals[~drop],
                           touched)
        assert not b.nbr_mask[6].any()
    elif source == "append":
        b = t_bs.append_rows(b, n + 20, extra_nbr=3)
    assert not b.nbr_mask.all()                 # there is padding to skip
    return b


@pytest.mark.parametrize("source", ["build", "patch", "append"])
@pytest.mark.parametrize("f", [1, 3])
def test_masked_plain_matches_reference_on_port_bsrs(source, f):
    b = _port_bsr(source)
    x = np.random.default_rng(f).standard_normal(
        (b.n_cb * b.bs, f)).astype(np.float32)
    vals, col, mask = tn(b.vals), tn(b.col_idx), tn(b.nbr_mask)
    want = ref_ops.bsr_spmv_batched(jnp.asarray(vals[None]),
                                    jnp.asarray(col[None]),
                                    jnp.asarray(x[None]))
    got = t_bsr.bsr_spmv_batched(b.vals[None], b.col_idx[None], tt(x)[None],
                                 b.nbr_mask[None])
    assert_close(got, want)
    got_ops = t_ops.bsr_spmv_batched(b.vals[None], b.col_idx[None],
                                     tt(x)[None], nbr_mask=b.nbr_mask[None])
    assert_close(got_ops, want)
    want1 = ref_ops.bsr_spmv(jnp.asarray(vals), jnp.asarray(col),
                             jnp.asarray(x))
    assert_close(t_bsr.bsr_spmv(b.vals, b.col_idx, tt(x), b.nbr_mask),
                 want1)
    assert_close(t_ops.bsr_spmv(b.vals, b.col_idx, tt(x),
                                nbr_mask=b.nbr_mask), want1)
    # and the plan's cuda backend (plain here), which passes the mask
    plan = t_api.InteractionPlan.from_bsr(b)
    xv = x[:b.n]
    assert_close(plan.matvec(xv, backend="cuda"),
                 plan.matvec(xv, backend="bsr"))
    assert mask.sum() < mask.size


@pytest.mark.parametrize("kind", ["prefix", "holes", "none", "all"])
@pytest.mark.parametrize("f", [1, 4])
def test_masked_plain_matches_reference_with_zeroed_tiles(kind, f):
    """Whatever the masked tiles hold, the masked plain versions equal the
    reference summing every slot with those tiles zeroed."""
    B, n_rb, nbr, bs = 2, 6, 5, 8
    vals, col = random_ell(40 + f, B, n_rb, nbr, bs)     # no zero padding
    mask = ell_masks(f, B, n_rb, nbr)[kind]
    zeroed = np.where(mask[..., None, None], vals, 0.0).astype(np.float32)
    xs = np.random.default_rng(9).standard_normal(
        (B, n_rb * bs, f)).astype(np.float32)
    want = ref_ops.bsr_spmv_batched(jnp.asarray(zeroed), jnp.asarray(col),
                                    jnp.asarray(xs))
    got = t_bsr.bsr_spmv_batched(tt(vals), tt(col), tt(xs), tt(mask))
    assert_close(got, want)
    for b in range(B):
        got1 = t_bsr.bsr_spmv(tt(vals[b]), tt(col[b]), tt(xs[b]),
                              tt(mask[b]))
        assert_close(got1, want[b])


def test_masked_plain_ignores_nan_and_stale_columns_under_the_mask():
    """NaN tiles and out-of-range column blocks under a False bit never
    reach the result: it is finite and equal to the result without those
    slots."""
    B, n_rb, nbr, bs = 2, 5, 4, 8
    vals, col = random_ell(7, B, n_rb, nbr, bs, pad_slots=2)
    mask = np.ones((B, n_rb, nbr), bool)
    mask[:, :, nbr - 2:] = False
    xs = np.random.default_rng(3).standard_normal(
        (B, n_rb * bs, 2)).astype(np.float32)
    clean = t_bsr.bsr_spmv_batched(tt(vals), tt(col), tt(xs))
    poisoned = vals.copy()
    poisoned[:, :, nbr - 2:] = np.nan
    stale = col.copy()
    stale[:, :, nbr - 1] = n_rb + 7              # outside the charges
    got = t_bsr.bsr_spmv_batched(tt(poisoned), tt(stale), tt(xs), tt(mask))
    assert np.isfinite(tn(got)).all()
    np.testing.assert_array_equal(tn(got), tn(clean))
    got1 = t_bsr.bsr_spmv(tt(poisoned[0]), tt(stale[0]), tt(xs[0]),
                          tt(mask[0]))
    assert np.isfinite(tn(got1)).all()
    assert_close(got1, clean[0])


def test_masked_plain_row_block_without_kept_slot_is_exact_zero():
    B, n_rb, nbr, bs = 2, 4, 3, 16
    vals, col = random_ell(5, B, n_rb, nbr, bs)          # nonzero tiles
    mask = np.ones((B, n_rb, nbr), bool)
    mask[0, 1] = False
    mask[1, 3] = False
    xs = np.random.default_rng(4).standard_normal(
        (B, n_rb * bs, 3)).astype(np.float32)
    got = tn(t_bsr.bsr_spmv_batched(tt(vals), tt(col), tt(xs), tt(mask)))
    assert (got[0, bs:2 * bs] == 0.0).all()
    assert (got[1, 3 * bs:] == 0.0).all()
    assert np.abs(got[0, :bs]).max() > 0
    got1 = tn(t_bsr.bsr_spmv(tt(vals[0]), tt(col[0]), tt(xs[0]),
                             tt(mask[0])))
    assert (got1[bs:2 * bs] == 0.0).all()


def test_masked_wrapper_rejects_bad_masks_and_checks_kept_columns():
    vals, col = random_ell(0, 1, 3, 2, 8)
    xs = np.zeros((1, 24, 1), np.float32)
    mask = np.ones((1, 3, 2), bool)
    with pytest.raises(ValueError, match="nbr_mask"):
        t_bsr.bsr_spmv_batched(tt(vals), tt(col), tt(xs), tt(mask[:, :2]))
    with pytest.raises(TypeError, match="bool"):
        t_bsr.bsr_spmv_batched(tt(vals), tt(col), tt(xs),
                               tt(mask.astype(np.uint8)))
    with pytest.raises(ValueError, match="nbr_mask"):
        t_bsr.bsr_spmv(tt(vals[0]), tt(col[0]), tt(xs[0]), tt(mask))
    bad = col.copy()
    bad[0, 1, 1] = 3                       # only 3 column blocks: 0..2
    with pytest.raises(ValueError, match="col_idx range"):
        t_bsr.bsr_spmv_batched(tt(vals), tt(bad), tt(xs), tt(mask))
    with pytest.raises(ValueError, match="col_idx range"):
        t_bsr.bsr_spmv(tt(vals[0]), tt(bad[0]), tt(xs[0]), tt(mask[0]))
    mask[0, 1, 1] = False                  # the stale slot is not kept
    y = t_bsr.bsr_spmv_batched(tt(vals), tt(bad), tt(xs), tt(mask))
    assert tuple(y.shape) == (1, 24, 1)


def test_bsr_from_arrays_rejects_nonzero_tiles_under_false_bits():
    """The plan path launches without a per-call check, so the arrays a
    plan is made of are checked where they cross over: column blocks in
    range, and zero tiles wherever the mask is False."""
    vals, col = random_ell(3, 1, 4, 3, 8, pad_slots=1)
    vals, col = vals[0], col[0]
    mask = np.ones((4, 3), bool)
    mask[:, 2] = False
    b = t_convert.bsr_from_arrays(8, 4, 32, col, mask, vals, device="cpu")
    assert tuple(b.vals.shape) == (4, 3, 8, 8)
    for poison in (1e-3, np.nan):
        bad = vals.copy()
        bad[1, 2, 0, 0] = poison
        with pytest.raises(ValueError, match="not zero"):
            t_convert.bsr_from_arrays(8, 4, 32, col, mask, bad, device="cpu")
    out = col.copy()
    out[3, 0] = 4
    with pytest.raises(ValueError, match="column blocks"):
        t_convert.bsr_from_arrays(8, 4, 32, out, mask, vals, device="cpu")


# -- B2: bsr_spmv ------------------------------------------------------------


@pytest.mark.parametrize("f", [1, 3, 8])
@pytest.mark.parametrize("bs", [8, 16])
def test_bsr_spmv_matches_reference(f, bs):
    n_rb, nbr = 5, 3
    vals, col = random_ell(bs + f, 1, n_rb, nbr, bs, pad_slots=1)
    vals, col = vals[0], col[0]
    n = n_rb * bs - 3                      # wrapper pads to whole blocks
    x = np.random.default_rng(f).standard_normal((n, f)).astype(np.float32)
    want = ref_ops.bsr_spmv(jnp.asarray(vals), jnp.asarray(col),
                            jnp.asarray(x), n)
    got = t_ops.bsr_spmv(tt(vals), tt(col), tt(x), n)
    assert tuple(got.shape) == (n, f)
    assert_close(got, want)
    xp = np.pad(x, ((0, n_rb * bs - n), (0, 0)))
    oracle = ref_ref.bsr_spmv_ref(jnp.asarray(vals), jnp.asarray(col),
                                  jnp.asarray(xp))
    assert_close(t_ref.bsr_spmv_ref(tt(vals), tt(col), tt(xp)), oracle)
    assert_close(got, np.asarray(oracle)[:n])


def test_bsr_spmv_1d_and_rectangular():
    bs, n_rb, n_cb, nbr = 8, 4, 9, 3
    vals, col = random_ell(9, 1, n_rb, nbr, bs, n_cb=n_cb)
    x = np.random.default_rng(4).standard_normal(
        (n_cb * bs, 2)).astype(np.float32)
    want = ref_ref.bsr_spmv_ref(jnp.asarray(vals[0]), jnp.asarray(col[0]),
                                jnp.asarray(x))
    got = t_bsr.bsr_spmv(tt(vals[0]), tt(col[0]), tt(x))
    assert tuple(got.shape) == (n_rb * bs, 2)
    assert_close(got, want)
    sq_vals, sq_col = random_ell(11, 1, 4, 2, 8)
    x1 = np.random.default_rng(5).standard_normal(32).astype(np.float32)
    want1 = ref_ops.bsr_spmv(jnp.asarray(sq_vals[0]), jnp.asarray(sq_col[0]),
                             jnp.asarray(x1))
    got1 = t_ops.bsr_spmv(tt(sq_vals[0]), tt(sq_col[0]), tt(x1))
    assert tuple(got1.shape) == (32,)
    assert_close(got1, want1)


# -- B3: gamma_pairs / gamma_exact -------------------------------------------


def _pattern(seed, nnz, n):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, n, nnz).astype(np.int32),
            rng.integers(0, n, nnz).astype(np.int32))


@pytest.mark.parametrize("nnz,bn", [(700, 64), (512, 128), (300, 256)])
def test_gamma_exact_matches_reference(nnz, bn):
    rows, cols = _pattern(nnz, nnz, 200)
    want = ref_ops.gamma_exact(jnp.asarray(rows), jnp.asarray(cols), 6.0, bn)
    got = t_ops.gamma_exact(rows, cols, 6.0, bn, device="cpu")
    assert_close(got, want)
    co = np.stack([rows, cols], 1).astype(np.float32)
    oracle = ref_ref.gamma_pairs_ref(jnp.asarray(co), 6.0) / (6.0 * nnz)
    assert_close(got, oracle)


def test_gamma_exact_weighted_matches_reference():
    rows, cols = _pattern(7, 500, 150)
    w = (np.random.default_rng(8).random(500) > 0.3).astype(np.float32)
    want = ref_ops.gamma_exact(jnp.asarray(rows), jnp.asarray(cols), 5.0, 64,
                               weights=jnp.asarray(w))
    got = t_ops.gamma_exact(rows, cols, 5.0, 64, weights=w, device="cpu")
    assert_close(got, want)
    # zero-weight entries are the same as leaving the entries out
    keep = w > 0
    live = t_ops.gamma_exact(rows[keep], cols[keep], 5.0, 64, device="cpu")
    assert_close(got, live)


@pytest.mark.parametrize("symmetric", [False, True])
def test_gamma_pairs_symmetric_schedule_and_padding(symmetric):
    """The lower-triangle schedule gives the full sum, and zero-weight
    padding rows are inert wherever their coordinates lie."""
    rows, cols = _pattern(3, 320, 90)
    co = np.stack([rows, cols], 1).astype(np.float32)
    full = ref_ref.gamma_pairs_ref(jnp.asarray(co), 4.0)
    got = t_gs.gamma_pairs(tt(co), 4.0, 64, symmetric=symmetric)
    assert_close(got, full)
    pad = np.full((64, 2), 17.0, np.float32)     # in the thick of the data
    co_p = np.concatenate([co, pad])
    w_p = np.concatenate([np.ones(320, np.float32), np.zeros(64, np.float32)])
    got_p = t_gs.gamma_pairs(tt(co_p), 4.0, 64, weights=tt(w_p),
                             symmetric=symmetric)
    assert_close(got_p, full)
    from repro.kernels import gamma_score as ref_gs
    want_p = ref_gs.gamma_pairs(jnp.asarray(co_p), 4.0, 64,
                                weights=jnp.asarray(w_p),
                                symmetric=symmetric, interpret=True)
    assert_close(got_p, want_p)


def _gamma_exp2_emulated(coords, sigma, bn, weights):
    """float32 emulation of B3's arithmetic (``csrc/gamma_pairs.cu``):
    coordinates prescaled by ``exp2_scale(sigma)``, a term
    ``w_q 2^-(dx'^2 + dy'^2)``, each p row summed over its q tile, the rows
    weighted and summed per tile pair, the symmetric schedule's partials
    (off-diagonal tiles twice) added in double."""
    c = coords * np.float32(t_gs.exp2_scale(sigma))
    nb = c.shape[0] // bn
    total = 0.0
    for i in range(nb):
        p, wp = c[i * bn:(i + 1) * bn], weights[i * bn:(i + 1) * bn]
        for j in range(i + 1):
            q, wq = c[j * bn:(j + 1) * bn], weights[j * bn:(j + 1) * bn]
            dx = p[:, None, 0] - q[None, :, 0]
            dy = p[:, None, 1] - q[None, :, 1]
            acc = (wq[None, :] * torch.exp2(-(dx * dx) - dy * dy)).sum(1)
            total += (2.0 if j < i else 1.0) * float((wp * acc).sum())
    return total


def _phase4_windows():
    """Windows of 1024 nonzero coordinates of the ordered pattern that
    ``chip_smoke.py``'s phase 4 scores (the paper's Table 1 size: n = 4096,
    k = 30, coordinates up to 4096), plus the random coordinates of its
    phase 2."""
    plan = t_api.build_plan(t_pipeline.sift_like(4096, seed=0), k=30,
                            with_bsr=False, sigma=15.0, device="cpu")
    r, c, _ = plan.coo
    co = np.stack([r, c], 1).astype(np.float32)
    rng = np.random.default_rng(0)
    return {f"ordered@{o}": co[o:o + 1024] for o in (0, 60000, len(co) - 1024)
            } | {"random": rng.integers(0, 4096, (1024, 2)).astype(
                np.float32)}


@pytest.mark.parametrize("sigma", [15.0, 0.1])
def test_b3_prescaled_exp2_term_stays_within_the_kernel_bound(sigma):
    """The kernel's term over prescaled coordinates stays within
    ``2e-5 x |plain|`` (chip_smoke.py's kernel-vs-plain bound) of
    ``gamma_pairs_plain`` at the phase-4 pattern's scale: sigma 15 as
    there, and sigma 0.1, where every term between distinct coordinates
    underflows (the kernel flushes them to zero, the plain version keeps
    float32 denormals)."""
    for name, co in _phase4_windows().items():
        w = np.ones(len(co), np.float32)
        w[::10] = 0.0                          # zero-weight entries: inert
        plain = float(t_gs.gamma_pairs_plain(tt(co), sigma, 256,
                                             weights=tt(w), symmetric=True))
        emu = _gamma_exp2_emulated(tt(co), sigma, 256, tt(w))
        assert abs(emu - plain) <= 2e-5 * abs(plain), (name, emu, plain)


def test_gamma_pairs_wrapper_rejects_bad_input():
    co = torch.zeros(100, 2)
    with pytest.raises(ValueError, match="multiple of bn"):
        t_gs.gamma_pairs(co, 4.0, 64)
    with pytest.raises(ValueError, match="sigma"):
        t_gs.gamma_pairs(torch.zeros(64, 2), 0.0, 64)
    with pytest.raises(TypeError, match="float32"):
        t_gs.gamma_pairs(torch.zeros(64, 2, dtype=torch.float64), 4.0, 64)


# -- launch counters and the CPU rule ----------------------------------------


def test_cpu_tensors_take_plain_versions_and_count_no_launch():
    before = (t_bsr.bsr_spmv_batched.launches, t_bsr.bsr_spmv.launches,
              t_gs.gamma_pairs.launches)
    vals, col = random_ell(1, 2, 3, 2, 8)
    xs = np.ones((2, 24, 2), np.float32)
    t_bsr.bsr_spmv_batched(tt(vals), tt(col), tt(xs))
    t_bsr.bsr_spmv(tt(vals[0]), tt(col[0]), tt(xs[0]))
    t_gs.gamma_pairs(torch.zeros(64, 2), 3.0, 64)
    assert before == (t_bsr.bsr_spmv_batched.launches,
                      t_bsr.bsr_spmv.launches, t_gs.gamma_pairs.launches)
