"""The port's CUDA kernels against their plain versions, on a card.

These tests need an NVIDIA GPU and ``nvcc`` and skip elsewhere (a CUDA
kernel has no CPU mode). They import neither JAX nor the reference
package, so they run on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m requires_cuda tests/test_torch_cuda.py

Tolerance: the kernel sums in another order than the plain version, so
float32 ``rtol=1e-4, atol=1e-4`` at these magnitudes (|y| up to ~50); the
masked SpMV cases and the attention kernels ``2e-5 x max|plain|`` in
float32 (about 20 ulp of the largest value), plus one bf16 spacing of
each element in bf16.
"""
import numpy as np
import pytest
import torch

from _torch_parity import (assert_close, cuda_device, ell_masks,  # noqa: F401
                           random_ell, tt)

from repro_torch import api as t_api
from repro_torch.data.pipeline import feature_mixture
from repro_torch.core import clusterkv as t_ckv
from repro_torch.kernels import block_attention as t_ba
from repro_torch.kernels import bsr_spmv as t_bsr
from repro_torch.kernels import decode_attend as t_da
from repro_torch.kernels import gamma_score as t_gs
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import tsne_force as t_tf
from repro_torch.models import attention as t_attn
from repro_torch.models import transformer as t_model


def _pattern(seed, nnz, n):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, n, nnz).astype(np.int32),
            rng.integers(0, n, nnz).astype(np.int32))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("bs,f,B", [(32, 1, 1), (32, 8, 2), (16, 3, 4),
                                    (8, 19, 1)])
def test_cuda_bsr_spmv_kernels_match_plain(cuda_device, bs, f, B):
    vals, col = random_ell(bs + f, B, 37, 5, bs, pad_slots=1, dead_rows=(4,))
    xs = np.random.default_rng(0).standard_normal(
        (B, 37 * bs, f)).astype(np.float32)
    v, c, x = (tt(a).to(cuda_device) for a in (vals, col, xs))
    n0 = t_bsr.bsr_spmv_batched.launches
    got = t_bsr.bsr_spmv_batched(v, c, x)
    torch.cuda.synchronize()
    assert t_bsr.bsr_spmv_batched.launches == n0 + 1
    want = t_bsr.bsr_spmv_batched_plain(v, c, x)
    # summation order differs between kernel and plain version
    assert_close(got, want, rtol=1e-4, atol=1e-4)
    assert (got[:, 4 * bs:5 * bs] == 0).all()
    got1 = t_bsr.bsr_spmv(v[0], c[0], x[0])
    assert_close(got1, t_bsr.bsr_spmv_plain(v[0], c[0], x[0]),
                 rtol=1e-4, atol=1e-4)


def _assert_within_scale(got, want, rel=2e-5):
    """max-abs error within ``rel x max|want|``; both finite."""
    assert torch.isfinite(got).all() and torch.isfinite(want).all()
    scale = float(want.abs().max()) if want.numel() else 0.0
    err = float((got - want).abs().max()) if want.numel() else 0.0
    assert err <= rel * max(scale, 1e-30), (err, scale)


def _masked_cases(seed, B, n_rb, nbr, bs, n_cb, device):
    """Tiles nonzero in every slot, and (name, vals, mask) for each mask
    kind of ``ell_masks`` plus NaN tiles under a prefix mask."""
    vals, col = random_ell(seed, B, n_rb, nbr, bs, n_cb=n_cb)
    v = tt(vals).to(device)
    masks = {k: tt(m).to(device)
             for k, m in ell_masks(seed, B, n_rb, nbr).items()}
    nan = torch.where(masks["prefix"][..., None, None], v,
                      torch.full_like(v, float("nan")))
    cases = [(k, v, m) for k, m in masks.items()]
    cases.append(("nan", nan, masks["prefix"]))
    return tt(col).to(device), cases


@pytest.mark.requires_cuda
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("f", [1, 2, 7, 8, 9, 16, 33])
@pytest.mark.parametrize("bs", [4, 8, 16, 32, 64])
def test_cuda_bsr_spmv_masked_kernels_match_plain(cuda_device, bs, f, B):
    """Only kept slots are read: every mask kind (none kept, all kept,
    random prefixes, holes, NaN tiles under the mask) against the masked
    plain versions, bit-identical run to run. nbr = 37 makes the kernel's
    walk over the kept slots cross a 32-slot chunk."""
    n_rb, nbr, n_cb = 19, 37, 40
    c, cases = _masked_cases(bs * 100 + f, B, n_rb, nbr, bs, n_cb,
                             cuda_device)
    x = torch.randn((B, n_cb * bs, f), generator=torch.Generator(
        device=cuda_device).manual_seed(f), device=cuda_device)
    unmasked = t_bsr.bsr_spmv_batched(cases[0][1], c, x)
    for kind, v, m in cases:
        got = t_bsr.bsr_spmv_batched(v, c, x, m)
        again = t_bsr.bsr_spmv_batched(v, c, x, m, indices_checked=True)
        torch.cuda.synchronize()
        want = t_bsr.bsr_spmv_batched_plain(v, c, x, m)
        _assert_within_scale(got, want)
        assert torch.equal(got, again), kind
        if kind == "none":
            assert (got == 0).all()
        if kind == "all":                  # same slots in the same order
            assert torch.equal(got, unmasked)
        got1 = t_bsr.bsr_spmv(v[0], c[0], x[0], m[0])
        torch.cuda.synchronize()
        _assert_within_scale(got1, t_bsr.bsr_spmv_plain(v[0], c[0], x[0],
                                                        m[0]))
        assert torch.equal(got1, got[0]), kind


@pytest.mark.requires_cuda
@pytest.mark.parametrize("bs,f", [(64, 260), (64, 301), (32, 520),
                                  (4, 2049)])
def test_cuda_bsr_spmm_wide_features_match_plain(cuda_device, bs, f):
    """f wider than one block's register tiles is split into feature
    groups (16-byte staging when f % 4 == 0, 4-byte otherwise; over 48 KB
    of shared memory at these widths)."""
    n_rb, nbr, n_cb = 6, 35, 36
    c, cases = _masked_cases(f, 2, n_rb, nbr, bs, n_cb, cuda_device)
    x = torch.randn((2, n_cb * bs, f), device=cuda_device)
    for kind, v, m in cases:
        got = t_bsr.bsr_spmv_batched(v, c, x, m)
        torch.cuda.synchronize()
        _assert_within_scale(got, t_bsr.bsr_spmv_batched_plain(v, c, x, m))


@pytest.mark.requires_cuda
def test_cuda_plan_matvec_issues_no_host_sync(cuda_device):
    """The plan path launches the SpMV kernel without reading anything
    back to the host: ``plan.matvec`` and ``PlanBatch.matvec`` run under
    ``set_sync_debug_mode("error")``."""
    x = feature_mixture(1024, 32, n_clusters=8, seed=1)
    plan = t_api.build_plan(x, k=8)
    batch = t_api.PlanBatch.from_plans(
        [plan, t_api.build_plan(feature_mixture(1024, 32, n_clusters=8,
                                                seed=2), k=8)])
    runs = [(plan, torch.randn(1024, device=cuda_device)),
            (plan, torch.randn(1024, 3, device=cuda_device)),
            (batch, torch.randn(2, batch.capacity, 2, device=cuda_device))]
    for owner, ch in runs:
        want = owner.matvec(ch, backend="bsr")
        owner.matvec(ch)                   # kernels loaded, memory cached
        torch.cuda.synchronize()
        n0 = t_bsr.bsr_spmv_batched.launches
        torch.cuda.set_sync_debug_mode("error")
        try:
            y = owner.matvec(ch)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert t_bsr.bsr_spmv_batched.launches == n0 + 1
        assert_close(y, want, rtol=1e-4, atol=1e-4)


@pytest.mark.requires_cuda
def test_cuda_wrappers_reject_bad_masks(cuda_device):
    vals, col = random_ell(2, 1, 4, 2, 8)
    v, c = tt(vals).to(cuda_device), tt(col).to(cuda_device)
    x = torch.zeros(1, 32, 1, device=cuda_device)
    m = torch.ones(1, 4, 2, dtype=torch.bool, device=cuda_device)
    with pytest.raises(ValueError, match="nbr_mask"):
        t_bsr.bsr_spmv_batched(v, c, x, m[:, :3])
    with pytest.raises(TypeError, match="bool"):
        t_bsr.bsr_spmv_batched(v, c, x, m.to(torch.uint8))
    with pytest.raises(ValueError, match="device"):
        t_bsr.bsr_spmv_batched(v, c, x, m.cpu())
    with pytest.raises(ValueError, match="contiguous"):
        t_bsr.bsr_spmv_batched(v, c, x, torch.ones(
            1, 2, 4, dtype=torch.bool, device=cuda_device).transpose(1, 2))
    bad = c.clone()
    bad[0, 2, 1] = 4                       # only 4 column blocks: 0..3
    with pytest.raises(ValueError, match="col_idx range"):
        t_bsr.bsr_spmv_batched(v, bad, x, m)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("sigma", [7.5, 0.1])
@pytest.mark.parametrize("symmetric", [False, True])
def test_cuda_gamma_pairs_matches_plain_and_is_reproducible(cuda_device,
                                                            symmetric, sigma):
    """sigma 0.1: every term between distinct coordinates underflows (the
    kernel's ex2 flushes it to zero), only coincident ones count."""
    rows, cols = _pattern(5, 2048, 400)
    co = tt(np.stack([rows, cols], 1).astype(np.float32)).to(cuda_device)
    w = (torch.rand(2048, device=cuda_device) > 0.2).float()
    got = t_gs.gamma_pairs(co, sigma, 256, weights=w, symmetric=symmetric)
    again = t_gs.gamma_pairs(co, sigma, 256, weights=w, symmetric=symmetric)
    want = t_gs.gamma_pairs_plain(co, sigma, 256, weights=w,
                                  symmetric=symmetric)
    assert_close(got, want, rtol=1e-5)
    assert got.item() == again.item()      # fixed reduction order


@pytest.mark.requires_cuda
def test_cuda_wrappers_reject_what_the_kernel_does_not_take(cuda_device):
    vals, col = random_ell(2, 1, 4, 2, 12)         # bs = 12: not supported
    v, c = tt(vals).to(cuda_device), tt(col).to(cuda_device)
    x = torch.zeros(1, 48, 1, device=cuda_device)
    with pytest.raises(ValueError, match="supports bs"):
        t_bsr.bsr_spmv_batched(v, c, x)
    vals, col = random_ell(2, 1, 4, 2, 8)
    v, c = tt(vals).to(cuda_device), tt(col).to(cuda_device)
    xt = torch.zeros(1, 3, 32, device=cuda_device).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        t_bsr.bsr_spmv_batched(v, c, xt)
    with pytest.raises(ValueError, match="one device"):
        t_bsr.bsr_spmv_batched(v, c.cpu(), torch.zeros(1, 32, 1,
                                                       device=cuda_device))
    with pytest.raises(ValueError, match="multiple of 32"):
        t_gs.gamma_pairs(torch.zeros(80, 2, device=cuda_device), 2.0, 40)


@pytest.mark.requires_cuda
def test_cuda_plan_defaults_to_the_kernel(cuda_device):
    """device=None lands on the card, ``auto`` resolves to ``cuda`` and the
    matvec goes through the kernel (its launch counter moves)."""
    x = feature_mixture(1024, 32, n_clusters=8, seed=0)
    plan = t_api.build_plan(x, k=8)
    assert plan.device.type == "cuda" and plan.resolve_backend() == "cuda"
    ch = np.random.default_rng(0).standard_normal((1024, 3)).astype(
        np.float32)
    n0 = t_bsr.bsr_spmv_batched.launches
    y = plan.matvec(ch)
    assert t_bsr.bsr_spmv_batched.launches == n0 + 1
    assert_close(y, plan.matvec(ch, backend="bsr"), rtol=1e-4, atol=1e-4)
    assert_close(y, plan.matvec(ch, backend="csr"), rtol=1e-4, atol=1e-4)


def _tsne_inputs(seed, n_rb, nbr, bs, d, n, device):
    vals, col = random_ell(seed, 1, n_rb, nbr, bs, pad_slots=1)
    p = np.abs(vals[0]) / (n_rb * bs)
    rows = np.arange(n_rb)[:, None] * bs + np.arange(bs)[None, :]
    p *= (rows < n)[:, None, :, None]          # ragged last row block
    y = np.random.default_rng(seed).standard_normal((n_rb * bs, d))
    y[n:] = 0.0
    return (tt(p.astype(np.float32)).to(device), tt(col[0]).to(device),
            tt(y.astype(np.float32)).to(device))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("bs", [8, 16, 32, 64])
@pytest.mark.parametrize("d", [1, 2, 3])
def test_cuda_tsne_force_matches_plain_and_is_reproducible(cuda_device, bs,
                                                           d):
    n_rb = 23
    p, c, y = _tsne_inputs(bs + d, n_rb, 6, bs, d, n_rb * bs - 5,
                           cuda_device)
    n0 = t_tf.tsne_force.launches
    got = t_tf.tsne_force(p, c, y)
    again = t_tf.tsne_force(p, c, y)
    torch.cuda.synchronize()
    assert t_tf.tsne_force.launches == n0 + 2
    want = t_tf.tsne_force_plain(p, c, y)
    scale = float(want.abs().max())
    # the kernel sums in another order than the plain version
    assert_close(got, want, rtol=1e-5, atol=2e-5 * scale)
    assert torch.equal(got, again)            # no atomics: bit-reproducible
    assert (got[n_rb * bs - 5:] == 0).all()   # zero P rows: exactly zero


@pytest.mark.requires_cuda
@pytest.mark.parametrize("bs", [8, 16, 32, 64])
@pytest.mark.parametrize("d", [1, 2, 3])
def test_cuda_tsne_force_masked_matches_plain_and_is_reproducible(
        cuda_device, bs, d):
    """Only kept slots are read: every mask kind (none kept, all kept,
    random prefixes, holes, NaN tiles under the mask) against the masked
    plain version, bit-identical run to run. nbr = 37 makes each warp's
    walk over the kept slots cross a 32-slot chunk."""
    n_rb, nbr, n_cb = 13, 37, 40
    vals, col = random_ell(bs * 10 + d, 1, n_rb, nbr, bs, n_cb=n_cb)
    p = tt(np.abs(vals[0]) / (nbr * bs)).to(cuda_device)
    c = tt(col[0]).to(cuda_device)
    y = torch.randn((n_cb * bs, d), generator=torch.Generator(
        device=cuda_device).manual_seed(d), device=cuda_device)
    masks = {k: tt(m[0]).to(cuda_device)
             for k, m in ell_masks(bs + d, 1, n_rb, nbr).items()}
    cases = [(k, p, m) for k, m in masks.items()]
    cases.append(("nan", torch.where(masks["prefix"][..., None, None], p,
                                     torch.full_like(p, float("nan"))),
                  masks["prefix"]))
    unmasked = t_tf.tsne_force(p, c, y)
    for kind, v, m in cases:
        got = t_tf.tsne_force(v, c, y, m)
        again = t_tf.tsne_force(v, c, y, m, indices_checked=True)
        torch.cuda.synchronize()
        _assert_within_scale(got, t_tf.tsne_force_plain(v, c, y, m))
        assert torch.equal(got, again), kind
        if kind == "none":
            assert (got == 0).all()
        if kind == "all":                  # same slots in the same order
            assert torch.equal(got, unmasked)


@pytest.mark.requires_cuda
def test_cuda_plan_tsne_attractive_issues_no_host_sync(cuda_device):
    """The plan path launches the force kernel with the plan's mask and
    without reading anything back to the host; skipping the masked (zero)
    tiles gives the force over every slot bit for bit."""
    x = feature_mixture(1024, 32, n_clusters=8, seed=3, spread=1.0)
    plan = t_api.build_plan(x, k=8, bs=32, sb=4, ell_slack=4)
    b = plan.bsr
    assert not bool(b.nbr_mask.all())
    y = torch.randn(1024, 2, device=cuda_device)
    want = plan.tsne_attractive(y, backend="bsr")
    plan.tsne_attractive(y)                # kernels loaded, memory cached
    torch.cuda.synchronize()
    n0 = t_tf.tsne_force.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        f = plan.tsne_attractive(y)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert t_tf.tsne_force.launches == n0 + 1
    _assert_within_scale(f, want)
    every = t_ops.tsne_force(b.vals, b.col_idx, y, plan.n)
    assert torch.equal(f, every)


@pytest.mark.requires_cuda
def test_cuda_tsne_force_rejects_what_the_kernel_does_not_take(cuda_device):
    p, c, y = _tsne_inputs(0, 4, 2, 8, 2, 32, cuda_device)
    with pytest.raises(ValueError, match=r"d in \(1, 2, 3\)"):
        t_tf.tsne_force(p, c, torch.zeros(32, 4, device=cuda_device))
    vals, col = random_ell(1, 1, 4, 2, 4)          # bs = 4: not supported
    with pytest.raises(ValueError, match="supports bs"):
        t_tf.tsne_force(tt(vals[0]).to(cuda_device),
                        tt(col[0]).to(cuda_device),
                        torch.zeros(16, 2, device=cuda_device))


@pytest.mark.requires_cuda
def test_cuda_plan_tsne_and_refresh_run_through_the_kernels(cuda_device):
    """On a CUDA plan tsne_attractive defaults to the kernel; every refresh
    tier keeps the plan on the card and its products consistent."""
    x = feature_mixture(1024, 32, n_clusters=8, seed=1, spread=1.0)
    plan = t_api.build_plan(x, k=8, bs=32, sb=4, ell_slack=16)
    y = torch.randn(1024, 2, device=cuda_device)
    n0 = t_tf.tsne_force.launches
    f = plan.tsne_attractive(y)
    assert t_tf.tsne_force.launches == n0 + 1
    want = plan.tsne_attractive(y, backend="bsr")
    assert_close(f, want, rtol=1e-5, atol=2e-5 * float(want.abs().max()))
    rng = np.random.default_rng(2)
    x2 = x.copy()
    mv = rng.choice(1024, 30, replace=False)
    x2[mv] = x[(mv + 512) % 1024]
    ch = rng.standard_normal((1024, 3)).astype(np.float32)
    for policy in ("patch", "rebucket", "rebuild"):
        p2 = plan.refresh(x2, policy=policy)
        assert p2.refresh_stats.last_action == policy
        assert p2.device.type == "cuda" and p2.bsr.vals.is_cuda
        assert_close(p2.matvec(ch), p2.matvec(ch, backend="csr"),
                     rtol=1e-4, atol=1e-4)
        plan = p2


def _assert_kernel_close(got, want, dtype):
    """float32: 2e-5 x max|want| (summation order). bf16: both round one
    float32 result to bf16, which may land one bf16 spacing apart, so each
    element may also differ by the bf16 spacing at its own magnitude."""
    assert got.dtype == dtype
    got, want = got.float(), want.float()
    limit = 2e-5 * float(want.abs().max())
    if dtype == torch.bfloat16:
        _, e = torch.frexp(want)
        limit = limit + torch.where(want == 0, 0.0, torch.ldexp(
            torch.ones_like(want), e - 8))
    assert bool(((got - want).abs() <= limit).all())


def _attention_inputs(seed, b, hq, hkv, s, dh, bq, n_sel, device, dtype,
                      dv=None):
    """Cluster-sorted k/v with a permuted position per key, and for every
    query tile ``n_sel`` distinct key tiles (v of width ``dv``, default
    ``dh``)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, s, dh)).astype(np.float32)
    k = rng.standard_normal((b, hkv, s, dh)).astype(np.float32)
    v = rng.standard_normal((b, hkv, s, dv or dh)).astype(np.float32)
    kpos = np.stack([np.stack([rng.permutation(s) for _ in range(hkv)])
                     for _ in range(b)]).astype(np.int32)
    nqb = s // bq
    idx = np.stack([np.stack([np.stack([
        rng.choice(s // bq, n_sel, replace=False) for _ in range(nqb)])
        for _ in range(hkv)]) for _ in range(b)]).astype(np.int32)
    dev = dict(device=device)
    return (tt(q).to(dtype=dtype, **dev), tt(k).to(dtype=dtype, **dev),
            tt(v).to(dtype=dtype, **dev), tt(kpos).to(**dev),
            torch.arange(s, dtype=torch.int32, **dev), tt(idx).to(**dev))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("bq,dh", [(128, 64), (64, 64), (32, 64)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_block_attention_matches_plain(cuda_device, bq, dh, causal,
                                            dtype):
    q, k, v, kpos, qpos, idx = _attention_inputs(
        bq + dh, 2, 14, 2, 4 * bq, dh, bq, 3, cuda_device, dtype)
    n0 = t_ba.block_attention.launches
    got = t_ba.block_attention(q, k, v, kpos, qpos, idx, bq=bq, bk=bq,
                               causal=causal)
    torch.cuda.synchronize()
    assert t_ba.block_attention.launches == n0 + 1
    want = t_ba.block_attention_plain(q, k, v, kpos, qpos, idx, bq=bq,
                                      bk=bq, causal=causal)
    _assert_kernel_close(got, want, dtype)
    # one slice against the flat-softmax oracle
    from repro_torch.kernels.ref import block_attention_ref
    ref0 = block_attention_ref(q[1, 9], k[1, 1], v[1, 1], kpos[1, 1], qpos,
                               idx[1, 1], bq=bq, bk=bq, causal=causal)
    _assert_kernel_close(got[1, 9], ref0, dtype)


def _decode_inputs(seed, b, hkv, g, s, dh, bk, device, dtype, holes):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hkv * g, dh)).astype(np.float32)
    k = rng.standard_normal((b, hkv, s, dh)).astype(np.float32)
    v = rng.standard_normal((b, hkv, s, dh)).astype(np.float32)
    # plan order: whole tiles shuffled, time order kept inside a tile, so
    # only the newest tile or two get the recency boost
    nkb = s // bk
    pos = np.empty((b, hkv, s), np.int64)
    for bi in range(b):
        for hi in range(hkv):
            order = rng.permutation(nkb)
            pos[bi, hi] = (order[:, None] * bk + np.arange(bk)).reshape(-1)
    if holes:
        pos[rng.random(pos.shape) < 0.2] = 2 ** 31 - 1
    dev = dict(device=device)
    kt = tt(k).to(dtype=dtype, **dev)
    cent = t_ckv.block_centroids(kt.float(), bk)
    return (tt(q).to(dtype=dtype, **dev), kt, tt(v).to(dtype=dtype, **dev),
            tt(pos.astype(np.int32)).to(**dev), cent)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("g", [1, 7])
@pytest.mark.parametrize("mode", ["plain", "plan", "plan_self"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_decode_attend_matches_plain(cuda_device, g, mode, dtype):
    b, hkv, s, dh, bk, n_sel = 4, 2, 2048, 64, 128, 6
    q, k, v, pos, cent = _decode_inputs(g, b, hkv, g, s, dh, bk, cuda_device,
                                        dtype, holes=mode != "plain")
    qpos = torch.tensor([1500, 900, 2047, 40], dtype=torch.int32,
                        device=cuda_device)
    plan_mode = mode != "plain"
    has_self = mode == "plan_self"
    ks = torch.randn(b, hkv, dh, device=cuda_device).to(dtype)
    vs = torch.randn(b, hkv, dh, device=cuda_device).to(dtype)
    sel = torch.empty((b, hkv, n_sel), dtype=torch.int32, device=cuda_device)
    fused = t_da.decode_attend_fused
    n0 = (fused.launches, fused.plain_mode_launches, fused.plan_mode_launches)
    got = fused(q, k, v, pos, cent, qpos, ks, vs, n_sel=n_sel, bk=bk,
                plan_mode=plan_mode, has_self=has_self, window=bk,
                sel_out=sel)
    torch.cuda.synchronize()
    assert (fused.launches, fused.plain_mode_launches,
            fused.plan_mode_launches) == (n0[0] + 1, n0[1] + (not plan_mode),
                                          n0[2] + plan_mode)
    want = t_da.decode_attend_plain(q, k, v, pos, cent, qpos, ks, vs,
                                    n_sel=n_sel, bk=bk, plan_mode=plan_mode,
                                    has_self=has_self, window=bk)
    if plan_mode:
        want_sel = t_ckv.plan_select(q, pos, cent, qpos, n_sel=n_sel, bk=bk,
                                     window=bk)
    else:
        want_sel = t_ckv.decode_select(q.float(), cent, n_sel)
    # the same tiles; order may differ between scores equal up to rounding
    assert torch.equal(sel.long().sort(-1).values,
                       want_sel.long().sort(-1).values)
    _assert_kernel_close(got, want, dtype)
    if plan_mode and not has_self:
        # slot 3 (qpos 40) may select nothing live: exact zeros there
        live = (pos[3] <= 40).any()
        if not live:
            assert (got[3] == 0).all()


@pytest.mark.requires_cuda
@pytest.mark.parametrize("causal", [True, False])
def test_cuda_block_attention_f32_head_dim_16_matches_plain(cuda_device,
                                                           causal):
    """The float32 kernel at the reduced model's shape (tiles of 32, head
    dim 16: the service's plan prefill in the tests and the twin example);
    bf16 has no such instance and raises."""
    q, k, v, kpos, qpos, idx = _attention_inputs(
        7, 2, 4, 2, 128, 16, 32, 3, cuda_device, torch.float32)
    n0 = t_ba.block_attention.launches
    got = t_ba.block_attention(q, k, v, kpos, qpos, idx, bq=32, bk=32,
                               causal=causal)
    torch.cuda.synchronize()
    assert t_ba.block_attention.launches == n0 + 1
    want = t_ba.block_attention_plain(q, k, v, kpos, qpos, idx, bq=32,
                                      bk=32, causal=causal)
    _assert_kernel_close(got, want, torch.float32)
    with pytest.raises(ValueError, match="supports"):
        t_ba.block_attention(q.bfloat16(), k.bfloat16(), v.bfloat16(), kpos,
                             qpos, idx, bq=32, bk=32)


@pytest.mark.requires_cuda
def test_cuda_attention_wrappers_reject_what_the_kernels_do_not_take(
        cuda_device):
    q, k, v, kpos, qpos, idx = _attention_inputs(0, 1, 4, 2, 96, 64, 48, 1,
                                                 cuda_device, torch.float32)
    with pytest.raises(ValueError, match="supports"):
        t_ba.block_attention(q, k, v, kpos, qpos, idx, bq=48, bk=48)
    q, k, v, pos, cent = _decode_inputs(0, 1, 2, 2, 256, 64, 128,
                                        cuda_device, torch.float32, False)
    with pytest.raises(ValueError, match="whole 128-tiles"):
        t_da.decode_attend_fused(q, k, v, pos, cent, 10, n_sel=3, bk=128)
    with pytest.raises(TypeError, match="int32"):
        t_da.decode_attend_fused(q, k, v, pos.long(), cent, 10, n_sel=2,
                                 bk=128)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dh,dv", [(128, 128), (96, 64)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_block_attention_wide_heads_match_plain(cuda_device, dh, dv,
                                                     causal, dtype):
    """B6 at the model zoo's head dims, tiles of 128: dh = dv = 128
    (llava-next-34b, mistral-large-123b, llama4-maverick; float32 takes
    half a query tile a block) and MLA's q/k 96 with v 64 (minicpm3-4b)."""
    q, k, v, kpos, qpos, idx = _attention_inputs(
        dh + dv, 2, 14, 2, 640, dh, 128, 3, cuda_device, dtype, dv=dv)
    n0 = t_ba.block_attention.launches
    got = t_ba.block_attention(q, k, v, kpos, qpos, idx, bq=128, bk=128,
                               causal=causal)
    torch.cuda.synchronize()
    assert t_ba.block_attention.launches == n0 + 1
    assert tuple(got.shape) == (2, 14, 640, dv)
    want = t_ba.block_attention_plain(q, k, v, kpos, qpos, idx, bq=128,
                                      bk=128, causal=causal)
    _assert_kernel_close(got, want, dtype)


@pytest.mark.requires_cuda
def test_cuda_block_attention_rejects_unsupported_head_dims(cuda_device):
    """A shape the kernel has no instance for raises on a card; it never
    falls back to the plain version."""
    for dh, dv, bq in ((128, 64, 128), (96, 64, 64), (128, 128, 64),
                       (80, 80, 128)):
        q, k, v, kpos, qpos, idx = _attention_inputs(
            1, 1, 4, 2, 256, dh, bq, 1, cuda_device, torch.bfloat16, dv=dv)
        n0 = t_ba.block_attention.launches
        with pytest.raises(ValueError, match="supports"):
            t_ba.block_attention(q, k, v, kpos, qpos, idx, bq=bq, bk=bq)
        assert t_ba.block_attention.launches == n0


@pytest.mark.requires_cuda
@pytest.mark.parametrize("g", [7, 12])
@pytest.mark.parametrize("mode", ["plain", "plan_self"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_decode_attend_head_dim_128_matches_plain(cuda_device, g, mode,
                                                       dtype):
    """B5 at head dim 128 and the zoo's GQA groups (llava 7, mistral 12):
    the part kernel stages about 144 KB of shared memory at g = 12."""
    b, hkv, s, dh, bk, n_sel = 2, 2, 2048, 128, 128, 6
    q, k, v, pos, cent = _decode_inputs(g + 1, b, hkv, g, s, dh, bk,
                                        cuda_device, dtype,
                                        holes=mode != "plain")
    qpos = torch.tensor([1500, 2047], dtype=torch.int32, device=cuda_device)
    plan_mode = mode != "plain"
    ks = torch.randn(b, hkv, dh, device=cuda_device).to(dtype)
    vs = torch.randn(b, hkv, dh, device=cuda_device).to(dtype)
    kw = dict(n_sel=n_sel, bk=bk, plan_mode=plan_mode,
              has_self=mode == "plan_self", window=bk)
    n0 = t_da.decode_attend_fused.launches
    got = t_da.decode_attend_fused(q, k, v, pos, cent, qpos, ks, vs, **kw)
    torch.cuda.synchronize()
    assert t_da.decode_attend_fused.launches == n0 + 1
    want = t_da.decode_attend_plain(q, k, v, pos, cent, qpos, ks, vs, **kw)
    _assert_kernel_close(got, want, dtype)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("kind", ["gqa128", "mla"])
def test_cuda_zoo_prefill_through_the_wide_kernels(cuda_device, kind):
    """A two-layer model at the zoo's head dims (GQA at 128, g = 4; MLA
    q/k 96, v 64) prefills 512 tokens through ClusterKV on the card: B6 is
    launched once a layer, and at a covering budget in float32 the logits
    are the flash path's."""
    from repro_torch.configs import ClusterKVConfig, MLAConfig, ModelConfig
    from repro_torch.models import model_api
    ckv = ClusterKVConfig(enabled=True, blocks_per_query=4)
    if kind == "mla":
        cfg = ModelConfig(name="mla", family="dense", n_layers=2,
                          d_model=256, n_heads=4, n_kv_heads=4, d_ff=512,
                          vocab=512, d_head=64, dtype="float32",
                          clusterkv=ckv,
                          mla=MLAConfig(q_lora_rank=96, kv_lora_rank=64,
                                        qk_nope_head_dim=64,
                                        qk_rope_head_dim=32, v_head_dim=64))
    else:
        cfg = ModelConfig(name="gqa128", family="dense", n_layers=2,
                          d_model=512, n_heads=4, n_kv_heads=1, d_ff=512,
                          vocab=512, dtype="float32", clusterkv=ckv)
    params = model_api.init(cfg, torch.Generator(device=cuda_device)
                            .manual_seed(0), device=cuda_device)
    tokens = torch.randint(0, cfg.vocab, (1, 512), device=cuda_device,
                           generator=torch.Generator(device=cuda_device)
                           .manual_seed(1))
    n0 = t_ba.block_attention.launches
    _, got = t_model.prefill(params, cfg, {"tokens": tokens}, "clusterkv")
    torch.cuda.synchronize()
    assert t_ba.block_attention.launches == n0 + cfg.n_layers
    _, want = t_model.prefill(params, cfg, {"tokens": tokens}, "flash")
    assert float((got - want).abs().max()) <= 1e-3 * float(want.abs().max())


@pytest.mark.requires_cuda
def test_cuda_hybrid_generates_through_b6_and_b5(cuda_device):
    """A small Zamba2-style hybrid (2 groups, a shared block of 4 heads of
    128, g = 1) served by ``launch.serve.generate`` on the card with
    ClusterKV: B6 once a group a prefill, B5 once a group a step; in
    float32 at budgets covering every tile its tokens are the flash
    path's."""
    from repro_torch.configs import ClusterKVConfig, ModelConfig, SSMConfig
    from repro_torch.launch import serve
    from repro_torch.models import model_api
    cfg = ModelConfig(name="hybrid", family="hybrid", n_layers=4,
                      d_model=256, n_heads=4, n_kv_heads=4, d_ff=512,
                      vocab=512, dtype="float32", shared_attn_every=2,
                      ssm=SSMConfig(version=2, d_state=16, head_dim=32,
                                    chunk=64),
                      clusterkv=ClusterKVConfig(enabled=True,
                                                blocks_per_query=5,
                                                decode_clusters=5))
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    params = model_api.init(cfg, gen, device=cuda_device)
    batch = model_api.make_small_batch(cfg, gen, 2, 512, kind="prefill",
                                       device=cuda_device)
    n6, n5 = t_ba.block_attention.launches, t_da.decode_attend_fused.launches
    got = serve.generate(cfg, params, batch, 128, "clusterkv")
    torch.cuda.synchronize()
    assert t_ba.block_attention.launches == n6 + 2
    assert t_da.decode_attend_fused.launches == n5 + 2 * 127
    want = serve.generate(cfg, params, batch, 128, "flash")
    assert torch.equal(got, want)


@pytest.mark.requires_cuda
def test_cuda_mamba_scans_match_the_cpu(cuda_device):
    """``selective_scan`` and ``ssd`` on card tensors give the CPU's
    results (float32, another order of sums: 1e-5 x max|y|)."""
    from repro_torch.models import mamba
    g = torch.Generator().manual_seed(4)
    b, s, di, n = 2, 300, 64, 16
    args = (torch.randn((b, s, di), generator=g),
            0.1 + torch.rand((b, s, di), generator=g),
            -torch.exp(torch.randn((di, n), generator=g)),
            torch.randn((b, s, n), generator=g),
            torch.randn((b, s, n), generator=g))
    want = mamba.selective_scan(*args, 128)
    got = mamba.selective_scan(*(a.to(cuda_device) for a in args), 128)
    for x, y in zip(got, want):
        assert_close(x.cpu(), y, rtol=1e-5,
                     atol=1e-5 * float(y.abs().max()))
    h = 4
    args = (torch.randn((b, s, h, 8), generator=g),
            0.1 + torch.rand((b, s, h), generator=g),
            -torch.exp(torch.randn(h, generator=g)),
            torch.randn((b, s, n), generator=g),
            torch.randn((b, s, n), generator=g))
    want = mamba.ssd(*args, 128)
    got = mamba.ssd(*(a.to(cuda_device) for a in args), 128)
    for x, y in zip(got, want):
        assert_close(x.cpu(), y, rtol=1e-5,
                     atol=1e-5 * float(y.abs().max()))


@pytest.mark.requires_cuda
def test_cuda_block_attention_skips_tile_ids_outside_the_cache(cuda_device):
    q, k, v, kpos, qpos, idx = _attention_inputs(3, 1, 4, 2, 512, 64, 128, 3,
                                                 cuda_device, torch.float32)
    bad = idx.clone()
    bad[..., -1] = 4                                 # 4 key tiles: 0..3
    got = t_ba.block_attention(q, k, v, kpos, qpos, bad, bq=128, bk=128)
    want = t_ba.block_attention_plain(q, k, v, kpos, qpos,
                                      idx[..., :-1].contiguous(), bq=128,
                                      bk=128)
    _assert_kernel_close(got, want, torch.float32)


@pytest.mark.requires_cuda
def test_cuda_settings_asking_for_the_plain_path_raise(cuda_device):
    """On a CUDA tensor the device picks the kernel: the settings that ask
    for the plain version raise instead of running it on the card."""
    from repro_torch.configs.base import ClusterKVConfig
    q, k, v, pos, cent = _decode_inputs(1, 2, 2, 7, 512, 64, 128,
                                        cuda_device, torch.float32, False)
    kpos = torch.arange(512, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="use_kernel=False"):
        t_attn.clusterkv_decode(q, k, v, kpos, 300, ClusterKVConfig(
            enabled=True, decode_clusters=2, use_kernel=False))
    qpos = torch.tensor([300, 511], dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="CPU tensors only"):
        t_attn.clusterkv_plan_decode(q, k, v, pos, cent, qpos,
                                     ClusterKVConfig(enabled=True,
                                                     decode_clusters=2,
                                                     decode_backend="plain"))


def _b6_inputs(seed, b, hq, hkv, s, s_k, bq, n_sel, device, dtype):
    """Queries at the last ``s`` of ``s_k`` positions (a prompt's suffix),
    cluster-sorted keys with a permuted position each, and ``n_sel``
    distinct key tiles per query tile."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, s, 64)).astype(np.float32)
    k = rng.standard_normal((b, hkv, s_k, 64)).astype(np.float32)
    v = rng.standard_normal((b, hkv, s_k, 64)).astype(np.float32)
    kpos = np.stack([np.stack([rng.permutation(s_k) for _ in range(hkv)])
                     for _ in range(b)]).astype(np.int32)
    idx = np.stack([np.stack([np.stack([
        rng.choice(s_k // bq, n_sel, replace=False)
        for _ in range(s // bq)]) for _ in range(hkv)]) for _ in range(b)]
    ).astype(np.int32)
    dev = dict(device=device)
    return (tt(q).to(dtype=dtype, **dev), tt(k).to(dtype=dtype, **dev),
            tt(v).to(dtype=dtype, **dev), tt(kpos).to(**dev),
            torch.arange(s_k - s, s_k, dtype=torch.int32, **dev),
            tt(idx).to(**dev))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("n_sel", [1, 3, 16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("bq", [32, 64, 128])
def test_cuda_block_attention_bf16_tensor_cores_match_plain(cuda_device, bq,
                                                            causal, n_sel):
    """The bf16 path (mma.sync, cp.async ring, hi/lo P) with S_k != S, held
    at the C10 bound, bit-equal run to run, one counter step per call."""
    q, k, v, kpos, qpos, idx = _b6_inputs(bq + n_sel, 2, 14, 2, 4 * bq,
                                          20 * bq, bq, n_sel, cuda_device,
                                          torch.bfloat16)
    n0 = t_ba.block_attention.launches
    got = t_ba.block_attention(q, k, v, kpos, qpos, idx, bq=bq, bk=bq,
                               causal=causal)
    again = t_ba.block_attention(q, k, v, kpos, qpos, idx, bq=bq, bk=bq,
                                 causal=causal)
    torch.cuda.synchronize()
    assert t_ba.block_attention.launches == n0 + 2
    assert torch.equal(got, again)
    want = t_ba.block_attention_plain(q, k, v, kpos, qpos, idx, bq=bq,
                                      bk=bq, causal=causal)
    _assert_kernel_close(got, want, torch.bfloat16)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("bq", [32, 64, 128])
def test_cuda_block_attention_bf16_uniform_weights_when_all_keys_are_future(
        cuda_device, bq):
    """Query tile 0 selects only keys in its future: every logit is -1e30,
    so each row averages the selected values (the reference's exp(0))."""
    q, k, v, _, qpos, idx = _b6_inputs(5, 1, 4, 2, 2 * bq, 4 * bq, bq, 2,
                                       cuda_device, torch.bfloat16)
    kpos = torch.arange(4 * bq, dtype=torch.int32, device=cuda_device
                        ).expand(1, 2, 4 * bq).contiguous()
    qpos = torch.arange(2 * bq, dtype=torch.int32, device=cuda_device)
    idx[:, :, 0] = torch.tensor([2, 3], dtype=torch.int32,
                                device=cuda_device)
    got = t_ba.block_attention(q, k, v, kpos, qpos, idx, bq=bq, bk=bq)
    want = t_ba.block_attention_plain(q, k, v, kpos, qpos, idx, bq=bq, bk=bq)
    _assert_kernel_close(got, want, torch.bfloat16)
    mean = v[:, :, 2 * bq:].float().mean(dim=2)               # (1, 2, 64)
    _assert_kernel_close(got[:, :, :bq], mean.repeat_interleave(2, dim=1)
                         [:, :, None, :].expand(1, 4, bq, 64)
                         .to(torch.bfloat16), torch.bfloat16)


@pytest.mark.requires_cuda
def test_cuda_block_attention_bf16_skips_tile_ids_outside_the_cache(
        cuda_device):
    q, k, v, kpos, qpos, idx = _b6_inputs(6, 1, 4, 2, 512, 1024, 128, 3,
                                          cuda_device, torch.bfloat16)
    bad = torch.cat([torch.full_like(idx[..., :1], -1), idx,
                     torch.full_like(idx[..., :1], 8)], dim=-1).contiguous()
    got = t_ba.block_attention(q, k, v, kpos, qpos, bad, bq=128, bk=128)
    want = t_ba.block_attention_plain(q, k, v, kpos, qpos, idx, bq=128,
                                      bk=128)
    _assert_kernel_close(got, want, torch.bfloat16)
    # nothing inside the cache: l = 0 and the output is exact zeros
    none = torch.full_like(idx, 8)
    got = t_ba.block_attention(q, k, v, kpos, qpos, none, bq=128, bk=128)
    assert bool((got == 0).all())


@pytest.mark.requires_cuda
@pytest.mark.parametrize("cache", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("qdt", [torch.float32, torch.bfloat16,
                                 torch.float16])
@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["plain", "plan_self"])
def test_cuda_decode_attend_reads_q_and_centroids_in_their_dtype(
        cuda_device, cache, qdt, cdt, mode):
    """B5 reads q and the centroids in the caller's dtype and writes the
    output in q's: the same bits as casting both to float32 first and
    rounding the float32 output to q's dtype (float16 q takes that cast)."""
    b, hkv, g, s, dh, bk, n_sel = 4, 2, 7, 2048, 64, 128, 6
    plan_mode = mode != "plain"
    q, k, v, pos, cent = _decode_inputs(5, b, hkv, g, s, dh, bk, cuda_device,
                                        cache, holes=plan_mode)
    qpos = torch.tensor([1500, 900, 2047, 40], dtype=torch.int32,
                        device=cuda_device)
    ks = torch.randn(b, hkv, dh, device=cuda_device)
    vs = torch.randn(b, hkv, dh, device=cuda_device)
    kw = dict(n_sel=n_sel, bk=bk, plan_mode=plan_mode, has_self=plan_mode,
              window=bk)
    qx, cx = q.float().to(qdt), cent.to(cdt)
    got = t_da.decode_attend_fused(qx, k, v, pos, cx, qpos, ks, vs, **kw)
    ref = t_da.decode_attend_fused(qx.float(), k, v, pos, cx.float(), qpos,
                                   ks, vs, **kw)
    torch.cuda.synchronize()
    assert got.dtype == qdt
    assert torch.equal(got, ref.to(qdt))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["plain", "plan", "plan_self"])
def test_cuda_decode_attend_selects_a_nan_key_tile_like_topk_stable(
        cuda_device, mode, dtype):
    """ROADMAP C15: one key tile holding NaN scores NaN and is selected
    first, as ``topk_stable`` (and ``lax.top_k``) rank it; the query rows
    of its kv head come out NaN as in the plain path, the others match it
    at the C10 bound. A NaN tile whose every entry is a hole (plan mode)
    stays masked; in plain mode it is selected but weighs nothing."""
    b, hkv, g, s, dh, bk, n_sel = 4, 2, 7, 4096, 64, 128, 8
    plan_mode = mode != "plain"
    q, k, v, pos, _ = _decode_inputs(90, b, hkv, g, s, dh, bk, cuda_device,
                                     dtype, holes=plan_mode)
    k[1, 0, 5 * bk:6 * bk] = float("nan")  # tile 5 of (member 1, head 0)
    k[0, 1, 2 * bk:3 * bk, 3] = float("nan")
    pos[0, 1, 2 * bk:3 * bk] = 2 ** 31 - 1   # ... and all holes there
    cent = t_ckv.block_centroids(k.float(), bk)
    qpos = torch.tensor([4000, 4095, 2000, 3000], dtype=torch.int32,
                        device=cuda_device)
    ks = torch.randn(b, hkv, dh, device=cuda_device).to(dtype)
    vs = torch.randn(b, hkv, dh, device=cuda_device).to(dtype)
    kw = dict(n_sel=n_sel, bk=bk, plan_mode=plan_mode,
              has_self=mode == "plan_self", window=bk)
    sel = torch.empty((b, hkv, n_sel), dtype=torch.int32, device=cuda_device)
    got = t_da.decode_attend_fused(q, k, v, pos, cent, qpos, ks, vs,
                                   sel_out=sel, **kw)
    torch.cuda.synchronize()
    if plan_mode:
        want_sel = t_ckv.plan_select(q, pos, cent, qpos, n_sel=n_sel, bk=bk,
                                     window=bk)
        assert int(sel[0, 1, 0]) != 2
    else:
        want_sel = t_ckv.decode_select(q.float(), cent, n_sel)
        assert int(sel[0, 1, 0]) == 2
    assert int(sel[1, 0, 0]) == 5 == int(want_sel[1, 0, 0])
    assert torch.equal(sel.long().sort(-1).values,
                       want_sel.long().sort(-1).values)
    want = t_da.decode_attend_plain(q, k, v, pos, cent, qpos, ks, vs, **kw)
    nan = torch.isnan(want.float())
    assert nan[1, :g].all() and not nan[1, g:].any() and not nan[0].any()
    assert torch.equal(torch.isnan(got.float()), nan)
    _assert_kernel_close(torch.where(nan, 0.0, got.float()).to(dtype),
                         torch.where(nan, 0.0, want.float()).to(dtype), dtype)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["plain", "plan", "plan_self"])
@pytest.mark.parametrize("g", [1, 7])
@pytest.mark.parametrize("n_sel", [1, 6, 16, 64])
def test_cuda_decode_attend_split_matches_plain(cuda_device, n_sel, g, mode,
                                                dtype):
    """B5 split over (member, kv head, tile) blocks up to the covering
    budget (64 tiles of 128 at S = 8192): the plain version's output at the
    C10 bound and its selected set; slot 3 holds only holes (exact zeros,
    or its own value with the self column); bit-equal run to run."""
    b, hkv, s, dh, bk = 4, 2, 8192, 64, 128
    plan_mode = mode != "plain"
    has_self = mode == "plan_self"
    q, k, v, pos, cent = _decode_inputs(n_sel + g, b, hkv, g, s, dh, bk,
                                        cuda_device, dtype,
                                        holes=plan_mode)
    pos[3] = 2 ** 31 - 1
    qpos = torch.tensor([8000, 3000, 8191, 40], dtype=torch.int32,
                        device=cuda_device)
    ks = torch.randn(b, hkv, dh, device=cuda_device).to(dtype)
    vs = torch.randn(b, hkv, dh, device=cuda_device).to(dtype)
    kw = dict(n_sel=n_sel, bk=bk, plan_mode=plan_mode, has_self=has_self,
              window=bk)
    fused = t_da.decode_attend_fused
    sel = torch.empty((b, hkv, n_sel), dtype=torch.int32, device=cuda_device)
    n0 = (fused.launches, fused.plain_mode_launches, fused.plan_mode_launches)
    got = fused(q, k, v, pos, cent, qpos, ks, vs, sel_out=sel, **kw)
    again = fused(q, k, v, pos, cent, qpos, ks, vs, **kw)
    torch.cuda.synchronize()
    assert (fused.launches, fused.plain_mode_launches,
            fused.plan_mode_launches) == (n0[0] + 2,
                                          n0[1] + 2 * (not plan_mode),
                                          n0[2] + 2 * plan_mode)
    assert torch.equal(got, again)
    want = t_da.decode_attend_plain(q, k, v, pos, cent, qpos, ks, vs, **kw)
    _assert_kernel_close(got, want, dtype)
    if plan_mode:
        want_sel = t_ckv.plan_select(q, pos, cent, qpos, n_sel=n_sel, bk=bk,
                                     window=bk)
    else:
        want_sel = t_ckv.decode_select(q.float(), cent, n_sel)
    assert torch.equal(sel.long().sort(-1).values,
                       want_sel.long().sort(-1).values)
    if has_self:
        own = vs[3].float().repeat_interleave(g, dim=0).to(dtype)
        _assert_kernel_close(got[3], own, dtype)
    else:
        assert bool((got[3] == 0).all())


@pytest.mark.requires_cuda
def test_cuda_streamed_plans_run_through_the_spmv_kernel(cuda_device):
    """Every streaming tier on a CUDA plan keeps it on the card; B1 (the
    ``cuda`` backend) agrees with the plain path and the maintained COO on
    the storage only streaming makes (tombstoned rows, claimed holes,
    grown tail blocks, restriped and rebucketed layouts), dead rows come
    out exactly 0, and the input plan keeps its products (copy-on-write)."""
    x = feature_mixture(2048, 32, n_clusters=8, seed=3, spread=1.0)
    plan = t_api.build_plan(x, k=8, bs=32, sb=4, ell_slack=2,
                            capacity=2200, gamma_tol=1e-4)
    _ = plan.gamma
    rng = np.random.default_rng(4)
    ch = rng.standard_normal((4096, 2)).astype(np.float32)
    pool = feature_mixture(4096, 32, n_clusters=8, seed=5, spread=1.0)
    feed, seen = 0, set()
    steps = [dict(m=64), dict(m=64), dict(m=256, grow=True),
             dict(m=64, delete_only=True), dict(m=64, defer=True)]
    for s in steps:
        live = np.nonzero(plan.alive)[0]
        kill = rng.choice(live, s["m"], replace=False)
        ins = None
        if not s.get("delete_only"):
            extra = 300 if s.get("grow") else 0
            ins = pool[feed:feed + s["m"] + extra]
            feed += len(ins)
        before = plan.matvec(ch[:plan.n]).clone()
        n0 = t_bsr.bsr_spmv_batched.launches
        new = t_api.update_plan(plan, insert=ins, delete=kill,
                                defer_layout=bool(s.get("defer")))
        if new.host.pending_layout:
            new = t_api.apply_pending_layout(new)
        assert new.device.type == "cuda" and new.bsr.vals.is_cuda
        y = new.matvec(ch[:new.n])
        assert t_bsr.bsr_spmv_batched.launches > n0
        scale = float(y.abs().max())
        assert_close(y, new.matvec(ch[:new.n], backend="bsr"), rtol=0,
                     atol=1e-4 * scale)
        assert_close(y, new.matvec(ch[:new.n], backend="csr"), rtol=0,
                     atol=1e-4 * scale)
        dead = torch.from_numpy(~new.alive).to(cuda_device)
        assert not y[dead].any()
        assert torch.equal(plan.matvec(ch[:plan.n]), before)
        seen.add(new.refresh_stats.last_action)
        plan = new
    assert plan.refresh_stats.grows >= 1
    assert {"append", "tombstone"} <= seen
    fresh = t_api.build_plan(plan.host.x[plan.alive], config=plan.config)
    comp = plan.compact()
    for name in ("col_idx", "nbr_mask", "vals"):
        assert torch.equal(getattr(comp.bsr, name), getattr(fresh.bsr, name))
    assert torch.equal(comp.matvec(ch[:comp.n]), fresh.matvec(ch[:comp.n]))


def _service_model(device, dtype="float32", clusters=8):
    """The reduced Qwen config with tiles of 32 (``MAX_SEQ`` 128: 4 tiles;
    8 decode clusters cover them all), random weights from a seed."""
    from repro_torch.configs import ClusterKVConfig, reduced_config
    from repro_torch.models import model_api
    cfg = reduced_config("qwen2-0.5b").with_(
        dtype=dtype,
        clusterkv=ClusterKVConfig(enabled=True, block_q=32, block_k=32,
                                  blocks_per_query=8,
                                  decode_clusters=clusters))
    params = model_api.init(cfg, torch.Generator(device=device).manual_seed(0),
                            device=device)
    return cfg, params


def _service_requests(cfg, lengths, max_new=6):
    from repro_torch.train.serve_loop import Request
    rng = np.random.default_rng(7)
    return [Request(rid=i, tokens=rng.integers(1, cfg.vocab, n).astype(
        np.int64), max_new=max_new) for i, n in enumerate(lengths)]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("plan_prefill", [False, True])
def test_cuda_service_matches_flash_engine_through_b5(cuda_device,
                                                      plan_prefill):
    """The decode service on the card gives the flash engine's tokens at
    covering budgets; every tick launches B5 in plan mode once per layer
    (and nothing else of B5), and each plan prefill launches B6 once per
    layer."""
    from repro_torch.serve import ClusterKVEngine
    from repro_torch.train.serve_loop import Engine
    cfg, params = _service_model(cuda_device)
    lengths = [20, 35, 17, 40]
    flash = Engine(cfg, params, slots=2, max_seq=128, prefill_bucket=32,
                   device=cuda_device)
    want = _service_requests(cfg, lengths)
    for r in want:
        flash.submit(r)
    flash.run()
    svc = ClusterKVEngine(cfg, params, slots=2, max_seq=128,
                          prefill_bucket=32, plan_prefill=plan_prefill,
                          device=cuda_device)
    got = _service_requests(cfg, lengths)
    for r in got:
        svc.submit(r)
    fused, ba = t_da.decode_attend_fused, t_ba.block_attention
    n0 = (fused.launches, fused.plan_mode_launches, ba.launches)
    svc.run()
    torch.cuda.synchronize()
    assert [r.output for r in got] == [r.output for r in want]
    assert fused.plan_mode_launches - n0[1] == cfg.n_layers * svc.ticks
    assert fused.launches - n0[0] == cfg.n_layers * svc.ticks
    assert ba.launches - n0[2] == (cfg.n_layers * len(lengths)
                                   if plan_prefill else 0)
    rep = svc.report()
    assert rep["decode_traces"] == 1 and rep["specs_seen"] == 1
    assert svc.pstate["ks"].is_cuda and svc.inserter._x.is_cuda


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_service_tick_b5_matches_plain_on_its_state(cuda_device,
                                                         dtype, monkeypatch):
    """B5 through the ``cuda`` decode backend against
    ``plan_decode_plain`` on the service's own state of one tick (every
    layer's plan-ordered caches, centroids, self column), at a budget of
    2 of 4 tiles: within the C10 bound, the same tiles selected."""
    from repro_torch.serve import ClusterKVEngine
    cfg, params = _service_model(cuda_device, dtype, clusters=2)
    seen = []
    real = t_attn.clusterkv_plan_decode

    def record(q, ks, vs, ps, cent, qpos, ccfg, *, k_self=None,
               v_self=None):
        seen.append([a.clone() for a in (q, ks, vs, ps, cent, qpos, k_self,
                                         v_self)])
        return real(q, ks, vs, ps, cent, qpos, ccfg, k_self=k_self,
                    v_self=v_self)

    svc = ClusterKVEngine(cfg, params, slots=2, max_seq=128,
                          prefill_bucket=32, device=cuda_device)
    for r in _service_requests(cfg, [40, 70], max_new=8):
        svc.submit(r)
    for _ in range(3):
        svc.step()
    monkeypatch.setattr(t_attn, "clusterkv_plan_decode", record)
    svc.step()
    assert len(seen) == cfg.n_layers
    dt = t_model.DTYPES[dtype]
    for q, ks, vs, ps, cent, qpos, k1, v1 in seen:
        sel = torch.empty((2, cfg.n_kv_heads, 2), dtype=torch.int32,
                          device=cuda_device)
        got = t_da.decode_attend_fused(
            q, ks, vs, ps, cent, qpos, k1, v1, n_sel=2, bk=32,
            plan_mode=True, has_self=True, window=32, sel_out=sel)
        want = t_ckv.plan_decode_plain(q, ks, vs, ps, cent, qpos, n_sel=2,
                                       bk=32, window=32, k_self=k1,
                                       v_self=v1)
        assert q.dtype == ks.dtype == dt
        _assert_kernel_close(got, want, dt)
        want_sel = t_ckv.plan_select(q, ps, cent, qpos, n_sel=2, bk=32,
                                     window=32)
        assert torch.equal(sel.long().sort(-1).values,
                           want_sel.sort(-1).values)


@pytest.mark.requires_cuda
def test_cuda_service_with_the_plain_decode_backend_raises(cuda_device):
    """``decode_backend="plain"`` asks for the plain path, which runs on CPU
    tensors only: a service on the card raises at its first tick."""
    import dataclasses
    from repro_torch.serve import ClusterKVEngine
    cfg, params = _service_model(cuda_device)
    cfg = cfg.with_(clusterkv=dataclasses.replace(cfg.clusterkv,
                                                  decode_backend="plain"))
    svc = ClusterKVEngine(cfg, params, slots=1, max_seq=128,
                          prefill_bucket=32, device=cuda_device)
    for r in _service_requests(cfg, [20]):
        svc.submit(r)
    with pytest.raises(ValueError, match="CPU tensors only"):
        svc.step()


# ---------------------------------------------------------------------------
# solvers and the double buffer on the card: B1 under every iteration
# ---------------------------------------------------------------------------


def _solver_plan(seed=3, n=2048, **kw):
    from repro_torch.solvers import RBFValues
    x = feature_mixture(n, 32, n_clusters=8, seed=seed)
    return x, t_api.build_plan(x, k=16, symmetrize=True, values=RBFValues(),
                               **kw)


@pytest.mark.requires_cuda
def test_cuda_solve_runs_b1_once_per_iteration_and_matches_bsr(cuda_device):
    """``backend=None`` on a CUDA plan resolves to the kernel: a KRR fit
    launches B1 once per CG iteration plus the Gershgorin apply, and
    agrees with the same fit through the plain ``bsr`` path."""
    from repro_torch.solvers import krr_fit
    from repro_torch.solvers.krr import _plan_backend
    x, plan = _solver_plan()
    assert _plan_backend(plan, None) == "cuda"
    y = torch.tanh(torch.from_numpy(x[:, 0] - x[:, 1])).to(cuda_device)
    n0 = t_bsr.bsr_spmv_batched.launches
    model = krr_fit(plan, y, lam=0.5)
    iters = int(model.result.iters)
    assert t_bsr.bsr_spmv_batched.launches == n0 + iters + 1
    assert bool(model.result.converged)
    ref = krr_fit(plan, y, lam=0.5, backend="bsr")
    assert abs(int(ref.result.iters) - iters) <= 1
    scale = float(ref.alpha.abs().max())
    assert_close(model.alpha, ref.alpha, rtol=0, atol=1e-4 * scale)
    assert model.alpha.device.type == "cuda"


@pytest.mark.requires_cuda
def test_cuda_solve_check_every_is_bit_exact(cuda_device):
    """Reading the early-exit test every 8 iterations instead of every one
    returns the same bits, on a plan's operator and on a batch's (B1 under
    every iteration, the block-Jacobi preconditioner)."""
    from repro_torch.solvers import cg
    from repro_torch.solvers.krr import _auto_self_weight
    _, plan = _solver_plan()
    _, other = _solver_plan(seed=4)
    batch = t_api.PlanBatch.from_plans([plan, other])
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    factor = t_api.get_preconditioner("block_jacobi")
    for op, b, axis in (
            (plan, torch.randn(plan.n, 2, generator=gen,
                               device=cuda_device), -2),
            (batch, torch.randn(2, batch.capacity, generator=gen,
                                device=cuda_device), -1)):
        shift = _auto_self_weight(op) + 0.5    # SPD: Gershgorin
        sh = shift.reshape(shift.shape + (1,) * (b.ndim - shift.ndim))
        M = factor(op.spec, op.data, shift)

        def A(v):
            return op.apply(v) + sh * v

        def run(every):
            return cg(A, b, M=lambda r: M(r, axis=axis), tol=1e-6,
                      maxiter=300, axis=axis, check_every=every)

        r1 = run(1)
        n0 = t_bsr.bsr_spmv_batched.launches
        r8 = run(8)
        top = int(r8.iters.max())
        assert t_bsr.bsr_spmv_batched.launches - n0 == -(-top // 8) * 8
        for f in ("x", "iters", "resid", "bnorm", "converged"):
            assert torch.equal(getattr(r1, f), getattr(r8, f)), f
        assert torch.equal(torch.nan_to_num(r1.history, 7.0),
                           torch.nan_to_num(r8.history, 7.0))


@pytest.mark.requires_cuda
def test_cuda_block_jacobi_factor_makes_no_host_sync(cuda_device):
    """The batched ``cholesky_ex`` factorization (with its Jacobi fallback)
    and the per-iteration apply read nothing back to the host; the
    factors agree with the CPU's."""
    from repro_torch.solvers import precond
    from repro_torch.solvers.krr import _auto_self_weight
    _, plan = _solver_plan()
    spec, data = plan.spec, plan.data
    # the KRR setting (Gershgorin shift): blocks well conditioned, so the
    # card's factors and the CPU's agree to float32 rounding
    shift = _auto_self_weight(plan) + 0.5
    r = torch.randn(plan.n, device=cuda_device)
    precond.block_jacobi(spec, data, shift)(r)           # warm the libraries
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        z = precond.block_jacobi(spec, data, shift)(r)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    cpu = t_api.InteractionPlan.from_spec_data(
        spec, t_api.PlanData(**{k: None if v is None else v.cpu()
                                for k, v in vars(data).items()}))
    want = precond.block_jacobi(cpu.spec, cpu.data, shift.cpu())(r.cpu())
    assert_close(z, want, rtol=1e-4, atol=1e-5)


@pytest.mark.requires_cuda
def test_cuda_batch_solve_is_one_b1_launch_per_iteration(cuda_device):
    from repro_torch.solvers import RBFValues, krr_fit, krr_fit_batch
    xs = [feature_mixture(n, 32, n_clusters=8, seed=20 + i)
          for i, n in enumerate((1024, 900, 1000))]
    batch = t_api.build_plan_batch(xs, k=16, symmetrize=True,
                                   values=RBFValues())
    ys = batch.pad_charges([np.tanh(x[:, 0]) for x in xs])
    n0 = t_bsr.bsr_spmv_batched.launches
    model = krr_fit_batch(batch, ys, lam=0.5)
    assert t_bsr.bsr_spmv_batched.launches == \
        n0 + int(model.result.iters.max()) + 1
    for i, mem in enumerate(batch.members()):
        own = krr_fit(mem, ys[i], lam=0.5)
        scale = float(own.alpha.abs().max())
        assert_close(model.alpha[i], own.alpha, rtol=0, atol=1e-4 * scale)


@pytest.mark.requires_cuda
def test_cuda_lanczos_eigs_and_spectral_match_bsr(cuda_device):
    from repro_torch.solvers import (RBFValues, normalized_operator,
                                     spectral_embedding)
    _, plan = _solver_plan()
    v0 = torch.randn(plan.n, device=cuda_device)
    n0 = t_bsr.bsr_spmv_batched.launches
    w, u = plan.eigs(k=4, m=32, v0=v0)
    assert t_bsr.bsr_spmv_batched.launches == n0 + 32
    wb, _ = plan.eigs(k=4, m=32, v0=v0, backend="bsr")
    assert_close(w, wb, rtol=0, atol=1e-4 * float(wb.abs().max()))
    assert float((u.T @ u - torch.eye(4, device=cuda_device)).abs().max()) \
        < 1e-4
    # spectral embedding of weakly bridged clusters (distinct top
    # eigenvalues; a degenerate eigenvalue would leave all but one Ritz
    # vector to rounding, ROADMAP C21)
    rng = np.random.default_rng(7)
    labels = rng.integers(0, 4, 2048)
    centers = rng.standard_normal((4, 8)).astype(np.float32)
    x = (centers[labels] + 0.45 * rng.standard_normal(
        (2048, 8))).astype(np.float32)
    sim = t_api.build_plan(x, k=16, symmetrize=True, values=RBFValues())
    v0 = torch.randn(2048, device=cuda_device)
    n0 = t_bsr.bsr_spmv_batched.launches
    ws, y = spectral_embedding(plan=sim, n_components=2, bandwidth=0,
                               drop_first=False, m=32, v0=v0)
    assert t_bsr.bsr_spmv_batched.launches == n0 + 33
    wsb, _ = spectral_embedding(plan=sim, n_components=2, bandwidth=0,
                                drop_first=False, m=32, v0=v0,
                                backend="bsr")
    assert_close(ws, wsb, rtol=0, atol=1e-4)
    n_plain, _ = normalized_operator(sim, backend="bsr")
    yc = sim.permute(y)
    for j in range(2):
        res = n_plain(yc[:, j].contiguous()) - ws[j] * yc[:, j]
        assert float(torch.linalg.vector_norm(res)) < 1e-3


@pytest.mark.requires_cuda
def test_cuda_doublebuffer_serves_through_b1_while_it_builds(cuda_device,
                                                            monkeypatch):
    """The background compaction runs on the card from its own thread on
    the plan's device; mid-build matvecs go through B1 and equal the old
    generation's bits; the successor equals the repair run inline."""
    import threading
    from repro_torch.core.doublebuf import DoubleBufferedPlan
    x = feature_mixture(2048, 32, n_clusters=8, seed=5)
    plan = t_api.build_plan(x, k=8, ell_slack=4, capacity=2300)
    gate = threading.Event()
    real = t_api.apply_pending_layout

    def gated(p):
        assert gate.wait(60)
        assert torch.cuda.current_device() == p.device.index
        return real(p)

    monkeypatch.setattr(t_api, "apply_pending_layout", gated)
    dbp = DoubleBufferedPlan(plan)
    rng = np.random.default_rng(6)
    kill = rng.choice(np.nonzero(plan.alive)[0], 700, replace=False)
    assert dbp.update(delete=kill) == "applied" and dbp.building
    snap = dbp.plan
    live = np.nonzero(snap.alive)[0]
    assert dbp.update(delete=live[:20]) == "queued"
    ch = torch.randn(snap.n, device=cuda_device)
    y0 = dbp.matvec(ch)
    n0 = t_bsr.bsr_spmv_batched.launches
    gate.set()
    mids = 0
    while dbp.building:
        assert torch.equal(dbp.matvec(ch), y0)
        mids += 1
    assert t_bsr.bsr_spmv_batched.launches == n0 + mids
    dbp.wait()
    snapshot, successor, kind = dbp.last_swap
    assert kind == "compact" and dbp.generation == 1 and dbp.queued == 0
    redo = real(snapshot)
    for f in ("col_idx", "nbr_mask", "vals"):
        assert torch.equal(getattr(successor.bsr, f), getattr(redo.bsr, f))
    assert torch.equal(successor.pi, redo.pi)
    cs = torch.randn(successor.n, device=cuda_device)
    want = successor.matvec(cs, backend="bsr")
    assert_close(successor.matvec(cs), want, rtol=0,
                 atol=1e-4 * float(want.abs().max()))
    assert torch.equal(snap.matvec(ch), y0)


# ---------------------------------------------------------------------------
# the cost model and autotune (A9) and persistence (A10) on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def fresh_autotune():
    """Autotune decisions and calibration from nothing, dropped again after
    the test so other tests calibrate as before."""
    from repro_torch.core import autotune, costmodel
    autotune.clear_tune_memo()
    autotune.clear_calibration()
    costmodel.set_hardware(None)
    yield autotune
    autotune.clear_tune_memo()
    autotune.clear_calibration()
    costmodel.set_hardware(None)


@pytest.mark.requires_cuda
def test_cuda_restored_plan_matvec_is_bit_equal(cuda_device, tmp_path):
    """A plan saved by the Checkpointer and restored on the card gives the
    unsaved plan's B1 ``matvec`` bit for bit, through one launch."""
    from repro_torch.checkpoint import Checkpointer
    x = feature_mixture(4096, 32, n_clusters=16, seed=3)
    plan = t_api.build_plan(x, k=12, backend="cuda", device=cuda_device)
    ck = Checkpointer(tmp_path)
    ck.save_plan(1, plan)
    ck.wait()
    back, step = ck.restore_plan()
    assert step == 1 and back.device.type == "cuda"
    for f in (None, 5):
        shape = (4096,) if f is None else (4096, f)
        ch = torch.from_numpy(np.random.default_rng(1).standard_normal(
            shape).astype(np.float32)).to(cuda_device)
        n0 = t_bsr.bsr_spmv_batched.launches
        y = back.matvec(ch)
        assert t_bsr.bsr_spmv_batched.launches == n0 + 1
        assert torch.equal(y, plan.matvec(ch))


@pytest.mark.requires_cuda
def test_cuda_tune_backend_picks_cuda_at_a_small_plan(cuda_device,
                                                      fresh_autotune):
    """Calibration set first by a tiny plan, where the host wall of a
    launch can rank a plain path ahead of the kernel, leaves ``"auto"``
    on the card at ``cuda``: the ranking there is a report."""
    tiny = t_api.build_plan(feature_mixture(256, 32, n_clusters=4, seed=6),
                            k=8, bs=16, sb=4, device=cuda_device)
    assert fresh_autotune.tune_backend(tiny)[0] == "cuda"
    assert tiny.resolve_backend() == "cuda"
    x = feature_mixture(32768, 32, n_clusters=64, seed=4)
    plan = t_api.build_plan(x, k=16, device=cuda_device)
    n0 = t_bsr.bsr_spmv_batched.launches
    name, pred = fresh_autotune.tune_backend(plan, calibrate=False)
    assert name == "cuda" and "cuda" in pred
    assert t_bsr.bsr_spmv_batched.launches == n0     # no probe, no launch
    fresh_autotune.clear_calibration()
    name, pred = fresh_autotune.tune_backend(plan)
    assert name == "cuda", pred
    assert t_bsr.bsr_spmv_batched.launches > n0          # the probe ran
    assert set(fresh_autotune._CALIB) >= {"cuda:cuda", "cuda:bsr"}
    assert plan.resolve_backend() == "cuda"


@pytest.mark.requires_cuda
def test_cuda_auto_after_a_streaming_step_issues_no_host_sync(
        cuda_device, fresh_autotune):
    """A streaming step changes the plan's edge count; the first
    ``"auto"`` matvec after it still launches B1 once and reads nothing
    back to the host, with the autotune calibrated and memoized before."""
    plan = t_api.build_plan(feature_mixture(2048, 32, n_clusters=8, seed=7),
                            k=8, device=cuda_device)
    fresh_autotune.tune_backend(plan)
    rng = np.random.default_rng(7)
    new = t_api.update_plan(
        plan, insert=feature_mixture(64, 32, n_clusters=8, seed=8),
        delete=rng.choice(plan.n, 32, replace=False))
    ch = torch.randn(new.n, device=cuda_device)
    want = new.matvec(ch, backend="cuda")
    torch.cuda.synchronize()
    memo = dict(fresh_autotune._TUNE_MEMO)
    n0 = t_bsr.bsr_spmv_batched.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        y = new.matvec(ch)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert t_bsr.bsr_spmv_batched.launches == n0 + 1
    assert torch.equal(y, want)
    assert fresh_autotune._TUNE_MEMO == memo         # no lookup was made


@pytest.mark.requires_cuda
def test_cuda_probe_that_fails_makes_tune_raise(cuda_device, fresh_autotune,
                                                monkeypatch):
    """A ``cuda`` probe that raises, or disagrees with ``bsr``, raises out
    of ``tune_backend``: 'auto' never quietly ranks a plain path instead."""
    from repro_torch.core import registry
    x = feature_mixture(2048, 32, n_clusters=8, seed=5)
    plan = t_api.build_plan(x, k=8, device=cuda_device)
    real = registry.get_backend("cuda")

    def broken(plan, x, **kw):
        raise RuntimeError("kernel launch failed")

    monkeypatch.setitem(registry._BACKENDS, "cuda", broken)
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        fresh_autotune.tune_backend(plan)

    def wrong(plan, x, **kw):
        return real(plan, x) * 1.01

    fresh_autotune.clear_calibration()
    monkeypatch.setitem(registry._BACKENDS, "cuda", wrong)
    with pytest.raises(RuntimeError, match="disagrees with 'bsr'"):
        fresh_autotune.tune_backend(plan)
    assert "cuda:cuda" not in fresh_autotune._CALIB


@pytest.mark.requires_cuda
def test_cuda_choose_decode_backend_with_default_knobs_picks_cuda(
        cuda_device, fresh_autotune):
    from repro_torch.configs.base import ClusterKVConfig
    from repro_torch.core import costmodel
    feat = costmodel.DecodeFeatures(batch=4, hq=14, hkv=2, s=8192, dh=64,
                                    dv=64, bk=128, n_sel=16)
    assert costmodel.choose_decode_backend(feat) == "cuda"
    q = torch.zeros(4, 14, 64, device=cuda_device)
    ks = torch.zeros(4, 2, 8192, 64, device=cuda_device)
    assert t_attn.resolve_decode_backend(ClusterKVConfig(), q, ks, ks) \
        == "cuda"


@pytest.mark.requires_cuda
def test_cuda_decode_auto_is_the_kernel_whatever_the_model(cuda_device,
                                                           monkeypatch):
    """On card tensors ``"auto"`` is B5 without asking the model: a model
    that would answer ``plain`` (which raises on the card) is not
    consulted."""
    from repro_torch.configs.base import ClusterKVConfig
    from repro_torch.core import costmodel

    def plain(*a, **k):
        return "plain"

    monkeypatch.setattr(costmodel, "choose_decode_backend", plain)
    q = torch.zeros(4, 14, 64, device=cuda_device)
    ks = torch.zeros(4, 2, 8192, 64, device=cuda_device)
    assert t_attn.resolve_decode_backend(ClusterKVConfig(), q, ks, ks) \
        == "cuda"


# -- sharded plans (core/shardplan.py) on one card ----------------------------


def _sharded_plan(n=4096, seed=7):
    x = feature_mixture(n, 32, n_clusters=16, seed=seed)
    return t_api.build_plan(x, k=8, bs=32, sb=4, ell_slack=4)


def _card_mesh(cuda_device, n_dev):
    from repro_torch.launch.mesh import make_mesh
    return make_mesh((n_dev,), ("data",), [cuda_device] * n_dev)


@pytest.mark.requires_cuda
def test_cuda_b2_on_a_rectangular_shard_window(cuda_device):
    """B2 over one shard's window: more column blocks than row blocks
    (halo on both sides plus a replicated hot set), the shard's own slot
    mask, against its plain version on the same card tensors."""
    import dataclasses
    from repro_torch.core.blocksparse import random_bsr
    b = random_bsr(0, 4096, 32, 4, banded=True, device=cuda_device)
    col, mask, vals = b.col_idx.clone(), b.nbr_mask.clone(), b.vals.clone()
    col[0, 0], col[70, 1] = b.n_rb - 1, 3          # two far columns: hot
    mask[9, 2], vals[9, 2] = False, 0.0            # and a masked slot
    plan = t_api.InteractionPlan.from_bsr(dataclasses.replace(
        b, col_idx=col, nbr_mask=mask, vals=vals))
    sp = plan.shard(_card_mesh(cuda_device, 8))
    spec, bs = sp.spec, plan.bsr.bs
    assert spec.mode == "halo" and spec.n_hot == 2
    assert spec.win + spec.n_hot > spec.rb_per
    x = torch.randn(spec.n_rb_pad * bs, device=cuda_device)
    xs = list(x.split(spec.rb_per * bs))
    for d, win in enumerate(sp._windows(xs)):
        assert win.shape == ((spec.win + spec.n_hot) * bs,)
        n0 = t_bsr.bsr_spmv.launches
        got = t_bsr.bsr_spmv(sp.vals[d], sp.lcol[d], win[:, None],
                             sp.mask[d], indices_checked=True)
        torch.cuda.synchronize()
        assert t_bsr.bsr_spmv.launches == n0 + 1
        want = t_bsr.bsr_spmv_plain(sp.vals[d], sp.lcol[d], win[:, None],
                                    sp.mask[d])
        scale = max(float(want.abs().max()), 1e-30)
        assert_close(got, want, rtol=0, atol=2e-5 * scale)


@pytest.mark.requires_cuda
def test_cuda_four_shard_matvec_on_one_card_is_the_unsharded_one(
        cuda_device):
    """Four shards on one card, one B2 launch each: each row's kept tiles
    are walked in the same order as B1 walks them for the unsharded
    plan, so the products are bit-equal."""
    plan = _sharded_plan()
    sp = plan.shard(_card_mesh(cuda_device, 4))
    x = torch.randn(plan.n, device=cuda_device)
    n0 = t_bsr.bsr_spmv.launches
    y = sp.matvec(x)
    torch.cuda.synchronize()
    assert t_bsr.bsr_spmv.launches == n0 + 4
    assert torch.equal(y, plan.matvec(x, backend="cuda"))
    assert torch.equal(plan.apply(plan.permute(x), backend="dist",
                                  mesh=sp.mesh), sp.apply(plan.permute(x)))


@pytest.mark.requires_cuda
def test_cuda_sharded_update_leaves_the_input_shards_untouched(cuda_device):
    """ROADMAP C6 for shards: a delete patches clones of the owning shards
    only; the input ShardedPlan keeps its tensors and its products."""
    plan = _sharded_plan()
    sp = plan.shard(_card_mesh(cuda_device, 4))
    before = [v.clone() for v in sp.vals]
    x = torch.randn(plan.n, device=cuda_device)
    y0 = sp.matvec(x).clone()
    sp2 = sp.delete(np.asarray(plan.host.pi[100:130], np.int64))
    assert (sp2.shard_patches, sp2.reshards) == (1, 0)
    owners = set((sp2.plan.host.last_patch_rb // sp.spec.rb_per).tolist())
    assert 0 < len(owners) < 4
    for d in range(4):
        assert (sp2.vals[d] is sp.vals[d]) == (d not in owners)
        assert torch.equal(sp.vals[d], before[d])
    assert torch.equal(sp.matvec(x), y0)
    assert torch.equal(sp2.matvec(x), sp2.plan.matvec(x, backend="cuda"))


@pytest.mark.requires_cuda
def test_cuda_cpu_plan_on_a_card_mesh_is_rejected(cuda_device, tmp_path):
    """A CPU plan sharded over cards would copy each shard's result back
    to host memory without a sync; ``shard`` refuses that mesh, and so
    does a CPU restore onto it."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.launch.mesh import make_mesh
    x = feature_mixture(1024, 32, n_clusters=8, seed=5)
    plan = t_api.build_plan(x, k=8, bs=32, sb=4, device="cpu")
    for mesh in (make_mesh((1,), ("data",)), _card_mesh(cuda_device, 4)):
        with pytest.raises(ValueError, match="the plan lives on cpu"):
            plan.shard(mesh)
    ck = Checkpointer(tmp_path)
    ck.save_plan(1, plan)
    ck.wait()
    with pytest.raises(ValueError, match="the plan lives on cpu"):
        ck.restore_plan(mesh=_card_mesh(cuda_device, 2), device="cpu")
    back, _ = ck.restore_plan(mesh=_card_mesh(cuda_device, 2))
    ch = torch.from_numpy(np.random.default_rng(2).standard_normal(
        1024).astype(np.float32))
    assert torch.equal(back.matvec(ch.to(cuda_device)).cpu(),
                       back.plan.matvec(ch.to(cuda_device)).cpu())


def _c40_calls(device):
    """One call of each kernel wrapper on card tensors, by kernel, with
    the floating input that may require grad."""
    g = torch.Generator(device=device).manual_seed(0)
    q = torch.randn(1, 2, 128, 64, generator=g, device=device)
    k = torch.randn(1, 1, 128, 64, generator=g, device=device)
    v = torch.randn(1, 1, 128, 64, generator=g, device=device)
    pos = torch.arange(128, dtype=torch.int32, device=device)
    kpos = pos.expand(1, 1, 128)
    idx = torch.zeros(1, 1, 1, 1, dtype=torch.int32, device=device)
    cent = k.reshape(1, 1, 1, 128, 64).mean(3)
    vals = torch.randn(2, 1, 32, 32, generator=g, device=device)
    col = torch.zeros(2, 1, dtype=torch.int32, device=device)
    x = torch.randn(64, 3, generator=g, device=device)
    return {
        "B6": (q, lambda t: t_ops.block_attention(t, k, v, kpos, pos, idx,
                                                  bq=128, bk=128)),
        "B5": (q[:, :, 0].contiguous(), lambda t: t_ops.decode_attend_fused(
            t, k, v, kpos, cent, torch.tensor(127, device=device), n_sel=1,
            bk=128)),
        "B1": (x, lambda t: t_ops.bsr_spmv_batched(vals[None], col[None],
                                                  t[None])),
        "B2": (x, lambda t: t_ops.bsr_spmv(vals, col, t)),
        "B4": (x[:, :2].contiguous(), lambda t: t_ops.tsne_force(
            vals, col, t)),
        "B3": (torch.rand(256, generator=g, device=device),
               lambda t: t_ops.gamma_exact(
                   torch.arange(256, device=device),
                   torch.arange(256, device=device), 2.0, weights=t)),
    }


@pytest.mark.requires_cuda
@pytest.mark.parametrize("kernel", ["B1", "B2", "B3", "B4", "B5", "B6"])
def test_cuda_kernel_wrappers_raise_c40_under_grad(cuda_device, kernel):
    """C40: no kernel has a backward, so a wrapper given a card tensor that
    requires grad, under grad mode, raises naming the kernel; with grad
    mode off it launches."""
    t, call = _c40_calls(cuda_device)[kernel]
    with pytest.raises(NotImplementedError, match=f"{kernel}.*C40"):
        call(t.clone().requires_grad_())
    with torch.no_grad():
        out = call(t.clone().requires_grad_())
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()


@pytest.mark.requires_cuda
def test_cuda_two_layer_qwen_trains_without_launching_a_kernel(cuda_device):
    """Qwen2-0.5B at full width, 2 layers, bf16 compute over float32
    masters: two AdamW steps on one batch with flash attention give finite,
    falling losses and launch no kernel; the same step with ClusterKV
    raises C40 at B6; the trained weights then prefill through B6."""
    from repro_torch.configs import get_config
    from repro_torch.data import pipeline
    from repro_torch.models import model_api
    from repro_torch.optim.optimizers import make_optimizer
    from repro_torch.train import trainer
    cfg = get_config("qwen2-0.5b").with_(n_layers=2, loss_chunk=512)
    params = model_api.init(cfg, torch.Generator(device=cuda_device)
                            .manual_seed(0), device=cuda_device)
    opt = make_optimizer(cfg.optimizer, lr=1e-3, warmup=1, total=2)
    step, _ = trainer.make_train_step(cfg, None, "flash", optimizer=opt)
    state = opt.init(params)
    batch = pipeline.to_device(pipeline.token_batch(cfg, 0, 2, 512),
                               cuda_device)
    n6, n5 = t_ba.block_attention.launches, t_da.decode_attend_fused.launches
    losses = []
    for _ in range(2):
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
        assert np.isfinite(float(m["grad_norm"]))
    assert (t_ba.block_attention.launches,
            t_da.decode_attend_fused.launches) == (n6, n5)
    assert np.isfinite(losses).all() and losses[1] < losses[0]
    ckv_step, _ = trainer.make_train_step(cfg, None, "clusterkv",
                                          optimizer=opt)
    with pytest.raises(NotImplementedError, match="block_attention.*C40"):
        ckv_step(params, state, batch)
    with torch.no_grad():
        _, logits = trainer.make_prefill_step(cfg, backend="clusterkv")(
            params, {"tokens": batch["tokens"]})
    torch.cuda.synchronize()
    assert t_ba.block_attention.launches == n6 + cfg.n_layers
    assert torch.isfinite(logits).all()


@pytest.mark.requires_cuda
@pytest.mark.parametrize("arch,ep", [("qwen2-0.5b", False),
                                     ("granite-moe-3b-a800m", True),
                                     ("mistral-large-123b", False)])
def test_cuda_mesh_step_matches_the_step_without_a_mesh(cuda_device, tmp_path,
                                                        arch, ep):
    """Training on a process mesh of the one card (an nccl group of one
    rank, a (1, 1) ("data", "model") mesh): two steps through
    ``make_train_step(mesh=)`` on DTensor parameters and state against two
    without a mesh from the same init, at full width and 2 layers (granite
    with expert parallelism, its all-to-alls over a group of one; mistral
    with Adafactor, its sums all-reduced over groups of one): loss and grad
    norm within rtol 1e-5."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.data import pipeline
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import model_api
    from repro_torch.optim.optimizers import make_optimizer
    from repro_torch.train import trainer
    cfg = get_config(arch).with_(n_layers=2)
    if ep:
        cfg = cfg.with_(moe=dataclasses.replace(cfg.moe,
                                                expert_parallel=True))
    opt = make_optimizer(cfg.optimizer, lr=1e-3, warmup=1, total=2)
    batch = pipeline.to_device(pipeline.token_batch(cfg, 0, 2, 512),
                               cuda_device)
    card = torch.device("cuda", torch.cuda.current_device())
    dist.init_process_group("nccl", init_method=f"file://{tmp_path / 'pg'}",
                            rank=0, world_size=1, device_id=card)
    try:
        mesh = make_test_mesh(1, 1)
        got = {}
        for m in (None, mesh):
            params = model_api.init(cfg, torch.Generator(
                device=cuda_device).manual_seed(0), device=cuda_device)
            state = opt.init(params)
            if m is not None:
                params, state = trainer.place_train_state(cfg, m, opt,
                                                          params, state)
            step, _ = trainer.make_train_step(cfg, m, "flash", optimizer=opt)
            metrics = []
            for _ in range(2):
                params, state, out = step(params, state, batch)
                metrics.append((float(out["loss"]),
                                float(out["grad_norm"])))
            got[m is None] = metrics
    finally:
        dist.destroy_process_group()
    np.testing.assert_allclose(got[False], got[True], rtol=1e-5)
    assert np.isfinite(got[False]).all()


@pytest.mark.requires_cuda
def test_cuda_b5_b6_ops_launch_once_and_equal_their_cuda_implementation(
        cuda_device):
    """B6 and B5 through their opaque ops (``kernels/library.py``) launch
    their kernels once a call (counted there) and give, bit for bit, what
    their ``CUDA`` implementations give called directly; under
    ``FakeTensorMode`` the same wrappers launch nothing."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    gen = torch.Generator(device=cuda_device).manual_seed(0)
    b, hq, hkv, s, dh, bq, n_sel = 2, 14, 2, 512, 64, 128, 2
    q = torch.randn((b, hq, s, dh), generator=gen, device=cuda_device).bfloat16()
    k = torch.randn((b, hkv, s, dh), generator=gen,
                    device=cuda_device).bfloat16()
    kpos = torch.arange(s, dtype=torch.int32, device=cuda_device).expand(
        b, hkv, s).contiguous()
    qpos = torch.arange(s, dtype=torch.int32, device=cuda_device)
    idx = torch.arange(n_sel, dtype=torch.int32, device=cuda_device).expand(
        b, hkv, s // bq, n_sel).contiguous()
    n0 = t_ba.block_attention.launches
    got = t_ops.block_attention(q, k, k, kpos, qpos, idx, bq=bq, bk=bq)
    assert t_ba.block_attention.launches == n0 + 1
    want = t_ba.launch(q, k, k, kpos, qpos, idx, bq, bq, True)
    assert torch.equal(got, want)
    q1 = torch.randn((b, hq, dh), generator=gen, device=cuda_device).bfloat16()
    cent = t_ckv.block_centroids(k.float(), bq)
    n0 = t_da.decode_attend_fused.launches
    got = t_ops.decode_attend_fused(q1, k, k, kpos, cent, s - 1, n_sel=n_sel,
                                    bk=bq)
    assert t_da.decode_attend_fused.launches == n0 + 1
    qp = torch.full((b,), s - 1, dtype=torch.int32, device=cuda_device)
    want = t_da.launch(q1.reshape(b, hkv, hq // hkv, dh).contiguous(), k, k,
                       kpos, cent.contiguous(), qp, None, None, None, n_sel,
                       bq, False, False, 0)
    assert torch.equal(got, want)
    n0 = (t_ba.block_attention.launches, t_da.decode_attend_fused.launches)
    with FakeTensorMode(allow_non_fake_inputs=True):
        out = t_ops.block_attention(torch.empty_like(q), k, k, kpos, qpos,
                                    idx, bq=bq, bk=bq)
        assert out.shape == q.shape
    assert (t_ba.block_attention.launches,
            t_da.decode_attend_fused.launches) == n0
