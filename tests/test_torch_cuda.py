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


def _attention_inputs(seed, b, hq, hkv, s, dh, bq, n_sel, device, dtype):
    """Cluster-sorted k/v with a permuted position per key, and for every
    query tile ``n_sel`` distinct key tiles."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, s, dh)).astype(np.float32)
    k = rng.standard_normal((b, hkv, s, dh)).astype(np.float32)
    v = rng.standard_normal((b, hkv, s, dh)).astype(np.float32)
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
