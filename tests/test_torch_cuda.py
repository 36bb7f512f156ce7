"""The port's CUDA kernels against their plain versions, on a card.

These tests need an NVIDIA GPU and ``nvcc`` and skip elsewhere (a CUDA
kernel has no CPU mode). They import neither JAX nor the reference
package, so they run on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m requires_cuda tests/test_torch_cuda.py

Tolerance: the kernel sums in another order than the plain version, so
float32 ``rtol=1e-4, atol=1e-4`` at these magnitudes (|y| up to ~50).
"""
import numpy as np
import pytest
import torch

from _torch_parity import assert_close, cuda_device, random_ell, tt  # noqa: F401

from repro_torch import api as t_api
from repro_torch.data.pipeline import feature_mixture
from repro_torch.kernels import bsr_spmv as t_bsr
from repro_torch.kernels import gamma_score as t_gs
from repro_torch.kernels import tsne_force as t_tf


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


@pytest.mark.requires_cuda
@pytest.mark.parametrize("symmetric", [False, True])
def test_cuda_gamma_pairs_matches_plain_and_is_reproducible(cuda_device,
                                                            symmetric):
    rows, cols = _pattern(5, 2048, 400)
    co = tt(np.stack([rows, cols], 1).astype(np.float32)).to(cuda_device)
    w = (torch.rand(2048, device=cuda_device) > 0.2).float()
    got = t_gs.gamma_pairs(co, 7.5, 256, weights=w, symmetric=symmetric)
    again = t_gs.gamma_pairs(co, 7.5, 256, weights=w, symmetric=symmetric)
    want = t_gs.gamma_pairs_plain(co, 7.5, 256, weights=w,
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
