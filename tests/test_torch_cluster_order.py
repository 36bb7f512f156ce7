"""ClusterKV's key ordering kernel (``kernels/cluster_order.py``,
``csrc/cluster_order.cu``): each key set's embedding and Morton codes in
one launch.

On the CPU (tier 1): ``ops.cluster_codes`` is the plain version bit for
bit, ``cluster_perm`` counts no ``ckv.order_sets`` and launches nothing,
the op traces under ``FakeTensorMode`` with its FLOP formula,
``check_against_plain`` passes the plain version and codes moved at cell
edges and catches what a wrong kernel could hand back, and a float32
emulation of the kernel's Householder QR gives LAPACK's Q, column signs
and all.

On a card (``requires_cuda``; this file imports no JAX):

    PYTHONPATH=src python -m pytest -q -m requires_cuda tests/test_torch_cluster_order.py

the layout the kernel chooses for each shape, and the kernel against the
plain version at both training shapes and at other head dims, embedding
dims, an S no block or cluster divides, a tiny S, float32 keys streamed
through shared memory and strided keys. Tolerance
(``kernels/cluster_order.check_against_plain``): the projections ``y``
within 1e-5 of max|y| (the sums run in another order); a code may differ
only where the plain version's quantized coordinate lies within the
projections' gap of a cell edge (ROADMAP C31), and the kernel's own codes
are exact for its own ``y``.
"""
import warnings

import numpy as np
import pytest
import torch

from _torch_parity import cuda_device, tt  # noqa: F401

from repro_torch import trace
from repro_torch.core import clusterkv as t_ckv
from repro_torch.core.embedding import pca_project_det
from repro_torch.core.hierarchy import morton_codes
from repro_torch.kernels import cluster_order as t_co
from repro_torch.kernels import ops as t_ops


def _keys(seed, lead, s, dh, dtype=torch.float32):
    """Clustered keys with a nonzero mean, as attention keys come."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((8, dh)).astype(np.float32) * 3
    k = (centers[rng.integers(0, 8, tuple(lead) + (s,))] + 1.5
         + 0.3 * rng.standard_normal(tuple(lead) + (s, dh)))
    return tt(k.astype(np.float32)).to(dtype)


# ---------------------------------------------------------------------------
# CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("lead,dtype,d", [((2, 3), torch.float32, 3),
                                          ((), torch.float32, 2),
                                          ((2, 1, 2), torch.bfloat16, 3),
                                          ((4,), torch.float32, 1)])
def test_cluster_codes_on_the_cpu_is_the_plain_version(lead, dtype, d):
    k = _keys(0, lead, 96, 12, dtype)
    got = t_ops.cluster_codes(k, d, 10)
    flat = k.reshape(-1, 96, 12)
    want = morton_codes(pca_project_det(flat, d, device="cpu"), 10,
                        device="cpu").reshape(k.shape[:-1])
    assert got.dtype == torch.int64 and got.shape == k.shape[:-1]
    assert torch.equal(got, want)
    assert torch.equal(t_ckv.cluster_perm(k, d=d),
                       torch.argsort(want, dim=-1, stable=True))


def test_cluster_perm_on_the_cpu_counts_no_order_sets():
    k = _keys(1, (2, 3), 64, 16)
    n0 = t_co.cluster_codes.launches
    with trace.recording() as rec:
        t_ckv.cluster_perm(k)
    assert rec.counters.get("ckv.order_sets", 0) == 0
    assert t_co.cluster_codes.launches == n0
    names = [s.name for s in rec.spans]
    assert names == ["ckv.cluster_perm", "ckv.pca", "ckv.morton_sort"]


def test_cluster_codes_traces_under_fake_cuda_tensors():
    """Fake CUDA tensors (no card needed): the op's shape, dtype and
    device, no ``data_ptr()`` read (warnings are errors), no launch and no
    counter, FLOPs ``2 S dh d (2 iters + 1)`` a set (the plain version's
    matrix products)."""
    from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    b, h, s, dh, d = 2, 40, 2048, 96, 3
    n0 = t_co.cluster_codes.launches
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with trace.recording() as rec, FakeTensorMode():
            k = torch.empty((b, s, h, dh), dtype=torch.bfloat16,
                            device="cuda").transpose(1, 2)
            with FlopCounterMode(display=False) as fc:
                codes = t_ops.cluster_codes(k, d, 10)
            assert isinstance(codes, FakeTensor)
            assert (tuple(codes.shape), codes.dtype, codes.device.type) == \
                ((b, h, s), torch.int64, "cuda")
            assert {str(op): n for op, n in fc.get_flop_counts()[
                "Global"].items()} == {
                    "repro_torch.cluster_codes": 2 * s * dh * d * 9 * b * h}
            k3 = torch.empty((h, s, dh), dtype=torch.bfloat16,
                             device="cuda")
            perm = t_ckv.cluster_perm(k3, d=d)
            assert (tuple(perm.shape), perm.dtype) == ((h, s), torch.int64)
    assert t_co.cluster_codes.launches == n0
    assert rec.counters.get("ckv.order_sets", 0) == 0


@pytest.mark.parametrize("d", [1, 2, 3])
def test_check_against_plain_accepts_the_plain_version(d):
    k = _keys(2, (2, 3), 200, 24)
    codes, y = t_co.embed_and_code(k, d)
    got = t_co.check_against_plain(k, codes, y, d)
    assert got == {"y_gap": 0.0, "codes_differ": 0.0}


def test_check_against_plain_accepts_codes_moved_at_cell_edges():
    """Projections moved within their tolerance, the codes taken again
    from them: the codes that change lie at cell edges, and pass."""
    k = _keys(3, (2, 2), 4000, 32)
    codes, y = t_co.embed_and_code(k, 3)
    scale = y.abs().amax(dim=(-2, -1), keepdim=True)
    gen = torch.Generator().manual_seed(3)
    y2 = y + 8e-6 * scale * (2 * torch.rand(y.shape, generator=gen) - 1)
    codes2 = morton_codes(y2, 10, device="cpu")
    got = t_co.check_against_plain(k, codes2, y2, 3)
    assert 0 < got["codes_differ"] < 0.01
    assert got["y_gap"] <= 1e-5


def _mirrored(codes, y):
    y = y.clone()
    y[..., 0] = -y[..., 0]
    return morton_codes(y, 10, device="cpu"), y


def _bumped(codes, y):
    # one point's first-axis cell moved by one: no longer the code of its
    # own projection
    codes = codes.clone()
    codes.view(-1)[7] ^= 1
    return codes, y


@pytest.mark.parametrize("wrong,match", [
    (_mirrored, "projections"),
    (lambda c, y: (c, y * (1 + 1e-4)), "projections"),
    (_bumped, "their own projections"),
    (lambda c, y: (c.roll(1, 0), y.roll(1, 0)), "projections"),
])
def test_check_against_plain_catches_a_wrong_kernel(wrong, match):
    """What a wrong kernel could hand back: a mirrored axis, projections
    off by 1e-4, a code that is not its projection's, another set's
    codes and projections."""
    k = _keys(4, (2, 3), 300, 24)
    codes, y = wrong(*t_co.embed_and_code(k, 3))
    with pytest.raises(AssertionError, match=match):
        t_co.check_against_plain(k, codes, y, 3)


def _householder_q(z):
    """float32 emulation of ``householder_q`` in ``csrc/cluster_order.cu``
    (LAPACK's geqr2 and org2r on a (m, d) matrix, one column at a time)."""
    f = np.float32
    a = z.astype(f).copy()
    m, d = a.shape
    for j in range(d):
        mx = np.abs(a[:, j]).max()
        if mx > 0:
            a[:, j] *= f(2.0 ** -np.frexp(mx)[1])
    tau = np.zeros(d, f)
    for j in range(d):
        alpha = a[j, j]
        xnorm = f(np.sqrt(f(np.sum(a[j + 1:, j] ** 2, dtype=f))))
        beta, t = alpha, f(0)
        if xnorm != 0:
            beta = f(np.hypot(alpha, xnorm))
            beta = -beta if alpha >= 0 else beta
            t = f((beta - alpha) / beta)
            a[j + 1:, j] *= f(1) / f(alpha - beta)
        tau[j] = t
        for k in range(j + 1, d):
            s = f(np.sum(a[j + 1:, j] * a[j + 1:, k], dtype=f) + a[j, k])
            a[j, k] += -t * s
            a[j + 1:, k] += (-t * s) * a[j + 1:, j]
        a[j, j] = beta
    for i in range(d - 1, -1, -1):
        for k in range(i + 1, d):
            s = f(np.sum(a[i + 1:, i] * a[i + 1:, k], dtype=f) + a[i, k])
            a[i, k] += -tau[i] * s
            a[i + 1:, k] += (-tau[i] * s) * a[i + 1:, i]
        a[i + 1:, i] *= -tau[i]
        a[i, i] = 1 - tau[i]
        a[:i, i] = 0
    return a


@pytest.mark.parametrize("seed,m,d", [(0, 96, 3), (1, 64, 2), (2, 128, 1),
                                      (3, 32, 3), (4, 96, 3)])
def test_householder_emulation_gives_lapacks_q(seed, m, d):
    """The kernel's QR, emulated in float32, against ``torch.linalg.qr``
    (LAPACK) on the CPU: the same Q, column signs included, under column
    scales far apart, zero rows at the end (the kernel's padding) and,
    for seed 4, a first column with nothing below its diagonal
    (``tau = 0``)."""
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((m, d)).astype(np.float32)
    z *= np.float32(10.0) ** rng.integers(-8, 8, d).astype(np.float32)
    z[m - 7:] = 0
    if seed == 4:
        z[1:, 0] = 0
        z[0, 0] = -3.0
    q = _householder_q(z)
    want = torch.linalg.qr(torch.from_numpy(z)).Q.numpy()
    np.testing.assert_allclose(q, want, rtol=0, atol=2e-6)
    assert (q[m - 7:] == 0).all()
    assert (np.sign(q.sum(0)) == np.sign(want.sum(0))).all()


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------


@pytest.mark.requires_cuda
@pytest.mark.parametrize("shape,want", [
    # minicpm3-4b's training cells: bf16 keys of 96, 40 heads
    ((40, 8192, 96, torch.bfloat16), (8, 1024, 1024, True)),
    ((160, 2048, 96, torch.bfloat16), (2, 1024, 1024, True)),
    # few sets: split further so that every SM has a block
    ((2, 4096, 64, torch.bfloat16), (8, 512, 512, True)),
    # a tiny set keeps one block
    ((1, 5, 96, torch.bfloat16), (1, 5, 5, True)),
    # too large for eight blocks' shared memory: streamed in chunks
    ((40, 16384, 96, torch.bfloat16), (8, 2048, 1037, False)),
    ((3, 5000, 96, torch.float32), (8, 625, 539, False)),
])
def test_layout_follows_the_shape(cuda_device, shape, want):
    """The layout the kernel chooses on the H100 (132 SMs, 227 KB of
    shared memory a block)."""
    n, s, dh, dtype = shape
    lay = t_co.layout(n, s, dh, dtype)
    assert (lay.cluster, lay.rows, lay.chunk, lay.resident) == want
    assert lay.rows * lay.cluster >= s
    optin = torch.cuda.get_device_properties(
        cuda_device).shared_memory_per_block_optin
    assert lay.smem <= optin


@pytest.mark.requires_cuda
@pytest.mark.parametrize("lead,s,dh,d,dtype", [
    ((1, 40), 8192, 96, 3, torch.bfloat16),    # minicpm3-4b train8k
    ((4, 40), 2048, 96, 3, torch.bfloat16),    # minicpm3-4b train2k
    ((2, 2), 4096, 64, 3, torch.bfloat16),     # Qwen2-0.5B's head dim
    ((1, 8), 4096, 128, 3, torch.bfloat16),    # llava / mistral's
    ((1, 4), 3968, 120, 3, torch.bfloat16),    # h2o-danube's 120
    ((3, 2), 1000, 64, 1, torch.float32),
    ((2, 3), 1500, 96, 2, torch.bfloat16),
    ((1, 5), 3001, 96, 3, torch.bfloat16),     # no block or cluster divides
    ((2, 2), 5, 96, 3, torch.float32),         # tiny
    ((1, 3), 5000, 96, 3, torch.float32),      # streamed in chunks
    ((1, 2), 8192, 128, 3, torch.float32),     # streamed, 128 wide
    ((2, 2), 64, 12, 3, torch.float32),        # 12 columns: no 16-byte rows
])
def test_cuda_cluster_codes_match_the_plain_version(cuda_device, lead, s, dh,
                                                    d, dtype):
    k = _keys(7, lead, s, dh, dtype).to(cuda_device)
    got = t_co.check_against_plain(k, *t_co.embed_and_code(k, d), d)
    assert got["codes_differ"] <= 0.02, got


@pytest.mark.requires_cuda
def test_cuda_cluster_codes_repeat_and_count(cuda_device):
    """The same codes from run to run (no atomics); one launch a call, the
    ``ckv.order_sets`` counter the sets ordered; ``cluster_perm`` a
    bijection of each set; strided keys as their contiguous copy."""
    k = _keys(8, (2, 6), 2048, 96, torch.bfloat16).to(cuda_device)
    n0 = t_co.cluster_codes.launches
    with trace.recording() as rec:
        a = t_ops.cluster_codes(k, 3)
        b = t_ops.cluster_codes(k, 3)
        perm = t_ckv.cluster_perm(k)
    torch.cuda.synchronize()
    assert t_co.cluster_codes.launches == n0 + 3
    assert rec.counters["ckv.order_sets"] == 3 * 12
    assert torch.equal(a, b)
    assert torch.equal(perm.sort(-1).values,
                       torch.arange(2048, device=cuda_device).expand(2, 6,
                                                                     2048))
    assert torch.equal(perm, torch.argsort(a, dim=-1, stable=True))
    kt = k.transpose(1, 2).contiguous().transpose(1, 2)   # (B, S, H, dh)
    assert not kt.is_contiguous()
    assert torch.equal(t_ops.cluster_codes(kt, 3), a)
    ya = t_co.embed_and_code(k, 3)[1]
    assert torch.equal(t_co.embed_and_code(k, 3)[1], ya)


@pytest.mark.requires_cuda
def test_cuda_cluster_codes_reject_wide_heads(cuda_device):
    k = torch.zeros((1, 1, 64, 160), device=cuda_device)
    with pytest.raises(ValueError, match="dh"):
        t_ops.cluster_codes(k, 3)
