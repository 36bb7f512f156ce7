"""ClusterKV's key ordering: each key set's embedding and Morton codes, the
hand-written CUDA kernel and its plain version.

The reference has no kernel here: its ``core/clusterkv.cluster_perm``
embeds each (batch, head) key set on its top-``d`` principal axes
(``_pca_project``: subspace iteration with a QR after each sweep) and codes
it with ``core/hierarchy.morton_codes``, in XLA ops. The plain version is
the port's ``core.embedding.pca_project_det`` followed by
``core.hierarchy.morton_codes``. On the card its batched
``torch.linalg.qr`` runs one small factorization per matrix, driven from
the host, so the ordering held the card idle; ``csrc/cluster_order.cu``
does the mean, every sweep, each QR (LAPACK's Householder convention, so
the axes' signs are the plain version's), the projection, the box and the
codes in one launch.

For a tensor on the CPU :func:`cluster_codes` returns the plain version;
for a CUDA tensor it runs the opaque op
``torch.ops.repro_torch.cluster_codes`` (``kernels/library.py``), whose
``CUDA`` implementation :func:`launch` launches the kernel, or raises. The
kernel chooses its layout from the shape and the card (:func:`layout`
reports it). It counts its launches in ``cluster_codes.launches`` and,
while a ``repro_torch.trace`` recording is open, the key sets it ordered
in the counter ``ckv.order_sets``. :func:`check_against_plain` holds its
codes and projections against the plain version (the card tests,
``chip_smoke.py``'s phase 2 and ``tools/time_cluster_order.py``).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch import trace
from repro_torch.core.embedding import pca_project_det
from repro_torch.core.hierarchy import MAX_BITS, eff_bits, morton_codes
from repro_torch.kernels import _build
from repro_torch.kernels.library import LIB

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_DH = 128


class Layout(NamedTuple):
    cluster: int      # blocks a key set (one thread-block cluster)
    rows: int         # rows a block
    chunk: int        # rows a block holds in shared memory at once
    smem: int         # dynamic shared memory a block, bytes
    resident: bool    # chunk == rows: the keys are read from memory once


def layout(n_sets: int, s: int, dh: int, dtype: torch.dtype) -> Layout:
    """The layout the kernel takes on the current CUDA device for
    ``n_sets`` key sets of ``s`` rows x ``dh`` of ``dtype``, as
    ``csrc/cluster_order.cu`` chooses it from the shape and the card
    (``repro_cluster_layout``; nothing is launched): the fewest blocks a
    set whose shared memory holds its rows, raised until every SM has a
    block; a set too large for one cluster is streamed."""
    out = (ctypes.c_int * 4)()
    _build.check(_build.load().repro_cluster_layout(
        n_sets, s, dh, DTYPES[dtype], ctypes.addressof(out)),
        "cluster_codes layout")
    cluster, rows, chunk, smem = out
    return Layout(cluster, rows, chunk, smem, chunk == rows)


def cluster_codes_plain(k: torch.Tensor, d: int, bits: int,
                        iters: int = 4) -> torch.Tensor:
    """Plain version: ``morton_codes(pca_project_det(k, d, iters), bits)``
    per (..., S, dh) set -> (..., S) int64."""
    s, dh = k.shape[-2:]
    flat = k.reshape((-1, s, dh))
    y = pca_project_det(flat, d, iters, device=k.device)
    return morton_codes(y, bits, device=k.device).reshape(k.shape[:-1])


def cluster_codes(k: torch.Tensor, d: int, bits: int = 10,
                  iters: int = 4) -> torch.Tensor:
    """Morton codes (..., S) int64 of each (..., S, dh) key set embedded on
    its own top-``d`` principal axes (``iters`` subspace sweeps from the
    first ``d`` coordinate axes), ``bits`` per axis (capped as
    ``morton_codes`` caps them). No gradient flows through codes."""
    if k.dim() < 2:
        raise ValueError(f"keys must be (..., S, dh), got {tuple(k.shape)}")
    if d not in MAX_BITS:
        raise ValueError(f"morton codes support d<=3, got d={d}")
    if k.device.type != "cuda":
        return cluster_codes_plain(k, d, bits, iters)
    codes = torch.ops.repro_torch.cluster_codes(_prepare(k, d),
                                                d, eff_bits(d, bits), iters)
    return codes.reshape(k.shape[:-1])


def _prepare(k: torch.Tensor, d: int) -> torch.Tensor:
    """``k`` (..., S, dh) as the kernel takes it: (A, B, S, dh), float32 or
    bfloat16, each row contiguous, no autograd history."""
    s, dh = k.shape[-2:]
    if not d <= dh <= MAX_DH:
        raise ValueError(f"the CUDA kernel takes {d} <= dh <= {MAX_DH}, got "
                         f"dh={dh}")
    kk = k.detach()
    if kk.dtype not in DTYPES:
        kk = kk.float()
    if kk.stride(-1) != 1:
        kk = kk.contiguous()
    lead = tuple(k.shape[:-2])
    if len(lead) < 2:
        return kk.reshape((1,) * (2 - len(lead)) + tuple(kk.shape))
    if len(lead) > 2:
        return kk.reshape((-1,) + tuple(kk.shape[-3:]))
    return kk


def launch(k: torch.Tensor, d: int, bits: int, iters: int,
           y: torch.Tensor | None = None) -> torch.Tensor:
    """The ``CUDA`` implementation of ``repro_torch::cluster_codes``: one
    launch of ``csrc/cluster_order.cu`` on the current stream. ``k`` is
    (A, B, S, dh) float32 or bfloat16, any strides with each row
    contiguous; ``bits`` is already capped. Returns (A, B, S) int64;
    ``y`` (A, B, S, d) float32 contiguous, if given, receives the
    projections the codes were taken from."""
    a, b, s, dh = k.shape
    out = torch.empty((a, b, s), dtype=torch.int64, device=k.device)
    n = a * b
    if n == 0 or s == 0:
        return out
    with torch.cuda.device(k.device):
        code = _build.load().repro_cluster_codes(
            k.data_ptr(), out.data_ptr(), None if y is None else y.data_ptr(),
            n, b, k.stride(0), k.stride(1), k.stride(2), s, dh, d, bits,
            iters, DTYPES[k.dtype], _build.current_stream())
    _build.check(code, "cluster_codes")
    cluster_codes.launches += 1
    trace.count("ckv.order_sets", n)
    return out


def embed_and_code(k: torch.Tensor, d: int, bits: int = 10,
                   iters: int = 4):
    """``(codes (..., S) int64, y (..., S, d) float32)`` of a (..., S, dh)
    key tensor: the codes and the projections they were taken from, from
    one launch on a CUDA tensor, from the plain version on a CPU tensor
    (:func:`check_against_plain` holds the two against each other)."""
    s, dh = k.shape[-2:]
    lead = tuple(k.shape[:-1])
    if k.device.type != "cuda":
        y = pca_project_det(k.reshape((-1, s, dh)), d, iters,
                            device=k.device)
        return (morton_codes(y, bits, device=k.device).reshape(lead),
                y.reshape(lead + (d,)))
    kk = _prepare(k, d)
    y = torch.empty(tuple(kk.shape[:-1]) + (d,), dtype=torch.float32,
                    device=k.device)
    codes = launch(kk, d, eff_bits(d, bits), iters, y)
    return codes.reshape(lead), y.reshape(lead + (d,))


def _cells(codes: torch.Tensor, d: int, bits: int) -> torch.Tensor:
    """Each axis's cell (..., S, d) of Morton codes, on the CPU."""
    c = codes.cpu()
    return torch.stack([sum(((c >> (d * bit + axis)) & 1) << bit
                            for bit in range(bits)) for axis in range(d)],
                       dim=-1)


def check_against_plain(k: torch.Tensor, codes: torch.Tensor,
                        y: torch.Tensor, d: int, bits: int = 10,
                        iters: int = 4) -> dict:
    """Hold ``codes`` (..., S) and the projections ``y`` (..., S, d) they
    were taken from, for the keys ``k`` (..., S, dh), against the plain
    version on the same keys, and raise ``AssertionError`` where they
    part: ``y`` within 1e-5 of each set's largest ``|y_plain|`` (the sums
    run in another order); ``codes`` exactly ``morton_codes(y)``; against
    the plain codes each axis's cell off by at most one, and only where
    the plain coordinate lies within the projections' gap of a cell edge
    (ROADMAP C31). Returns ``y_gap`` (the largest gap over its set's
    largest ``|y_plain|``) and ``codes_differ`` (the share of codes unlike
    the plain version's)."""
    s, dh = k.shape[-2:]
    b = eff_bits(d, bits)
    yp = pca_project_det(k.reshape((-1, s, dh)), d, iters,
                         device=k.device).reshape(y.shape).double()
    y = y.double()
    scale = yp.abs().amax(dim=(-2, -1), keepdim=True)
    gap = (y - yp).abs().amax(dim=(-2, -1), keepdim=True)
    y_gap = float((gap / scale.clamp_min(1e-30)).max())
    if not (gap <= 1e-5 * scale).all():
        raise AssertionError(f"cluster_codes: projections {y_gap:.3e} of "
                             "their scale from the plain version's")
    if not torch.equal(codes.cpu(), morton_codes(y.float().cpu(), b,
                                                 device="cpu")):
        raise AssertionError("cluster_codes: codes are not the Morton "
                             "codes of their own projections")
    # the plain coordinate (y - lo) / span * (2^b - 1), in float64
    lo = yp.amin(-2, keepdim=True)
    span = (yp.amax(-2, keepdim=True) - lo).clamp_min(1e-30)
    t = ((yp - lo) / span * (2 ** b - 1)).cpu()
    tol = (4 * gap / span * (2 ** b - 1) + 1e-4).cpu().expand(t.shape)
    want = morton_codes(yp.float(), b, device=k.device)
    off = _cells(codes, d, b) - _cells(want, d, b)
    edge = (t - t.round()).abs()
    moved = off != 0
    if (off.abs() > 1).any() or (edge[moved] > tol[moved]).any():
        raise AssertionError("cluster_codes: a code differs from the plain "
                             "version's away from a cell edge")
    return {"y_gap": y_gap,
            "codes_differ": float((codes.cpu() != want.cpu()).double()
                                  .mean())}


def _fake(k, d: int, bits: int, iters: int) -> torch.Tensor:
    """The output's shape, dtype and device; no data is read."""
    return k.new_empty(tuple(k.shape[:-1]), dtype=torch.int64)


cluster_codes.launches = 0
LIB.impl("cluster_codes", launch, "CUDA")
torch.library.register_fake("repro_torch::cluster_codes", _fake, lib=LIB)
