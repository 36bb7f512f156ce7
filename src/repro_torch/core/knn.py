"""Blocked exact k-nearest-neighbor graph construction.

Builds the paper's near-neighbor interaction pattern (Eq. 1): column j is a
near neighbor of row i iff s_j is among the k nearest sources to target t_i.
Distances are computed block-by-block (a loop over query blocks) so memory
stays O(block * N) rather than O(N^2). The ``-2 q @ s^T`` product is a plain
large matrix product and goes to ``torch.matmul`` in full float32.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch._device import DeviceLike, from_numpy, resolve_device


def knn_graph(targets, sources, k: int, block: int = 1024,
              exclude_self: bool = False, valid=None,
              device: DeviceLike = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact kNN of each target among sources.

    Returns ``(idx (M, k) int64, dist2 (M, k) float32)``, squared euclidean
    distances, ascending. With ``exclude_self`` the diagonal (i == j) is
    excluded (source and target sets are the same point set). ``valid``
    (N,) bool restricts candidates to the masked sources.

    Ties: ``torch.topk`` promises no order among *exactly equal* distances
    (the reference breaks them to the lowest index); only duplicate points
    are affected.
    """
    dev = resolve_device(device)
    if dev.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "knn_graph needs full float32 matrix products: "
            "torch.backends.cuda.matmul.allow_tf32 must be False (TF32 "
            "keeps three digits and reorders near neighbors)")
    t = from_numpy(targets, dev, torch.float32)
    s = from_numpy(sources, dev, torch.float32)
    m = t.shape[0]
    n = s.shape[0]
    if k > n - int(exclude_self):
        raise ValueError(f"k={k} neighbors asked of {n} sources")
    s_norm = (s ** 2).sum(dim=1)
    s_t = s.T
    cols = torch.arange(n, device=dev)
    vmask = None if valid is None else ~from_numpy(valid, dev, torch.bool)
    idx_out, d2_out = [], []
    for base in range(0, m, block):
        q = t[base:base + block]
        d2 = ((q ** 2).sum(dim=1)[:, None] + s_norm[None, :]) \
            - 2.0 * (q @ s_t)
        if exclude_self:
            # masked_fill, not ``+ mask * inf``: 0 * inf is NaN
            rows = base + torch.arange(q.shape[0], device=dev)
            d2.masked_fill_(rows[:, None] == cols[None, :], float("inf"))
        if vmask is not None:
            d2.masked_fill_(vmask[None, :], float("inf"))
        dist, idx = torch.topk(d2, k, dim=1, largest=False, sorted=True)
        idx_out.append(idx)
        d2_out.append(dist)
    idx = torch.cat(idx_out)
    dist2 = torch.cat(d2_out).clamp_min_(0.0)
    return idx, dist2


def knn_coo(targets, sources, k: int, block: int = 1024,
            exclude_self: bool = False, valid=None,
            device: DeviceLike = None):
    """kNN graph as COO (rows, cols, dist2) tensors, row-major."""
    idx, dist2 = knn_graph(targets, sources, k, block, exclude_self, valid,
                           device)
    m = idx.shape[0]
    rows = torch.arange(m, device=idx.device).repeat_interleave(k)
    return rows, idx.reshape(-1), dist2.reshape(-1)
