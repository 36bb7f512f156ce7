"""Low-dimensional embedding with data-specific principal feature axes.

Paper §2.4 "Low-dimensional embedding": an economic truncated SVD/PCA onto
the top-d principal axes of the (centered) feature array. We use subspace
(block power) iteration — d matvec-sweeps per iteration, never forming the
full SVD — which is the "economic-sparse version" the paper calls for.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch._device import (DeviceLike, device_of, from_numpy,
                                 resolve_device)


def _subspace_iterate(xc: torch.Tensor, q: torch.Tensor,
                      iters: int) -> torch.Tensor:
    for _ in range(iters):
        z = xc.mT @ (xc @ q)            # (..., D, d): one sweep
        q, _ = torch.linalg.qr(z)
    return q


def pca_axes(x, d: int, iters: int = 8, init=None,
             device: DeviceLike = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-``d`` principal axes of ``x`` (N, D).

    Returns ``(axes (D, d), explained (d,))`` where ``explained`` holds the
    singular values of the centered data restricted to the subspace.
    ``init`` (D, d) is the start of the subspace iteration (default: numpy
    ``default_rng(0)`` normal draws), so two implementations handed the
    same start walk the same subspace; QR column signs may still differ
    between LAPACK and cuSOLVER, so compare axes up to sign.
    """
    dev = resolve_device(device)
    x = from_numpy(x, dev, torch.float32)
    dim = x.shape[1]
    xc = x - x.mean(dim=0, keepdim=True)
    if init is None:
        init = np.random.default_rng(0).standard_normal((dim, d))
    q = from_numpy(init, dev, torch.float32)
    if tuple(q.shape) != (dim, d):
        raise ValueError(f"init must be ({dim}, {d}), got {tuple(q.shape)}")
    q, _ = torch.linalg.qr(q)
    q = _subspace_iterate(xc, q, iters)
    # Rayleigh-Ritz for singular values in the subspace
    b = xc @ q                           # (N, d)
    s = torch.sqrt((b * b).sum(dim=0))
    order = torch.argsort(-s)
    return q[:, order], s[order]


def explained_ratio(x, s, device: DeviceLike = None) -> torch.Tensor:
    """Paper's tolerance ratio: sum_i sigma_i^2 / ||X||_F^2 (centered)."""
    dev = resolve_device(device)
    x = from_numpy(x, dev, torch.float32)
    s = from_numpy(s, dev, torch.float32)
    xc = x - x.mean(dim=0, keepdim=True)
    return (s ** 2).sum() / (xc * xc).sum()


def embed(x, d: int, iters: int = 8, init=None,
          device: DeviceLike = None) -> torch.Tensor:
    """Project ``x`` (N, D) onto its top-``d`` principal axes -> (N, d)."""
    dev = resolve_device(device)
    x = from_numpy(x, dev, torch.float32)
    axes, _ = pca_axes(x, d, iters, init, dev)
    return (x - x.mean(dim=0, keepdim=True)) @ axes


def pca_map(x, d: int, iters: int = 8, init=None,
            device: DeviceLike = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The affine embedding map itself: ``(mean (D,), axes (D, d))``.

    ``apply_pca_map(x, mean, axes) == embed(x, d)`` for the fitting data;
    plans store the map so that *moved* points re-embed into the same
    coordinate frame.
    """
    dev = resolve_device(device)
    x = from_numpy(x, dev, torch.float32)
    axes, _ = pca_axes(x, d, iters, init, dev)
    return x.mean(dim=0), axes


def apply_pca_map(x, mean, axes, device: DeviceLike = None) -> torch.Tensor:
    """Project ``x`` with a previously fitted :func:`pca_map`."""
    dev = resolve_device(device)
    x = from_numpy(x, dev, torch.float32)
    mean = from_numpy(mean, dev, torch.float32)
    axes = from_numpy(axes, dev, torch.float32)
    return (x - mean[None, :]) @ axes


def pca_project_det(x, d: int, iters: int = 4,
                    device: DeviceLike = None) -> torch.Tensor:
    """Top-``d`` principal projection with a deterministic start: the same
    subspace iteration as :func:`pca_axes`, seeded from the first ``d``
    coordinate axes instead of random draws.

    ``x`` is one set (N, D) or a batch of sets (..., N, D), each projected
    onto its own axes (the per-head embedding step of ClusterKV attention,
    ``core.clusterkv.cluster_perm``). A tensor is projected on its own
    device unless ``device`` says otherwise."""
    dev = device_of(x, device)
    x = from_numpy(x, dev, torch.float32)
    dh = x.shape[-1]
    xc = x - x.mean(dim=-2, keepdim=True)
    q = torch.eye(dh, d, dtype=torch.float32, device=dev)
    q = q.expand(tuple(x.shape[:-2]) + (dh, d))
    return xc @ _subspace_iterate(xc, q, iters)
