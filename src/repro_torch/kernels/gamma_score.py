"""Exact gamma-score (paper Eq. 4) pair sum: CUDA kernel and plain version.

Counterpart of the reference's ``kernels/gamma_score.py`` (Pallas, TPU).

gamma(A; sigma) = 1/(sigma nnz) * sum_{p,q in Inz} exp(-|p-q|^2 / sigma^2)
over the nonzero coordinates. ``gamma_pairs`` returns the raw (weighted)
pair sum; divide by ``sigma * nnz`` (or the weight mass) for the score.

* ``weights`` — each pair contributes ``w_p * w_q * exp(...)``; zero-weight
  entries pad the coordinate list to a tile multiple without perturbing
  the sum.
* ``symmetric=True`` — only tile pairs ``(i, j <= i)`` are evaluated and
  off-diagonal tiles count twice.

The kernel (``csrc/gamma_pairs.cu``) takes each term as
``w_q * 2^-(dx'^2 + dy'^2)`` over coordinates prescaled by
:func:`exp2_scale` (the exponential on the special-function units), writes
one partial per tile pair and reduces them in a fixed order, so the result
is reproducible bit for bit.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build


def exp2_scale(sigma: float) -> float:
    """The factor the kernel multiplies the coordinates by, so that
    ``exp(-d^2 / sigma^2) = 2^-(d * exp2_scale(sigma))^2``."""
    return math.sqrt(math.log2(math.e)) / sigma


def gamma_pairs_plain(coords: torch.Tensor, sigma: float, bn: int = 256,
                      *, weights: torch.Tensor | None = None,
                      symmetric: bool = False) -> torch.Tensor:
    """Plain version: the dense pair sum chunked over (bn, n) row tiles, so
    it never holds n^2 floats. ``symmetric`` follows the kernel's schedule
    (lower tile triangle, off-diagonal tiles twice)."""
    n = coords.shape[0]
    c = coords.to(torch.float32)
    w = (torch.ones(n, dtype=torch.float32, device=c.device)
         if weights is None else weights.to(torch.float32))
    total = torch.zeros((), dtype=torch.float64, device=c.device)
    for r0 in range(0, n, bn):
        hi = r0 + bn if symmetric else n
        a, b = c[r0:r0 + bn], c[:hi]
        d2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
        t = w[r0:r0 + bn, None] * w[None, :hi] * torch.exp(
            -d2 / (sigma * sigma))
        if symmetric:
            total += 2.0 * t[:, :r0].sum(dtype=torch.float64)
            total += t[:, r0:].sum(dtype=torch.float64)
        else:
            total += t.sum(dtype=torch.float64)
    return total.to(torch.float32)


def gamma_pairs(coords: torch.Tensor, sigma: float, bn: int = 256,
                *, weights: torch.Tensor | None = None,
                symmetric: bool = False) -> torch.Tensor:
    """coords (n, 2) float32 (row, col) of nonzeros with n a multiple of
    ``bn`` (pad with zero-weight rows). Returns the raw pair sum, a float32
    scalar tensor on the coordinates' device."""
    if coords.ndim != 2 or coords.shape[1] != 2:
        raise ValueError(f"coords must be (n, 2), got {tuple(coords.shape)}")
    n = coords.shape[0]
    if n % bn:
        raise ValueError(f"n={n} is not a multiple of bn={bn}; pad with "
                         "zero-weight entries")
    if not sigma > 0:
        raise ValueError(f"sigma must be positive, got {sigma}")
    if weights is None:
        weights = torch.ones(n, dtype=torch.float32, device=coords.device)
    if tuple(weights.shape) != (n,):
        raise ValueError(f"weights must be ({n},), got {tuple(weights.shape)}")
    if coords.dtype != torch.float32 or weights.dtype != torch.float32:
        raise TypeError("coords and weights must be float32")
    if coords.device != weights.device:
        raise ValueError("coords and weights must share one device")
    if coords.device.type != "cuda":
        return gamma_pairs_plain(coords, sigma, bn, weights=weights,
                                 symmetric=symmetric)
    if bn % 32 or not 32 <= bn <= 1024:
        raise ValueError(f"the CUDA kernel needs bn a multiple of 32 in "
                         f"[32, 1024], got {bn}")
    if not (coords.is_contiguous() and weights.is_contiguous()):
        raise ValueError("the CUDA kernel needs contiguous tensors")
    if coords.data_ptr() % 8:
        raise ValueError("the CUDA kernel needs 8-byte aligned coordinates")
    nb = n // bn
    count = nb * (nb + 1) // 2 if symmetric else nb * nb
    partials = torch.empty(max(count, 1), dtype=torch.float32,
                           device=coords.device)
    out = torch.empty((), dtype=torch.float32, device=coords.device)
    with torch.cuda.device(coords.device):
        code = _build.load().repro_gamma_pairs(
            coords.data_ptr(), weights.data_ptr(), partials.data_ptr(),
            out.data_ptr(), n, bn, exp2_scale(sigma), int(symmetric),
            _build.current_stream())
    _build.check(code, "gamma_pairs")
    gamma_pairs.launches += 1
    return out


gamma_pairs.launches = 0
