"""Plain reference of the interaction plan's product, row by row.

For a target row i of the point set x (n, D), the plan's matrix holds
``v_ij = exp(-|x_i - x_j|^2 / h)`` at the k nearest other points j, and
``(A X)_i = sum_j v_ij X_j``. This module recomputes that from the points
alone, in float64, for a sample of rows: the exact kNN by brute force
against every point, the values, the sum. It imports nothing of the
program.

A row whose (k+1)-th nearest distance lies within ``tie_rel x (|x_i|^2 +
|x_k|^2)`` of its k-th is a near tie: float32 arithmetic, which the
configuration states, may pick either point, so such a row has two right
answers and is not sampled (``checkable``).

``tf32=True`` is the control: the distances' matrix product taken from
operands rounded to TF32 (10 mantissa bits), as a card computes it with
TF32 on, and the rest in float32.
"""
from __future__ import annotations

from typing import Tuple

import torch


def round_tf32(a: torch.Tensor) -> torch.Tensor:
    """float32 rounded to the nearest TF32 value (ties to even)."""
    bits = a.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    bits = (bits + 0xFFF + lsb) & ~0x1FFF
    return bits.view(torch.float32)


def neighbors(x: torch.Tensor, rows: torch.Tensor, k: int, *,
              tf32: bool = False, block: int = 256
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                         torch.Tensor]:
    """The k nearest other points of ``x[rows]`` among all of ``x``.

    Returns ``(idx (m, k), d2 (m, k), gap (m,), scale (m,))``: indices and
    squared distances in ascending order, the distance from the k-th to
    the (k+1)-th neighbor, and ``|x_i|^2 + |x_k|^2``."""
    if tf32:
        xw = x.float()
        xn = (xw * xw).sum(1)
        xt = round_tf32(xw).double()
    else:
        xw = x.double()
        xn = (xw * xw).sum(1)
        xt = xw
    idx_out, d2_out, gap_out, sc_out = [], [], [], []
    for i in range(0, rows.numel(), block):
        r = rows[i:i + block]
        dot = xt[r] @ xt.T
        if tf32:
            dot = dot.float()
        d2 = xn[r][:, None] + xn[None, :] - 2.0 * dot
        d2[torch.arange(r.numel(), device=x.device), r] = float("inf")
        val, idx = torch.topk(d2, k + 1, dim=1, largest=False, sorted=True)
        idx_out.append(idx[:, :k])
        d2_out.append(val[:, :k].double().clamp_min(0.0))
        gap_out.append((val[:, k] - val[:, k - 1]).double())
        sc_out.append((xn[r] + xn[idx[:, k - 1]]).double())
    return (torch.cat(idx_out), torch.cat(d2_out), torch.cat(gap_out),
            torch.cat(sc_out))


def checkable(x: torch.Tensor, candidates: torch.Tensor, k: int,
              tie_rel: float, count: int) -> torch.Tensor:
    """The first ``count`` of ``candidates`` that are no near tie."""
    _, _, gap, scale = neighbors(x, candidates, k)
    ok = gap > tie_rel * scale
    return candidates[ok][:count]


def product_rows(idx: torch.Tensor, d2: torch.Tensor, charges: torch.Tensor,
                 bandwidth: float) -> torch.Tensor:
    """``(A X)[rows]`` (m, f) float64 for charges ``X`` (n, f), from the
    rows' neighbors ``(idx, d2)`` as :func:`neighbors` gives them."""
    v = torch.exp(-d2 / bandwidth)
    return torch.einsum("mk,mkf->mf", v, charges.double()[idx])


def rel_error(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest absolute gap over the largest reference entry."""
    scale = float(want.abs().max())
    return float((got.double() - want).abs().max()) / max(scale, 1e-300)
