"""Patch-density measures (paper §2.2–2.3).

``beta_estimate``  — lower bound of the combinatorial patch-density measure
    beta(A) (Eq. 2) obtained from a family of feasible patch coverings:
    uniform b x b grid tiles shrunk to the bounding box of their nonzeros
    (disjoint by construction), maximized over b. Exact beta is NP-hard
    (paper §2.3); any feasible covering lower-bounds it.

``gamma_exact`` / ``gamma_score`` — the numerical relaxation (Eq. 4):
    gamma(A; sigma) = 1/(sigma nnz) * sum_{p,q in Inz} exp(-|p-q|^2/sigma^2).
    ``gamma_exact`` is the O(nnz^2) literal sum; ``gamma_score`` bins the
    nonzero coordinates into sigma-sized cells and evaluates the double sum
    by a truncated Gaussian stencil — O(nnz + cells) with error only from
    within-cell quantization.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import DeviceLike, device_of, from_numpy

# ---------------------------------------------------------------------------
# gamma score (Eq. 4)
# ---------------------------------------------------------------------------

_DENSE_MAX_NNZ = 2048     # above this gamma_exact routes to the tiled kernel


def _gamma_exact_dense(rows: torch.Tensor, cols: torch.Tensor,
                       sigma: float) -> torch.Tensor:
    p = torch.stack([rows, cols], dim=1).to(torch.float32)
    d2 = ((p[:, None, :] - p[None, :, :]) ** 2).sum(-1)
    return torch.exp(-d2 / sigma**2).sum() / (sigma * rows.shape[0])


def gamma_exact(rows, cols, sigma: float, bn: int = 256,
                tiled: "bool | None" = None,
                device: DeviceLike = None) -> torch.Tensor:
    """Exact Eq. 4 over all nnz^2 pairs.

    Small patterns evaluate the literal dense (nnz, nnz) sum; large ones
    route to the tiled kernel (``kernels.ops.gamma_exact``), whose working
    set is O(bn^2) instead of O(nnz^2). ``tiled`` forces the choice
    (None = auto at nnz > 2048).
    """
    dev = device_of(rows, device)
    nnz = len(rows)
    if nnz == 0:                             # empty pattern: no mass, not NaN
        return torch.zeros((), dtype=torch.float32, device=dev)
    if tiled is None:
        tiled = nnz > _DENSE_MAX_NNZ
    if tiled:
        from repro_torch.kernels.ops import gamma_exact as _tiled_gamma
        return _tiled_gamma(rows, cols, float(sigma), bn, device=dev)
    return _gamma_exact_dense(from_numpy(rows, dev), from_numpy(cols, dev),
                              float(sigma))


def _gauss_stencil(sigma: float, cell: float, radius_cells: int,
                   device: torch.device) -> torch.Tensor:
    r = radius_cells
    ax = torch.arange(-r, r + 1, dtype=torch.float32, device=device) * cell
    d2 = ax[:, None] ** 2 + ax[None, :] ** 2
    return torch.exp(-d2 / sigma**2)


def gamma_score(rows, cols, sigma: float, n: int, cells: int = 0,
                radius_cells: int = 4, weights=None,
                device: DeviceLike = None) -> torch.Tensor:
    """Histogram/stencil estimate of Eq. 4.

    Bins nonzeros into a (G, G) grid with cell size ~sigma (so the Gaussian
    is well resolved), then sum_{p,q} exp ~= <h, g * h> with g the truncated
    stencil. ``weights`` (same length as rows) lets callers carry
    zero-weight entries without perturbing the score.

    The stencil is applied as (2r+1)^2 shifted adds in float32, not as a
    library convolution: on a CUDA device that would run in TF32 by default
    (three digits — enough to reorder gamma comparisons between orderings).
    """
    dev = device_of(rows, device)
    nnz = len(rows)
    if nnz == 0:                             # empty pattern: no mass, not NaN
        return torch.zeros((), dtype=torch.float32, device=dev)
    g = cells or max(8, min(2048, int(np.ceil(n / max(sigma, 1.0)))))
    cell = n / g
    ri = torch.clamp((from_numpy(rows, dev, torch.float32) / cell
                      ).to(torch.int64), 0, g - 1)
    ci = torch.clamp((from_numpy(cols, dev, torch.float32) / cell
                      ).to(torch.int64), 0, g - 1)
    if weights is None:
        w = torch.ones(nnz, dtype=torch.float32, device=dev)
        denom = float(nnz)
    else:
        w = from_numpy(weights, dev, torch.float32)
        denom = w.sum()
    hist = torch.zeros(g * g, dtype=torch.float32, device=dev)
    hist = hist.index_add_(0, ri * g + ci, w).view(g, g)
    stencil = _gauss_stencil(float(sigma), cell, radius_cells, dev).tolist()
    r = radius_cells
    padded = torch.nn.functional.pad(hist, (r, r, r, r))
    smooth = torch.zeros_like(hist)
    for dy in range(2 * r + 1):
        for dx in range(2 * r + 1):
            smooth.add_(padded[dy:dy + g, dx:dx + g], alpha=stencil[dy][dx])
    return (hist * smooth).sum() / (float(sigma) * denom)


# ---------------------------------------------------------------------------
# beta estimate (Eq. 2 lower bound from feasible grid coverings)
# ---------------------------------------------------------------------------


def beta_estimate(rows: np.ndarray, cols: np.ndarray, n: int,
                  block_sizes=(4, 8, 16, 20, 32, 64, 128)) -> dict:
    """Best feasible patch covering over a family of shrunk grid coverings.

    For each tile size b: tiles of the uniform b-grid that contain nonzeros
    become patches, each shrunk to the bounding box of its nonzeros (still
    disjoint). score(b) = (1/count) * nnz / sum(bbox areas). Returns the max
    and the per-b scores.
    """
    rows = np.asarray(rows)
    cols = np.asarray(cols)
    nnz = len(rows)
    if nnz == 0:
        return {"beta": 0.0, "block": None, "per_block": {}}
    out = {}
    best = 0.0
    best_b = None
    for b in block_sizes:
        if b > n:
            continue
        rb, cb = rows // b, cols // b
        tid = rb.astype(np.int64) * ((n + b - 1) // b) + cb
        order = np.argsort(tid, kind="stable")
        tid_s = tid[order]
        bnd = np.concatenate([[0], np.nonzero(np.diff(tid_s))[0] + 1, [nnz]])
        count = len(bnd) - 1
        r_s, c_s = rows[order], cols[order]
        area = 0
        for t in range(count):
            lo, hi = bnd[t], bnd[t + 1]
            rr = r_s[lo:hi]
            cc = c_s[lo:hi]
            area += (rr.max() - rr.min() + 1) * (cc.max() - cc.min() + 1)
        score = (1.0 / count) * nnz / area
        out[b] = score
        if score > best:
            best, best_b = score, b
    return {"beta": best, "block": best_b, "per_block": out}


def fill_ratio(rows: np.ndarray, cols: np.ndarray, n: int, b: int) -> float:
    """nnz / area of the uniform-b covering — density of the kept tiles.

    An empty pattern covers no tiles: its fill is 0 (never a division by
    zero).
    """
    rows = np.asarray(rows)
    cols = np.asarray(cols)
    if len(rows) == 0:
        return 0.0
    rb, cb = rows // b, cols // b
    tid = rb.astype(np.int64) * ((n + b - 1) // b) + cb
    count = len(np.unique(tid))
    return len(rows) / (count * b * b)


def compact_live(rows: np.ndarray, cols: np.ndarray,
                 alive_in_order: np.ndarray):
    """Project a cluster-order pattern onto the live rows only.

    Plans that hold tombstoned slots have holes in their cluster positions;
    scoring γ on the holey coordinates would misread the hole spacing as
    (lack of) locality. Drops every edge touching a dead slot and renumbers
    both coordinates to the rank among live slots. Returns
    ``(rows', cols', n_alive)``.
    """
    alive_in_order = np.asarray(alive_in_order, bool)
    rows = np.asarray(rows)
    cols = np.asarray(cols)
    keep = alive_in_order[rows] & alive_in_order[cols]
    rank = np.cumsum(alive_in_order) - 1
    return rank[rows[keep]], rank[cols[keep]], int(alive_in_order.sum())


# ---------------------------------------------------------------------------
# drift monitoring (plan refresh lifecycle)
# ---------------------------------------------------------------------------


def gamma_drift(gamma_ref: "float | None",
                gamma_now: "float | None") -> float:
    """Relative γ degradation since ``gamma_ref`` (positive = locality got
    worse). Returns 0 when either score is missing or the reference is 0,
    so drift checks are safe on unscored / empty / single-block plans."""
    if gamma_ref is None or gamma_now is None or gamma_ref == 0:
        return 0.0
    return float((gamma_ref - gamma_now) / abs(gamma_ref))


def fill_drift(fill_ref: "float | None", fill_now: "float | None") -> float:
    """Relative fill degradation since ``fill_ref`` (positive = storage got
    emptier). Same None/zero-safety as :func:`gamma_drift`."""
    if fill_ref is None or fill_now is None or fill_ref == 0:
        return 0.0
    return float((fill_ref - fill_now) / abs(fill_ref))
