"""Multi-level near-neighbor interaction computations (paper §2.4).

The interaction ``y = A x`` is computed block-by-block: every kept tile is a
dense (bs, bs) block multiplying a contiguous charge segment — the paper's
"block-segment multiplication". The paths here are the port's **plain
PyTorch reference paths**; they stand beside the hand-written CUDA kernel
(``kernels/bsr_spmv.py``, registered as ``cuda`` by ``kernels/ops.py``) and
run on any device:

  spmv_csr      element-wise gather baseline (scattered/CSR semantics)
  spmv_bsr      flat single-level block path (one einsum over kept tiles)
  spmv_bsr_ml   multi-level path: a loop over row-superblocks so the
                working set per step is a superblock stripe

Published through the backend registry (``core.registry``) under the names
``csr`` / ``bsr`` / ``bsr_ml``; prefer ``repro_torch.api`` plans over
calling them directly.

Iterative-application value updates (t-SNE attractive force, mean shift)
are computed *blockwise dense* from the current coordinates, as in the
reference, but in chunks of row blocks: the ``(rows, nbr, bs, bs, d)``
pairwise-difference tensor of one chunk stays under ``CHUNK_BYTES``. At
the paper's sizes the unchunked tensor would take 10 GB (t-SNE, d = 2) to
200 GB (mean shift, D = 128). The t-SNE force has a hand-written kernel
(``kernels/tsne_force.py``); these are its plain paths.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.registry import register_backend, register_batched_backend
from repro_torch.kernels.ref import drop_masked_slots


# ---------------------------------------------------------------------------
# SpMV paths
# ---------------------------------------------------------------------------


def spmv_csr(vals: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor,
             x: torch.Tensor, n: int | None = None) -> torch.Tensor:
    """Gather-based SpMV over COO/CSR edges: y_i = sum_j a_ij x_j.

    ``index_add_`` adds with atomics on a CUDA device, so the summation
    order — and the last bits of the result — change from run to run;
    compare against it with a max-abs tolerance (1e-4 at unit-scale
    charges), never bitwise."""
    n = n if n is not None else x.shape[0]
    y = torch.zeros((n,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    contrib = vals.reshape((-1,) + (1,) * (x.ndim - 1)) * x[cols]
    return y.index_add_(0, rows, contrib)


def _pad_rows(x: torch.Tensor, rows: int, axis: int = 0) -> torch.Tensor:
    """Zero-pad ``x`` along ``axis`` up to ``rows`` entries."""
    pad = rows - x.shape[axis]
    if pad <= 0:
        return x
    spec = [0, 0] * (x.ndim - 1 - axis) + [0, pad]
    return F.pad(x, spec)


def spmv_bsr(bsr_vals: torch.Tensor, col_idx: torch.Tensor, x: torch.Tensor,
             n: int) -> torch.Tensor:
    """Flat block path. bsr_vals (n_rb, nbr, bs, bs); x (n,) or (n, f)."""
    n_rb, nbr, bs, _ = bsr_vals.shape
    squeeze = x.ndim == 1
    if squeeze:
        x = x[:, None]
    xb = _pad_rows(x, n_rb * bs).reshape(n_rb, bs, -1)   # (n_cb, bs, f)
    seg = xb[col_idx.long()]                              # (n_rb, nbr, bs, f)
    y = torch.einsum("rnij,rnjf->rif", bsr_vals, seg)
    y = y.reshape(n_rb * bs, -1)[:n]
    return y[:, 0] if squeeze else y


def spmv_bsr_ml(bsr_vals: torch.Tensor, col_idx: torch.Tensor,
                x: torch.Tensor, n: int, sb: int = 8) -> torch.Tensor:
    """Multi-level block path: loop over row-superblocks (stripes of ``sb``
    row-blocks); each step touches only that stripe's tiles + segments."""
    n_rb, nbr, bs, _ = bsr_vals.shape
    squeeze = x.ndim == 1
    if squeeze:
        x = x[:, None]
    xb = _pad_rows(x, n_rb * bs).reshape(n_rb, bs, -1)
    ci = col_idx.long()
    ys = []
    for r0 in range(0, n_rb, sb):
        seg = xb[ci[r0:r0 + sb]]                          # (<=sb, nbr, bs, f)
        ys.append(torch.einsum("rnij,rnjf->rif", bsr_vals[r0:r0 + sb], seg))
    y = torch.cat(ys).reshape(n_rb * bs, -1)[:n]
    return y[:, 0] if squeeze else y


# -- batched paths (stacked plans, one call) --------------------------------


def _flat_gather_segments(xs: torch.Tensor, col_idx: torch.Tensor,
                          bs: int, n_cb: int | None = None) -> torch.Tensor:
    """Charge segments for every (lane, row-block, tile) of a batch.

    ``xs`` (B, n, f), ``col_idx`` (B, n_rb, nbr) -> (B, n_rb, nbr, bs, f).
    The batch is flattened into one segment table and the indices offset
    per lane, so the gather is one plain row gather. ``n_cb`` widens the
    table beyond ``ceil(n / bs)`` column blocks (capacity-padded plans).
    """
    B = xs.shape[0]
    n_cb = max((xs.shape[1] + bs - 1) // bs, n_cb or 0)
    flat = _pad_rows(xs, n_cb * bs, axis=1).reshape(B * n_cb, bs, -1)
    off = (torch.arange(B, device=xs.device) * n_cb)[:, None, None]
    seg = flat[(col_idx.long() + off).reshape(-1)]
    return seg.reshape(tuple(col_idx.shape) + tuple(seg.shape[1:]))


def _tiles_times_segments(vals: torch.Tensor,
                          seg: torch.Tensor) -> torch.Tensor:
    """(..., nbr, bs, bs) tiles x (..., nbr, bs, f) segments ->
    (..., bs, f), summed over the tile slots.

    Two arithmetic forms, as in the kernel: the elementwise
    broadcast-multiply + reduce for f == 1, and a batched tile product
    summed over slots for f > 1."""
    lead = tuple(vals.shape[:-3])
    nbr, bs = vals.shape[-3], vals.shape[-1]
    f = seg.shape[-1]
    if f == 1:
        y = (vals * seg[..., None, :, 0]).sum(dim=(-3, -1))
        return y[..., None]
    out = torch.bmm(vals.reshape(-1, bs, bs), seg.reshape(-1, bs, f))
    return out.reshape(lead + (nbr, bs, f)).sum(dim=-3)


def spmv_bsr_batched(vals: torch.Tensor, col_idx: torch.Tensor,
                     xs: torch.Tensor) -> torch.Tensor:
    """Flat block path over a stacked batch: ``vals`` (B, n_rb, nbr, bs,
    bs), ``xs`` (B, n) or (B, n, f); one gather + one tile contraction
    for every plan in the batch."""
    B, n_rb, nbr, bs, _ = vals.shape
    squeeze = xs.ndim == 2
    if squeeze:
        xs = xs[..., None]
    n = xs.shape[1]
    seg = _flat_gather_segments(xs, col_idx, bs)
    y = _tiles_times_segments(vals, seg)
    y = y.reshape(B, n_rb * bs, -1)[:, :n]
    return y[..., 0] if squeeze else y


def spmv_bsr_ml_batched(vals: torch.Tensor, col_idx: torch.Tensor,
                        xs: torch.Tensor, sb: int = 8) -> torch.Tensor:
    """Multi-level batched path: loop over row-superblock stripes (every
    lane's stripe s together), flat-gathering each stripe's segments —
    the working set per step is one stripe *across the batch*."""
    B, n_rb, nbr, bs, _ = vals.shape
    squeeze = xs.ndim == 2
    if squeeze:
        xs = xs[..., None]
    n = xs.shape[1]
    ys = []
    for r0 in range(0, n_rb, sb):
        seg = _flat_gather_segments(xs, col_idx[:, r0:r0 + sb], bs)
        ys.append(_tiles_times_segments(vals[:, r0:r0 + sb], seg))
    y = torch.cat(ys, dim=1).reshape(B, n_rb * bs, -1)[:, :n]
    return y[..., 0] if squeeze else y


@register_batched_backend("bsr")
def _bsr_batched(spec, data, xs: torch.Tensor) -> torch.Tensor:
    return spmv_bsr_batched(data.vals, data.col_idx, xs)


@register_batched_backend("bsr_ml")
def _bsr_ml_batched(spec, data, xs: torch.Tensor) -> torch.Tensor:
    return spmv_bsr_ml_batched(data.vals, data.col_idx, xs, spec.sb)


# -- registry backends (plan, x) -> y, cluster index space ------------------


@register_backend("csr")
def _csr_backend(plan, x: torch.Tensor, **_kw) -> torch.Tensor:
    """Per-edge gather baseline over the plan's reordered COO pattern."""
    rows, cols, vals = plan.coo_device()
    return spmv_csr(vals, rows, cols, x, plan.n)


@register_backend("bsr")
def _bsr_backend(plan, x: torch.Tensor, **_kw) -> torch.Tensor:
    b = plan.bsr
    return spmv_bsr(b.vals, b.col_idx, x, plan.n)


@register_backend("bsr_ml")
def _bsr_ml_backend(plan, x: torch.Tensor, **_kw) -> torch.Tensor:
    b = plan.bsr
    return spmv_bsr_ml(b.vals, b.col_idx, x, plan.n, b.sb)


# ---------------------------------------------------------------------------
# Iterative applications: blockwise-dense value recomputation
# ---------------------------------------------------------------------------

# budget of one chunk's (rows, nbr, bs, bs, d) difference tensor; the
# chunk's other intermediates (squared norms, weights) are smaller
CHUNK_BYTES = 512 * 2**20


def _row_chunk(n_rb: int, nbr: int, bs: int, d: int) -> int:
    """Row blocks per chunk so the chunk's difference tensor fits
    ``CHUNK_BYTES`` (at least one row block)."""
    per_rb = max(nbr * bs * bs * d * 4, 1)
    return max(1, min(n_rb, CHUNK_BYTES // per_rb))


def tsne_force_blocked(p_vals: torch.Tensor, col_idx: torch.Tensor,
                       yp: torch.Tensor,
                       nbr_mask: torch.Tensor | None = None) -> torch.Tensor:
    """The t-SNE attractive force over padded coordinates, chunked.

    ``p_vals`` (n_rb, nbr, bs, bs) stored target x source, ``col_idx``
    (n_rb, nbr), ``yp`` (n_cb*bs, d) with n_cb >= n_rb. Returns
    (n_rb*bs, d): F_i = sum_j p_ij q_ij (y_i - y_j),
    q_ij = 1/(1 + |y_i - y_j|^2), in the reference's arithmetic order.
    ``nbr_mask`` (n_rb, nbr) bool, or None for every slot, selects the
    slots summed: a masked slot's tile becomes 0 and its column block 0
    (selection, not multiplication: NaN x 0 is NaN), chunk by chunk.
    """
    n_rb, nbr, bs, _ = p_vals.shape
    d = yp.shape[1]
    yb = yp.reshape(-1, bs, d)
    ci = col_idx.long()
    step = _row_chunk(n_rb, nbr, bs, d)
    out = []
    for r0 in range(0, n_rb, step):
        r1 = min(n_rb, r0 + step)
        p, c, _ = drop_masked_slots(
            p_vals[r0:r1], ci[r0:r1],
            None if nbr_mask is None else nbr_mask[r0:r1])
        ysrc = yb[c]                                     # (r, nbr, bs, d)
        ytgt = yb[r0:r1, None, :, None, :]               # (r, 1, bs, 1, d)
        diff = ytgt - ysrc[:, :, None, :, :]             # (r, nbr, t, s, d)
        q = 1.0 / (1.0 + (diff * diff).sum(-1))
        w = p * q                            # p tile is (target, source)
        out.append(torch.einsum("rnts,rntsd->rtd", w, diff))
    if not out:
        return yp.new_zeros((0, d))
    return torch.cat(out).reshape(n_rb * bs, d)


def tsne_attractive(p_vals: torch.Tensor, col_idx: torch.Tensor,
                    nbr_mask: torch.Tensor, y: torch.Tensor,
                    n: int) -> torch.Tensor:
    """t-SNE attractive force (paper §3.1), blockwise.

    F_i = sum_j p_ij q_ij (y_i - y_j), q_ij = 1/(1 + |y_i - y_j|^2), with
    p the (fixed-profile) kNN-based affinity stored as dense tiles. Values
    p_ij q_ij are recomputed dense per tile from the current embedding y
    (n, d) over the slots ``nbr_mask`` keeps (None: every slot), as the
    kernel reads them; on a plan the masked slots hold zero P tiles, so
    the mask changes nothing there but what a masked slot may hold.
    """
    n_rb, nbr, bs, _ = p_vals.shape
    yp = _pad_rows(y, n_rb * bs)
    return tsne_force_blocked(p_vals, col_idx, yp, nbr_mask)[:n]


def meanshift_step(w_pattern: torch.Tensor, col_idx: torch.Tensor,
                   sources_blocked: torch.Tensor, t: torch.Tensor,
                   h2: float, n: int) -> torch.Tensor:
    """One mean-shift iteration (paper §3.2), blockwise.

    New mean m_i = sum_j w_ij s_j / sum_j w_ij with Gaussian weights
    w_ij = exp(-|t_i - s_j|^2 / h2) over the (fixed) neighbor pattern;
    weights are recomputed dense per tile from current targets t.
    ``w_pattern`` (n_rb, nbr, bs, bs) is the 0/1 neighbor-pattern tile.
    ``sources_blocked`` (n_cb, bs, d) are sources in cluster order.
    """
    n_rb, nbr, bs, _ = w_pattern.shape
    d = t.shape[1]
    tp = _pad_rows(t, n_rb * bs).reshape(n_rb, bs, d)
    ci = col_idx.long()
    step = _row_chunk(n_rb, nbr, bs, d)
    out = []
    for r0 in range(0, n_rb, step):
        r1 = min(n_rb, r0 + step)
        s = sources_blocked[ci[r0:r1]]                   # (r, nbr, bs, d)
        diff = tp[r0:r1, None, :, None, :] - s[:, :, None, :, :]
        w = torch.exp(-(diff * diff).sum(-1) / h2) * w_pattern[r0:r1]
        num = torch.einsum("rnts,rnsd->rtd", w, s)
        den = w.sum(dim=(1, 3))[..., None]
        out.append(num / torch.clamp_min(den, 1e-12))
    if not out:
        return t.new_zeros((0, d))
    return torch.cat(out).reshape(-1, d)[:n]
