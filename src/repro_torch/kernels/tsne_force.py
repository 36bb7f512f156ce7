"""t-SNE attractive force (paper §3.1): the hand-written CUDA kernel and
its plain version.

Counterpart of the reference's ``kernels/tsne_force.py`` (Pallas, TPU):
F_i = sum_j p_ij q_ij (y_i - y_j) with q_ij = 1/(1 + |y_i - y_j|^2) over
the kNN pattern, with q recomputed dense per kept tile from the current
embedding. ``p_vals (n_rb, nbr, bs, bs)`` is the plan's ELL tile tensor
(target x source), ``col_idx (n_rb, nbr)`` its column blocks and
``y (n_cb*bs, d)`` the embedding padded to whole column blocks; the
result is ``(n_rb*bs, d)``.

An optional ``nbr_mask`` of ``col_idx``'s shape (bool) marks the kept
slots: the kernel reads only their tiles (the plan's ELL padding is never
streamed) and the plain version selects the masked slots away, so the two
compute one function whatever a masked slot holds. Without a mask every
slot is kept.

Each call checks that the kept slots' ``col_idx`` lie inside ``y``'s
column blocks, which reads the indices back to the host (a device sync).
A plan's storage was checked where it was made, so the plan path passes
``indices_checked=True`` and launches without that sync.

For a tensor on the CPU ``tsne_force`` returns its plain version; for a
CUDA tensor it launches ``csrc/tsne_force.cu`` or raises. It counts its
launches in the plain integer attribute ``tsne_force.launches``.
"""
from __future__ import annotations

import torch

from repro_torch.core.interact import tsne_force_blocked
from repro_torch.kernels import _build
from repro_torch.kernels.bsr_spmv import (check_cuda_operands,
                                          check_kept_columns, check_nbr_mask)

SUPPORTED_BS = (8, 16, 32, 64)
SUPPORTED_D = (1, 2, 3)


def tsne_force_plain(p_vals: torch.Tensor, col_idx: torch.Tensor,
                     y: torch.Tensor,
                     nbr_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version: the blockwise-dense force of ``core.interact``,
    chunked over row blocks (same arithmetic as the reference oracle),
    over the kept slots only."""
    return tsne_force_blocked(p_vals, col_idx, y, nbr_mask)


def _check(p_vals, col_idx, y, nbr_mask, indices_checked: bool):
    if p_vals.ndim != 4 or col_idx.ndim != 2 or y.ndim != 2:
        raise ValueError(
            f"expected p_vals 4-D, col_idx 2-D, y 2-D; got "
            f"{tuple(p_vals.shape)}, {tuple(col_idx.shape)}, "
            f"{tuple(y.shape)}")
    n_rb, nbr, bs, bs2 = p_vals.shape
    if bs2 != bs or tuple(col_idx.shape) != (n_rb, nbr):
        raise ValueError(
            f"p_vals {tuple(p_vals.shape)} / col_idx "
            f"{tuple(col_idx.shape)} do not describe square tiles with one "
            "column index each")
    d = y.shape[1]
    if d not in SUPPORTED_D:
        raise ValueError(f"tsne_force supports embedding dimensions d in "
                         f"{SUPPORTED_D} (t-SNE outputs), got d={d}")
    if y.shape[0] % bs or y.shape[0] // bs < n_rb:
        raise ValueError(f"y has {y.shape[0]} rows: expected whole bs={bs} "
                         f"column blocks, at least the {n_rb} row blocks")
    if p_vals.dtype != torch.float32 or y.dtype != torch.float32:
        raise TypeError(f"p_vals/y must be float32, got {p_vals.dtype}/"
                        f"{y.dtype}")
    if col_idx.dtype != torch.int32:
        raise TypeError(f"col_idx must be int32, got {col_idx.dtype}")
    if not (p_vals.device == col_idx.device == y.device):
        raise ValueError("p_vals, col_idx and y must share one device")
    check_nbr_mask(nbr_mask, col_idx, "p_vals, col_idx and y")
    if not indices_checked:
        check_kept_columns(col_idx, nbr_mask, y.shape[0] // bs, "y")
    return n_rb, nbr, bs, d


def tsne_force(p_vals: torch.Tensor, col_idx: torch.Tensor,
               y: torch.Tensor, nbr_mask: torch.Tensor | None = None, *,
               indices_checked: bool = False) -> torch.Tensor:
    """p_vals (n_rb, nbr, bs, bs) f32; col_idx (n_rb, nbr) i32;
    y (n_cb*bs, d) f32 with n_cb >= n_rb, d in {1, 2, 3}; nbr_mask
    (n_rb, nbr) bool or None (every slot kept). Returns F (n_rb*bs, d)
    over the kept slots. ``indices_checked=True`` skips the range check of
    ``col_idx`` (and its host sync) for indices made in range on the
    host."""
    n_rb, nbr, bs, d = _check(p_vals, col_idx, y, nbr_mask, indices_checked)
    if p_vals.device.type != "cuda":
        return tsne_force_plain(p_vals, col_idx, y, nbr_mask)
    mask_ptr = check_cuda_operands(bs, SUPPORTED_BS, nbr_mask, p_vals,
                                   col_idx, y)
    f = torch.empty((n_rb * bs, d), dtype=torch.float32, device=y.device)
    with torch.cuda.device(y.device):
        code = _build.load().repro_tsne_force(
            p_vals.data_ptr(), col_idx.data_ptr(), mask_ptr, y.data_ptr(),
            f.data_ptr(), n_rb, nbr, bs, d, _build.current_stream())
    _build.check(code, "tsne_force")
    tsne_force.launches += 1
    return f


tsne_force.launches = 0
