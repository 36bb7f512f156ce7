"""ELL-BSR SpMV/SpMM: the hand-written CUDA kernel and its plain version.

Counterpart of the reference's ``kernels/bsr_spmv.py`` (Pallas, TPU). Two
entries share one device code (``csrc/bsr_spmv.cu``):

* ``bsr_spmv_batched`` — stacked members ``vals (B, n_rb, nbr, bs, bs)``,
  ``col_idx (B, n_rb, nbr)``, ``xs (B, n_cb*bs, f)`` -> ``(B, n_rb*bs, f)``.
* ``bsr_spmv`` — the single-plan form, ``x (n_cb*bs, f)`` -> ``(n_rb*bs, f)``.

Both take an optional ``nbr_mask`` of ``col_idx``'s shape (bool): the
kernel reads only the tiles of kept slots, and the plain versions select
the masked slots away, so the two compute one function whatever a masked
tile holds. Without a mask every slot is kept.

Each call checks that the kept slots' ``col_idx`` lie inside the charges'
column blocks, which reads the indices back to the host (a device sync).
Callers whose indices were made in range on the host — a plan's storage:
``build_bsr``, ``patch_bsr``, ``append_rows``, ``random_bsr``,
``convert.bsr_from_arrays`` — pass ``indices_checked=True`` and launch
without that sync.

For a tensor on the CPU a wrapper returns its plain version; for a CUDA
tensor it launches the kernel or raises. Each wrapper counts its launches
in a plain integer attribute ``launches``.
"""
from __future__ import annotations

import torch

from repro_torch.core.interact import (_flat_gather_segments,
                                       _tiles_times_segments)
from repro_torch.kernels import _build
from repro_torch.kernels.ref import bsr_spmv_ref, drop_masked_slots

SUPPORTED_BS = (4, 8, 16, 32, 64)


def bsr_spmv_batched_plain(vals: torch.Tensor, col_idx: torch.Tensor,
                           xs: torch.Tensor,
                           nbr_mask: torch.Tensor | None = None
                           ) -> torch.Tensor:
    """Plain version: flat segment gather, then the tile contraction in the
    kernel's two arithmetic forms (f == 1 multiply-reduce, f > 1 batched
    tile product summed over slots), over the kept slots only."""
    B, n_rb, nbr, bs, _ = vals.shape
    vals, col_idx, keep = drop_masked_slots(vals, col_idx, nbr_mask)
    seg = _flat_gather_segments(xs, col_idx, bs, n_cb=xs.shape[1] // bs)
    if keep is not None:
        seg = torch.where(keep, seg, 0.0)
    return _tiles_times_segments(vals, seg).reshape(B, n_rb * bs, -1)


def bsr_spmv_plain(vals: torch.Tensor, col_idx: torch.Tensor,
                   x: torch.Tensor,
                   nbr_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of the single-plan entry (the einsum oracle)."""
    return bsr_spmv_ref(vals, col_idx, x, nbr_mask)


def _check(vals, col_idx, xs, nbr_mask, batched: bool,
           indices_checked: bool):
    nd = 5 if batched else 4
    if vals.ndim != nd or col_idx.ndim != nd - 2 or xs.ndim != nd - 2:
        raise ValueError(
            f"expected vals {nd}-D, col_idx {nd - 2}-D, charges {nd - 2}-D; "
            f"got {tuple(vals.shape)}, {tuple(col_idx.shape)}, "
            f"{tuple(xs.shape)}")
    bs = vals.shape[-1]
    if vals.shape[-2] != bs or tuple(col_idx.shape) != tuple(vals.shape[:-2]):
        raise ValueError(
            f"vals {tuple(vals.shape)} / col_idx {tuple(col_idx.shape)} "
            "do not describe square tiles with one column index each")
    if batched and xs.shape[0] != vals.shape[0]:
        raise ValueError(f"batch mismatch: vals {vals.shape[0]}, "
                         f"charges {xs.shape[0]}")
    if xs.shape[-2] % bs:
        raise ValueError(f"charge length {xs.shape[-2]} is not a whole "
                         f"number of bs={bs} column blocks")
    if vals.dtype != torch.float32 or xs.dtype != torch.float32:
        raise TypeError(f"vals/charges must be float32, got {vals.dtype}/"
                        f"{xs.dtype}")
    if col_idx.dtype != torch.int32:
        raise TypeError(f"col_idx must be int32, got {col_idx.dtype}")
    if not (vals.device == col_idx.device == xs.device):
        raise ValueError("vals, col_idx and charges must share one device")
    check_nbr_mask(nbr_mask, col_idx, "vals, col_idx and charges")
    n_cb = xs.shape[-2] // bs
    if not indices_checked:
        check_kept_columns(col_idx, nbr_mask, n_cb, "the charges")
    return bs, n_cb


def check_nbr_mask(nbr_mask, col_idx, operands: str) -> None:
    """An ELL slot mask, when given, is bool of ``col_idx``'s shape on its
    device (``operands`` names the tensors it must share it with)."""
    if nbr_mask is None:
        return
    if tuple(nbr_mask.shape) != tuple(col_idx.shape):
        raise ValueError(f"nbr_mask {tuple(nbr_mask.shape)} does not "
                         f"match col_idx {tuple(col_idx.shape)}")
    if nbr_mask.dtype != torch.bool:
        raise TypeError(f"nbr_mask must be bool, got {nbr_mask.dtype}")
    if nbr_mask.device != col_idx.device:
        raise ValueError(f"nbr_mask must share the device of {operands}")


def check_kept_columns(col_idx, nbr_mask, n_cb: int, of: str) -> None:
    """The kept slots' column blocks lie in [0, n_cb): reads them back to
    the host (a device sync), so the plan paths skip it."""
    live = col_idx if nbr_mask is None else col_idx[nbr_mask]
    if live.numel():
        lo, hi = torch.aminmax(live)
        if int(lo) < 0 or int(hi) >= n_cb:
            raise ValueError(f"col_idx range [{int(lo)}, {int(hi)}] outside "
                             f"the {n_cb} column blocks of {of}")


def check_cuda_operands(bs, supported, nbr_mask, *tensors) -> int:
    """What the ELL kernels need of their operands on a card: a supported
    tile size, contiguous 16-byte aligned tensors and a contiguous mask.
    Returns the mask's pointer (one byte per slot), 0 for none."""
    if bs not in supported:
        raise ValueError(f"the CUDA kernel supports bs in {supported}, "
                         f"got {bs}")
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError("the CUDA kernel needs contiguous tensors")
        if t.data_ptr() % 16:
            raise ValueError("the CUDA kernel needs 16-byte aligned tensors")
    if nbr_mask is None:
        return 0                                  # null: every slot kept
    if not nbr_mask.is_contiguous():
        raise ValueError("the CUDA kernel needs contiguous tensors")
    return nbr_mask.view(torch.uint8).data_ptr()


def bsr_spmv_batched(vals: torch.Tensor, col_idx: torch.Tensor,
                     xs: torch.Tensor, nbr_mask: torch.Tensor | None = None,
                     *, indices_checked: bool = False) -> torch.Tensor:
    """vals (B, n_rb, nbr, bs, bs) f32; col_idx (B, n_rb, nbr) i32;
    xs (B, n_cb*bs, f) f32; nbr_mask (B, n_rb, nbr) bool or None (every
    slot kept). Returns y (B, n_rb*bs, f) = A[b] @ xs[b] over the kept
    slots. ``indices_checked=True`` skips the range check of ``col_idx``
    (and its host sync) for indices made in range on the host."""
    bs, n_cb = _check(vals, col_idx, xs, nbr_mask, True, indices_checked)
    if vals.device.type != "cuda":
        return bsr_spmv_batched_plain(vals, col_idx, xs, nbr_mask)
    mask_ptr = check_cuda_operands(bs, SUPPORTED_BS, nbr_mask, vals, col_idx,
                                   xs)
    B, n_rb, nbr = col_idx.shape
    f = xs.shape[-1]
    y = torch.empty((B, n_rb * bs, f), dtype=torch.float32, device=vals.device)
    with torch.cuda.device(vals.device):
        code = _build.load().repro_bsr_spmv_batched(
            vals.data_ptr(), col_idx.data_ptr(), mask_ptr, xs.data_ptr(),
            y.data_ptr(), B, n_rb, nbr, bs, n_cb, f, _build.current_stream())
    _build.check(code, "bsr_spmv_batched")
    bsr_spmv_batched.launches += 1
    return y


bsr_spmv_batched.launches = 0


def bsr_spmv(vals: torch.Tensor, col_idx: torch.Tensor, x: torch.Tensor,
             nbr_mask: torch.Tensor | None = None, *,
             indices_checked: bool = False) -> torch.Tensor:
    """vals (n_rb, nbr, bs, bs) f32; col_idx (n_rb, nbr) i32;
    x (n_cb*bs, f) f32; nbr_mask (n_rb, nbr) bool or None. Returns
    y (n_rb*bs, f) = A @ x over the kept slots."""
    bs, n_cb = _check(vals, col_idx, x, nbr_mask, False, indices_checked)
    if vals.device.type != "cuda":
        return bsr_spmv_plain(vals, col_idx, x, nbr_mask)
    mask_ptr = check_cuda_operands(bs, SUPPORTED_BS, nbr_mask, vals, col_idx,
                                   x)
    n_rb, nbr = col_idx.shape
    f = x.shape[-1]
    y = torch.empty((n_rb * bs, f), dtype=torch.float32, device=vals.device)
    with torch.cuda.device(vals.device):
        code = _build.load().repro_bsr_spmv(
            vals.data_ptr(), col_idx.data_ptr(), mask_ptr, x.data_ptr(),
            y.data_ptr(), n_rb, nbr, bs, n_cb, f, _build.current_stream())
    _build.check(code, "bsr_spmv")
    bsr_spmv.launches += 1
    return y


bsr_spmv.launches = 0
