"""Multi-level compressed block-sparse storage (paper §2.4).

The bottom level is a fixed ``bs x bs`` tile; a row-block keeps the list of
column-block indices of its nonzero tiles, ELL-padded to one width so the
tile tensor is a single dense ``(n_rb, max_nbr, bs, bs)`` array the CUDA
kernel strides through. The adaptive tree survives as (i) *which* tiles are
kept and (ii) the second level: tiles are grouped under ``sb x sb``-tile
superblocks, and the per-row tile lists are ordered by superblock then
column — the multi-level iteration schedule that improves charge-segment
reuse.

``nnz / covered area`` of the kept tiles is exactly the paper's patch-density
numerator/denominator for this (uniform-grid) covering — reported as
``fill``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch._device import DeviceLike, from_numpy, resolve_device, to_numpy


@dataclass
class BSR:
    bs: int                   # bottom-level tile size
    sb: int                   # superblock size, in tiles (level above)
    n: int                    # logical matrix dimension (n x n), pre-padding
    n_rb: int
    n_cb: int
    col_idx: torch.Tensor     # (n_rb, max_nbr) int32, padded with 0
    nbr_mask: torch.Tensor    # (n_rb, max_nbr) bool, False on padding
    vals: torch.Tensor        # (n_rb, max_nbr, bs, bs) dense tiles, 0 padded
    fill: float               # nnz / (kept tiles * bs^2)
    max_nbr: int

    @property
    def device(self) -> torch.device:
        return self.vals.device

    def rowblock_cols(self, r0: int, r1: int) -> np.ndarray:
        """Sorted unique kept column-blocks of row-blocks ``[r0, r1)`` —
        the column support a row-range's charge window must cover."""
        ci = to_numpy(self.col_idx[r0:r1])
        mk = to_numpy(self.nbr_mask[r0:r1])
        return np.unique(ci[mk]).astype(np.int64)

    def to_dense(self) -> np.ndarray:
        a = np.zeros((self.n_rb * self.bs, self.n_cb * self.bs), np.float32)
        ci = to_numpy(self.col_idx)
        mask = to_numpy(self.nbr_mask)
        v = to_numpy(self.vals)
        for rb in range(self.n_rb):
            for t in range(self.max_nbr):
                if mask[rb, t]:
                    cb = ci[rb, t]
                    a[rb * self.bs:(rb + 1) * self.bs,
                      cb * self.bs:(cb + 1) * self.bs] += v[rb, t]
        return a[:self.n, :self.n]


def index_mask(values: np.ndarray, members: np.ndarray,
               size: int) -> np.ndarray:
    """``np.isin(values, members)`` for indices in ``[0, size)``, through
    one boolean lookup table: O(len(values) + size), where ``np.isin``
    sorts or hashes all of ``values`` (seconds at millions of edges)."""
    lut = np.zeros(size, bool)
    lut[np.asarray(members)] = True
    return lut[values]


def build_bsr(rows: np.ndarray, cols: np.ndarray, vals: Optional[np.ndarray],
              n: int, bs: int = 32, sb: int = 8,
              max_nbr: Optional[int] = None, slack: int = 0,
              device: DeviceLike = None) -> BSR:
    """Build the two-level ELL-BSR from COO. numpy preprocessing (one-off,
    like the paper's tree build); duplicate (i, j) entries are summed.

    ``slack`` widens the ELL slot axis beyond the widest row-block —
    headroom for in-place patches (ignored when ``max_nbr`` pins the width
    explicitly). The layout (``col_idx``, ``nbr_mask``) is derived on the
    host; the tile tensor is dressed on ``device`` by one scatter-add of
    the O(nnz) edge arrays and never exists on the host.
    """
    dev = resolve_device(device)
    rows = np.asarray(rows)
    cols = np.asarray(cols)
    nnz = len(rows)
    if vals is None:
        vals = np.ones(nnz, np.float32)
    vals = np.asarray(vals, np.float32)
    n_rb = (n + bs - 1) // bs
    n_cb = n_rb

    rb, cb = rows // bs, cols // bs

    # per-row-block tile lists in the multi-level schedule order
    # (superblock-major, then column): one np.unique over keyed tiles
    # yields every row's list already sorted
    skey = (cb // sb).astype(np.int64) * n_cb + cb
    span = np.int64(n_cb) * ((n_cb + sb - 1) // sb + 1)
    uniq = np.unique(rb.astype(np.int64) * span + skey)
    urow = uniq // span
    ucol = (uniq % span) % n_cb
    counts = np.bincount(urow, minlength=n_rb)
    m = int(counts.max(initial=1)) + max(slack, 0)
    if max_nbr is not None:
        m = max_nbr
        if counts.max(initial=0) > m:
            raise ValueError(f"max_nbr={m} < needed {counts.max()}")
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    uslot = np.arange(len(uniq)) - starts[urow]
    col_idx = np.zeros((n_rb, m), np.int32)
    nbr_mask = np.zeros((n_rb, m), bool)
    col_idx[urow, uslot] = ucol
    nbr_mask[urow, uslot] = True

    # dress the tiles on the device: only the edge index/value arrays are
    # uploaded. Every edge lands inside the tensor (no padding entries),
    # and index_add_ sums duplicates.
    pos = np.searchsorted(uniq, rb.astype(np.int64) * span + skey)
    flat = ((rb.astype(np.int64) * m + uslot[pos]) * bs + rows % bs) * bs \
        + cols % bs
    dense = torch.zeros(n_rb * m * bs * bs, dtype=torch.float32, device=dev)
    if nnz:
        dense.index_add_(0, from_numpy(flat, dev, torch.int64),
                         from_numpy(vals, dev, torch.float32))
    dense = dense.view(n_rb, m, bs, bs)

    # mask-consistency invariants the multi-level (bsr_ml) schedule and the
    # kernel rely on: padded slots carry column 0 and zero tiles (the
    # scatter only writes (urow, uslot) cells, which are exactly the masked
    # ones), and within every row the kept columns are superblock-major
    # sorted (so a superblock's tiles are contiguous in the ELL slot axis).
    if col_idx[~nbr_mask].any():
        raise AssertionError("padded slots must point at column 0")
    sb_of = col_idx // sb
    keyed = np.where(nbr_mask, sb_of * np.int64(n_cb) + col_idx,
                     np.iinfo(np.int64).max)
    if not (np.diff(keyed, axis=1) >= 0).all():
        raise AssertionError("tile lists must be superblock-major sorted")

    kept = int(counts.sum())
    fill = nnz / max(kept * bs * bs, 1)
    return BSR(bs=bs, sb=sb, n=n, n_rb=n_rb, n_cb=n_cb,
               col_idx=from_numpy(col_idx, dev),
               nbr_mask=from_numpy(nbr_mask, dev),
               vals=dense, fill=fill, max_nbr=m)


def patch_bsr(bsr: BSR, rows: np.ndarray, cols: np.ndarray,
              vals: Optional[np.ndarray], touched_rb: np.ndarray) -> BSR:
    """Rebuild only the ``touched_rb`` row-blocks of ``bsr`` from the (full,
    cluster-order) COO ``(rows, cols, vals)``; every other row-block's
    stored tiles are reused as-is (plan refresh patches migrated rows
    without paying a full :func:`build_bsr`).

    The ELL shape is pinned: raises ``ValueError`` when a patched row-block
    needs more than ``bsr.max_nbr`` tile slots — callers escalate to a full
    rebuild in that case. Maintains the layout invariants (superblock-major
    tile lists, zero padding) and recomputes ``fill`` from the new totals.

    Unlike the reference, whose ``.at[]`` updates return copies, the port
    updates the resident ``col_idx``/``nbr_mask``/``vals`` tensors **in
    place** (``index_copy_``, ``index_fill_``, ``index_add_``): the
    returned BSR shares them with ``bsr``, so the input's tiles change too
    and only the returned object's ``fill`` describes them. Only the true
    edges of the touched row-blocks are scattered (no padding entries).
    """
    rows = np.asarray(rows)
    cols = np.asarray(cols)
    nnz = len(rows)
    vals = (np.ones(nnz, np.float32) if vals is None
            else np.asarray(vals, np.float32))
    touched = np.unique(np.asarray(touched_rb))
    if touched.size == 0:
        return bsr
    bs, sb, m = bsr.bs, bsr.sb, bsr.max_nbr
    if touched.min(initial=0) < 0 or touched.max(initial=0) >= bsr.n_rb:
        raise ValueError(f"touched_rb out of range for n_rb={bsr.n_rb}")

    rb_all = rows // bs
    sel = index_mask(rb_all, touched, bsr.n_rb)
    r_t, c_t, v_t = rows[sel], cols[sel], vals[sel]
    rb, cb = r_t // bs, c_t // bs

    # dense slot of every touched row-block (row-block id -> 0..t-1)
    slot_of_rb = np.full(bsr.n_rb, -1, np.int64)
    slot_of_rb[touched] = np.arange(touched.size)
    col_rows = np.zeros((touched.size, m), np.int32)
    mask_rows = np.zeros((touched.size, m), bool)

    # unique tiles keyed (row-block, superblock-major column): np.unique
    # yields every touched row's tile list already in schedule order
    skey = (cb // sb).astype(np.int64) * bsr.n_cb + cb
    span = np.int64(bsr.n_cb) * ((bsr.n_cb + sb - 1) // sb + 1)
    uniq = np.unique(rb.astype(np.int64) * span + skey)
    urow = slot_of_rb[uniq // span]               # 0..t-1, sorted runs
    ucol = (uniq % span) % bsr.n_cb
    counts = np.bincount(urow, minlength=touched.size)
    if counts.max(initial=0) > m:
        raise ValueError(
            f"a patched row-block needs {counts.max()} tile slots, "
            f"max_nbr={m} — rebuild the BSR")
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    uslot = np.arange(len(uniq)) - starts[urow]   # rank within its row
    col_rows[urow, uslot] = ucol
    mask_rows[urow, uslot] = True

    # every selected edge's flat position in the tile tensor
    pos = np.searchsorted(uniq, rb.astype(np.int64) * span + skey)
    flat = ((rb.astype(np.int64) * m + uslot[pos]) * bs + r_t % bs) * bs \
        + c_t % bs

    mask_host = to_numpy(bsr.nbr_mask)
    kept_prev = int(mask_host.sum())
    kept_touched_prev = int(mask_host[touched].sum())
    kept_new = int(mask_rows.sum())

    dev = bsr.device
    ti = from_numpy(touched, dev, torch.int64)
    bsr.col_idx.index_copy_(0, ti, from_numpy(col_rows, dev, torch.int32))
    bsr.nbr_mask.index_copy_(0, ti, from_numpy(mask_rows, dev, torch.bool))
    bsr.vals.index_fill_(0, ti, 0.0)
    if len(flat):
        bsr.vals.view(-1).index_add_(0, from_numpy(flat, dev, torch.int64),
                                     from_numpy(v_t, dev, torch.float32))

    kept = kept_prev - kept_touched_prev + kept_new
    fill = nnz / max(kept * bs * bs, 1)
    return BSR(bs=bs, sb=sb, n=bsr.n, n_rb=bsr.n_rb, n_cb=bsr.n_cb,
               col_idx=bsr.col_idx, nbr_mask=bsr.nbr_mask, vals=bsr.vals,
               fill=fill, max_nbr=m)


def tombstone_rows(bsr: BSR, rows: np.ndarray, cols: np.ndarray,
                   vals: Optional[np.ndarray], dead: np.ndarray):
    """Remove points ``dead`` (cluster-order indices) from the matrix:
    their rows *and* the edges referencing them as columns vanish.

    Built on :func:`patch_bsr`: the COO ``(rows, cols, vals)`` — the same
    full cluster-order pattern the BSR was built from — is filtered of
    every edge touching a dead point, and only the row-blocks that held
    such an edge are re-dressed. Like ``patch_bsr`` it writes the resident
    tensors **in place** (callers that must keep the input valid patch a
    copy). Returns ``(bsr', rows', cols', vals', touched_rb)``: the
    filtered COO (so the caller's pattern stays in sync with storage) and
    the row-blocks that were re-dressed.
    """
    rows = np.asarray(rows)
    cols = np.asarray(cols)
    vals = (np.ones(len(rows), np.float32) if vals is None
            else np.asarray(vals, np.float32))
    dead = np.unique(np.asarray(dead))
    if dead.size == 0:
        return bsr, rows, cols, vals, np.empty(0, np.int64)
    if dead.min(initial=0) < 0 or dead.max(initial=-1) >= bsr.n:
        raise ValueError(f"dead indices out of range for n={bsr.n}")
    drop = index_mask(rows, dead, bsr.n) | index_mask(cols, dead, bsr.n)
    r2, c2, v2 = rows[~drop], cols[~drop], vals[~drop]
    touched = np.unique(np.concatenate([rows[drop] // bsr.bs,
                                        dead // bsr.bs]))
    return patch_bsr(bsr, r2, c2, v2, touched), r2, c2, v2, touched


def random_bsr(key_seed: int, n: int, bs: int, nbr: int, *, sb: int = 8,
               banded: bool = False, device: DeviceLike = None) -> BSR:
    """Synthetic BSR with exactly ``nbr`` dense tiles per row-block — the
    micro-benchmark matrices of paper §4.1 (banded best case vs scattered).

    Generated with numpy from ``key_seed``, so the same seed yields the
    same matrix as the reference package. Per-row tile lists are sorted
    ascending (which is superblock-major) and every slot is a kept tile.
    """
    dev = resolve_device(device)
    rng = np.random.default_rng(key_seed)
    n_rb = (n + bs - 1) // bs
    cols_list = []
    for r in range(n_rb):
        if banded:
            lo = max(0, min(r - nbr // 2, n_rb - nbr))
            c = np.arange(lo, lo + nbr)
        else:
            c = rng.choice(n_rb, size=nbr, replace=False)
            c.sort()
        cols_list.append(c)
    col_idx = np.stack(cols_list).astype(np.int32)
    vals = rng.standard_normal((n_rb, nbr, bs, bs)).astype(np.float32)
    return BSR(bs=bs, sb=sb, n=n, n_rb=n_rb, n_cb=n_rb,
               col_idx=from_numpy(col_idx, dev),
               nbr_mask=torch.ones((n_rb, nbr), dtype=torch.bool, device=dev),
               vals=from_numpy(vals, dev), fill=1.0, max_nbr=nbr)


def append_rows(bsr: BSR, n_new: int, extra_nbr: int = 0) -> BSR:
    """Grow the (square) matrix dimension to ``n_new`` by appending empty
    row-blocks, and/or widen the ELL slot axis by ``extra_nbr`` spare slots.

    Appended rows and slots carry no tiles (mask False, column 0, zero
    values). ``PlanBatch.from_plans`` widens narrower members to the
    widest one's ELL width through this, and a streaming plan that runs
    out of free slots grows its capacity through it. The column dimension
    grows in lockstep (``n_cb == n_rb``), which existing tiles are
    agnostic to.
    ``fill`` is unchanged: no kept tile was added or removed.
    """
    if n_new < bsr.n:
        raise ValueError(f"append_rows cannot shrink: n_new={n_new} < "
                         f"n={bsr.n} (delete + compact instead)")
    if extra_nbr < 0:
        raise ValueError(f"extra_nbr must be >= 0, got {extra_nbr}")
    n_rb2 = (n_new + bsr.bs - 1) // bsr.bs
    grow = n_rb2 - bsr.n_rb
    if grow == 0 and extra_nbr == 0:
        return BSR(bs=bsr.bs, sb=bsr.sb, n=n_new, n_rb=bsr.n_rb,
                   n_cb=bsr.n_cb, col_idx=bsr.col_idx,
                   nbr_mask=bsr.nbr_mask, vals=bsr.vals, fill=bsr.fill,
                   max_nbr=bsr.max_nbr)
    pad = torch.nn.functional.pad
    col_idx = pad(bsr.col_idx, (0, extra_nbr, 0, grow))
    nbr_mask = pad(bsr.nbr_mask, (0, extra_nbr, 0, grow))
    vals = pad(bsr.vals, (0, 0, 0, 0, 0, extra_nbr, 0, grow))
    return BSR(bs=bsr.bs, sb=bsr.sb, n=n_new, n_rb=n_rb2, n_cb=n_rb2,
               col_idx=col_idx, nbr_mask=nbr_mask, vals=vals,
               fill=bsr.fill, max_nbr=bsr.max_nbr + extra_nbr)
