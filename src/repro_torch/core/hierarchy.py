"""Hierarchical partitioning of embedded points with an adaptive 2^d tree.

Paper §2.4 "Hierarchical partitioning": in the d-dimensional embedding space
we partition points with an adaptive 2^d-tree (quadtree for d=2, octree for
d=3). The depth-first leaf order of such a tree is exactly the Morton
(Z-curve) order of the quantized coordinates, so the *ordering* is computed
as an argsort of Morton codes; the *tree* (level boundaries, used for
multi-level blocking) is recovered from code prefixes.

Codes are 32-bit quantities computed in ``int64`` tensors (PyTorch's
``uint32`` lacks shifts and masks); their values equal the reference's
``uint32`` codes exactly.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from repro_torch._device import DeviceLike, from_numpy, resolve_device, to_numpy


def _part1by1(v: torch.Tensor) -> torch.Tensor:
    """Spread bits of a 16-bit int so there is one 0 between each (for d=2)."""
    v = v & 0xFFFF
    v = (v | (v << 8)) & 0x00FF00FF
    v = (v | (v << 4)) & 0x0F0F0F0F
    v = (v | (v << 2)) & 0x33333333
    v = (v | (v << 1)) & 0x55555555
    return v


def _part1by2(v: torch.Tensor) -> torch.Tensor:
    """Spread bits of a 10-bit int so there are two 0s between each (d=3)."""
    v = v & 0x3FF
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


MAX_BITS = {1: 30, 2: 16, 3: 10}   # per-dim resolution cap (32-bit codes)


def eff_bits(d: int, bits: int = 0) -> int:
    """Per-dim quantization bits actually used for dimension ``d``."""
    return min(bits or MAX_BITS[d], MAX_BITS[d])


def _interleave(q: torch.Tensor, d: int) -> torch.Tensor:
    if d == 1:
        return q[..., 0]
    if d == 2:
        return _part1by1(q[..., 0]) | (_part1by1(q[..., 1]) << 1)
    if d == 3:
        return (_part1by2(q[..., 0])
                | (_part1by2(q[..., 1]) << 1)
                | (_part1by2(q[..., 2]) << 2))
    raise ValueError(f"morton codes support d<=3, got d={d}")


def morton_codes(y, bits: int = 0, device: DeviceLike = None) -> torch.Tensor:
    """Morton codes (int64 tensor) for points ``y`` (N, d), d in {1, 2, 3}.

    Coordinates are min-max quantized to ``bits`` bits per dimension
    (default: the maximum that fits a 32-bit code: 30/16/10 for d=1/2/3).
    Leading batch axes (..., N, d) code each set against its own box.
    """
    dev = resolve_device(device)
    y = from_numpy(y, dev, torch.float32)
    lo = y.min(dim=-2, keepdim=True).values
    hi = y.max(dim=-2, keepdim=True).values
    return morton_codes_box(y, lo, hi, bits, dev)


def morton_codes_box(y, lo, hi, bits: int = 0,
                     device: DeviceLike = None) -> torch.Tensor:
    """Morton codes quantized against an *explicit* bounding box.

    Cell identity is only comparable between two point sets when both are
    quantized against the same box. Points outside the box clip to the
    boundary cells. The quantization is float32 arithmetic in the
    reference's operation order followed by truncation, so codes agree
    with the reference at cell edges too.
    """
    dev = resolve_device(device)
    y = from_numpy(y, dev, torch.float32)
    lo = from_numpy(lo, dev, torch.float32)
    hi = from_numpy(hi, dev, torch.float32)
    d = y.shape[-1]
    if d not in MAX_BITS:
        raise ValueError(f"morton codes support d<=3, got d={d}")
    b = eff_bits(d, bits)
    span = torch.clamp_min(hi - lo, 1e-30)
    q = torch.clamp((y - lo) / span * (2**b - 1), 0, 2**b - 1
                    ).to(torch.int64)
    return _interleave(q, d)


def morton_order(y, bits: int = 0, device: DeviceLike = None) -> torch.Tensor:
    """Permutation placing points in 2^d-tree depth-first (Z-curve) order."""
    return torch.argsort(morton_codes(y, bits, device), stable=True)


@dataclass
class Tree:
    """Adaptive 2^d tree over Morton-sorted points.

    ``levels[l]`` is an int array of leaf/cluster boundaries (prefix sums of
    cluster sizes) at level ``l``; level 0 is the root (single cluster).
    ``perm`` maps sorted position -> original point index.
    """
    perm: np.ndarray
    levels: List[np.ndarray]
    d: int
    bits: int

    @property
    def n_levels(self) -> int:
        return len(self.levels)

    def clusters(self, level: int) -> np.ndarray:
        """Boundaries at `level` as (n_clusters+1,) offsets into perm."""
        return self.levels[level]


def tree_from_codes(codes: np.ndarray, perm: np.ndarray, d: int,
                    bits: int = 0, leaf_size: int = 64,
                    max_levels: int = 0) -> Tree:
    """Levels of the adaptive 2^d tree from per-*original-index* Morton
    ``codes`` and a permutation ``perm`` placing them in sorted order.

    Splits every cluster by successive code prefixes (= 2^d spatial
    subdivision) until clusters have at most ``leaf_size`` points; clusters
    already small enough are not split further (adaptivity). Host numpy.
    """
    codes = to_numpy(codes)[perm]
    n = len(codes)
    bits_eff = eff_bits(d, bits)
    total_bits = d * bits_eff
    max_levels = max_levels or bits_eff   # default: full quantization depth

    levels = [np.array([0, n])]
    for level in range(1, max_levels + 1):
        shift = max(total_bits - level * d, 0)
        prev = levels[-1]
        bounds = [0]
        for c in range(len(prev) - 1):
            lo, hi = int(prev[c]), int(prev[c + 1])
            if hi - lo <= leaf_size:      # adaptive: leave small clusters be
                bounds.append(hi)
                continue
            seg = codes[lo:hi] >> shift
            # boundaries where the level-prefix changes
            cut = np.nonzero(np.diff(seg))[0] + 1 + lo
            bounds.extend(cut.tolist())
            bounds.append(hi)
        nxt = np.unique(np.array(bounds))
        levels.append(nxt)
        sizes = np.diff(nxt)
        if sizes.max(initial=0) <= leaf_size or shift == 0:
            break
    return Tree(perm=perm, levels=levels, d=d, bits=bits)


def build_tree(y, bits: int = 0, leaf_size: int = 64, max_levels: int = 0,
               device: DeviceLike = None) -> Tree:
    """Adaptive hierarchical partition (paper §2.4). The codes are computed
    on ``device``; the stable sort and the level recovery run in numpy — the
    tree is built once per reordering, like the paper's."""
    codes = to_numpy(morton_codes(y, bits, device))
    d = y.shape[1]
    perm = np.argsort(codes, kind="stable")
    return tree_from_codes(codes, perm, d, bits, leaf_size, max_levels)


def rebucket(y_new, prev: Tree, leaf_size: int = 64, max_levels: int = 0,
             device: DeviceLike = None) -> Tree:
    """Incremental re-bucket for moved points (plan refresh).

    Reuses the previous tree's dimensionality/resolution and re-sorts the
    *new* Morton codes stably with the previous leaf order as tiebreak —
    points that stayed in their cell keep their relative order (so the
    downstream reordered pattern changes only where points migrated), while
    migrated points slot into their new cells. Levels are recomputed from
    the code prefixes (no re-embedding, no code re-fit). The codes are
    computed on ``device``; the stable sort runs in numpy.
    """
    codes = to_numpy(morton_codes(y_new, prev.bits, device))
    perm_prev = np.asarray(prev.perm)
    order = np.argsort(codes[perm_prev], kind="stable")
    perm = perm_prev[order]
    return tree_from_codes(codes, perm, prev.d, prev.bits, leaf_size,
                           max_levels)
