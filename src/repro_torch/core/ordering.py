"""Matrix orderings compared in the paper (§4.3, Fig. 2).

Each ordering returns a permutation ``pi`` (numpy int array) such that row i
of the reordered matrix is row ``pi[i]`` of the original — i.e. points are
*placed* in the order listed by ``pi``. The paper's orderings:

  scattered   random permutation (base case)
  rcm         reverse Cuthill-McKee on the symmetrized kNN graph
  pca_1d      sort by most dominant principal component
  lex         lexicographic sort of the first d quantized principal coords
  dual_tree   our hierarchical 2^d-tree (Morton) ordering  (paper's method)

The embedding-based orderings take an optional precomputed embedding ``y``
(N, d); without it they embed ``x`` on ``device`` themselves.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import scipy.sparse as sp
from scipy.sparse.csgraph import reverse_cuthill_mckee

from repro_torch._device import DeviceLike, to_numpy
from repro_torch.core.embedding import embed
from repro_torch.core.hierarchy import build_tree, morton_order


def _embedding(x, d: int, y, device: DeviceLike) -> np.ndarray:
    return to_numpy(embed(x, d, device=device) if y is None else y)


def scattered(n: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.permutation(n)


def rcm(rows: np.ndarray, cols: np.ndarray, n: int) -> np.ndarray:
    """Reverse Cuthill-McKee on the symmetrized sparsity pattern."""
    a = sp.coo_matrix((np.ones_like(rows, dtype=np.int8), (rows, cols)),
                      shape=(n, n)).tocsr()
    a = (a + a.T).tocsr()
    return np.asarray(reverse_cuthill_mckee(a, symmetric_mode=True))


def pca_1d(x, y=None, device: DeviceLike = None) -> np.ndarray:
    y = _embedding(x, 1, y, device)
    return np.argsort(y[:, 0], kind="stable")


def lex(x, d: int = 3, bits: int = 10, y=None,
        device: DeviceLike = None) -> np.ndarray:
    """Lexicographic sort of quantized d-dim principal coordinates."""
    y = _embedding(x, d, y, device)
    lo, hi = y.min(0, keepdims=True), y.max(0, keepdims=True)
    q = ((y - lo) / np.maximum(hi - lo, 1e-30) * (2**bits - 1)).astype(np.uint64)
    key = np.zeros(len(y), dtype=np.uint64)
    for j in range(d):
        key = (key << np.uint64(bits)) | q[:, j]
    return np.argsort(key, kind="stable")


def dual_tree(x, d: int = 3, bits: int = 10, leaf_size: int = 64, y=None,
              device: DeviceLike = None) -> np.ndarray:
    """The paper's ordering: PCA embed -> adaptive 2^d tree -> leaf order."""
    y = _embedding(x, d, y, device)
    return build_tree(y, bits=bits, leaf_size=leaf_size, device=device).perm


def dual_tree_fast(x, d: int = 3, bits: int = 10, y=None,
                   device: DeviceLike = None) -> np.ndarray:
    """Morton-only variant (identical order, no tree materialization)."""
    y = _embedding(x, d, y, device)
    return to_numpy(morton_order(y, bits, device))


def stable_partial_reorder(pi_old: np.ndarray,
                           keys: np.ndarray) -> np.ndarray:
    """Re-sort an existing ordering by fresh ``keys`` (plan refresh).

    ``keys`` is indexed by *original* point index (e.g. new Morton codes
    after points moved). The sort is stable with the old placement as
    tiebreak: points whose key did not change keep their relative order —
    the reordered pattern is perturbed only where points actually migrated
    — while changed points slot into their new key position.
    """
    pi_old = np.asarray(pi_old)
    order = np.argsort(np.asarray(keys)[pi_old], kind="stable")
    return pi_old[order]


def stream_rebucket(pi: np.ndarray, codes: np.ndarray, rows: np.ndarray,
                    cols: np.ndarray, n: int):
    """Streaming rebucket: stable re-sort of the physical slots by their
    maintained Morton ``codes`` (indexed by physical slot), relabeling
    the cluster-space COO to match.

    Points (and holes) whose code did not change keep their relative
    order, so the reordering perturbs only what actually drifted. Pure
    numpy. Returns ``(pi2, inv2, rows2, cols2)``.
    """
    old_pi = np.asarray(pi)
    pi2 = stable_partial_reorder(old_pi, codes)
    inv2 = np.empty_like(pi2)
    inv2[pi2] = np.arange(n)
    return pi2, inv2, inv2[old_pi[rows]], inv2[old_pi[cols]]


def claim_free_slots(free_pos: np.ndarray,
                     targets: np.ndarray) -> np.ndarray:
    """Assign each target position the nearest remaining free slot.

    ``free_pos`` are the cluster-order positions of tombstoned (dead)
    slots, sorted ascending; ``targets`` are the positions where inserted
    points ideally belong
    (:func:`repro_torch.core.hierarchy.insertion_positions`).
    Greedy: targets claim slots in input order, each taking the closest
    slot still unclaimed (ties to the lower position), so inserts land in
    or next to the Morton leaf of their neighbors. Raises when there are
    more targets than free slots (the caller grows capacity first).
    """
    import bisect

    free = list(np.asarray(free_pos))
    targets = np.asarray(targets)
    if len(targets) > len(free):
        raise ValueError(f"{len(targets)} inserts but only {len(free)} "
                         "free slots; grow capacity before claiming")
    out = np.empty(len(targets), np.int64)
    for i, t in enumerate(targets):
        j = bisect.bisect_left(free, t)
        if j == len(free):
            j -= 1
        elif j > 0 and t - free[j - 1] <= free[j] - t:
            j -= 1
        out[i] = free.pop(j)
    return out


def apply_ordering(rows: np.ndarray, cols: np.ndarray,
                   pi_t: np.ndarray, pi_s: Optional[np.ndarray] = None):
    """Relabel COO indices under row/col orderings (targets pi_t, sources pi_s)."""
    if pi_s is None:
        pi_s = pi_t
    inv_t = np.empty_like(pi_t)
    inv_t[pi_t] = np.arange(len(pi_t))
    inv_s = np.empty_like(pi_s)
    inv_s[pi_s] = np.arange(len(pi_s))
    return inv_t[rows], inv_s[cols]


ORDERINGS = ("scattered", "rcm", "pca_1d", "lex2", "lex3", "dual_tree")


def compute_ordering(name: str, x, rows: np.ndarray, cols: np.ndarray,
                     seed: int = 0, device: DeviceLike = None) -> np.ndarray:
    n = x.shape[0]
    if name == "scattered":
        return scattered(n, seed)
    if name == "rcm":
        return rcm(rows, cols, n)
    if name == "pca_1d":
        return pca_1d(x, device=device)
    if name == "lex2":
        return lex(x, d=2, device=device)
    if name == "lex3":
        return lex(x, d=3, device=device)
    if name == "dual_tree":
        return dual_tree(x, d=3, device=device)
    raise ValueError(f"unknown ordering {name!r}")
