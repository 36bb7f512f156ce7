"""Lanczos tridiagonalization with full reorthogonalization.

Turns ``m`` matvecs of a symmetric operator into an ``m x m`` tridiagonal
whose eigenpairs (Ritz pairs) approximate the operator's extremal
spectrum — the classic matrix-free eigensolver, and the whole reason the
plan operator can power spectral embedding without ever materializing
the similarity matrix.

In float32 the three-term recurrence loses orthogonality within a
handful of iterations, so every new Krylov vector is *fully*
reorthogonalized against the fixed-size basis buffer (one masked
matmul per iteration — O(m n) work, small next to the matvec) and the
projection is applied twice ("twice is enough", Parlett): Ritz vectors
stay orthonormal to ~1e-6 even at m approaching n.

The loop makes no host sync: a happy breakdown is handled with
``torch.where``, and only the small tridiagonal's ``eigh`` runs at the end.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch._device import DeviceLike, resolve_device

__all__ = ["LanczosResult", "lanczos", "lanczos_eigsh"]


class LanczosResult(NamedTuple):
    """``alpha`` (m,) diagonal, ``beta`` (m-1,) off-diagonal of the
    tridiagonal ``T``; ``V`` (m, n) the orthonormal Krylov basis rows
    (``V A V^T ~= T``); ``beta_last`` the final residual coupling (a
    posteriori error gauge: ~0 means the Krylov space is invariant)."""
    alpha: torch.Tensor
    beta: torch.Tensor
    V: torch.Tensor
    beta_last: torch.Tensor


def lanczos(A: Callable, v0: torch.Tensor, m: int) -> LanczosResult:
    """Run ``m`` Lanczos iterations of symmetric ``A`` from start vector
    ``v0`` (n,) on ``v0``'s device. Happy breakdown (an exactly invariant
    subspace) is handled by continuing with a zero vector — the trailing
    ``beta`` entries are 0 and the tridiagonal stays block-diagonal, so
    ``eigh`` downstream is unaffected."""
    if m < 1:
        raise ValueError(f"lanczos needs m >= 1, got {m}")
    n = v0.shape[0]
    nrm = torch.linalg.vector_norm(v0)
    v = v0 / torch.where(nrm == 0, 1.0, nrm)

    V = torch.zeros((m + 1, n), dtype=v0.dtype, device=v0.device)
    V[0] = v
    alpha = torch.zeros(m, dtype=v0.dtype, device=v0.device)
    beta = torch.zeros(m, dtype=v0.dtype, device=v0.device)
    for j in range(m):
        vj = V[j]
        w = A(vj)
        alpha[j] = torch.dot(vj, w)
        # full reorthogonalization against the basis built so far (rows
        # > j are zero, so the product projects exactly onto
        # span{v_0..v_j}); applied twice for float32 robustness
        for _ in range(2):
            w = w - V.T @ (V @ w)
        b = torch.linalg.vector_norm(w)
        beta[j] = b
        V[j + 1] = torch.where(b == 0, 0.0, w / torch.where(b == 0, 1.0, b))
    return LanczosResult(alpha=alpha, beta=beta[:m - 1], V=V[:m],
                         beta_last=beta[m - 1])


def lanczos_eigsh(A: Callable, n: int, k: int, *, m: int = 0,
                  seed: int = 0,
                  v0: Optional[torch.Tensor] = None,
                  largest: bool = True,
                  device: DeviceLike = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top (or bottom) ``k`` Ritz pairs of symmetric ``A`` of size ``n``.

    Runs :func:`lanczos` for ``m`` iterations (default
    ``min(n, max(2k + 8, 32))``), diagonalizes the small tridiagonal with
    dense ``eigh``, and lifts the eigenvectors back through the Krylov
    basis. Returns ``(w, U)`` with ``w`` (k,) eigenvalues sorted
    descending (``largest``) or ascending and ``U`` (n, k) the matching
    Ritz vectors (unit-norm, orthonormal to reorthogonalization
    accuracy).

    Without ``v0`` the start vector is standard normal from a
    ``torch.Generator`` seeded with ``seed`` on ``device`` (``None`` =
    ``"cuda"``); it is not the reference's ``jax.random`` draw, so
    comparisons with the reference pass ``v0``. Eigenvector signs are
    arbitrary (they differ across LAPACK, cuSOLVER and XLA).
    """
    if not m:
        m = min(n, max(2 * k + 8, 32))
    if k > m:
        raise ValueError(f"k={k} Ritz pairs need m >= k iterations, "
                         f"got m={m}")
    if v0 is None:
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        v0 = torch.randn(n, generator=gen, dtype=torch.float32, device=dev)
    res = lanczos(A, v0, m)
    T = (torch.diag(res.alpha)
         + torch.diag(res.beta, 1) + torch.diag(res.beta, -1))
    w, s = torch.linalg.eigh(T)          # ascending
    if largest:
        w, s = w.flip(0), s.flip(1)
    U = res.V.T @ s[:, :k]               # lift Ritz vectors to R^n
    return w[:k], U
