"""Batched preconditioned conjugate gradient over matrix-free operators.

``cg`` sees nothing but a callable ``A(x) -> y`` — a single
``InteractionPlan.apply`` (one launch of the SpMV kernel on a CUDA plan),
or a ``PlanBatch``'s batched apply (one launch for the whole batch) — and
runs every lane of a stacked right-hand side in lockstep in one loop:

  * early exit: the loop stops once every lane's residual is under its
    tolerance (or ``maxiter`` is reached) — converged lanes freeze (their
    updates are masked out), they never drift or overflow while slow
    lanes finish;
  * telemetry: per-lane iteration counts and the full per-iteration
    residual-norm history ride back on :class:`CGResult` (history entries
    a lane never ran are NaN, so convergence curves plot honestly);
  * preconditioning: ``M`` is any callable ``M(r) -> z`` approximating
    ``A^-1 r`` (see ``repro_torch.solvers.precond`` and the registry in
    ``repro_torch.core.registry``).

Lane layout: the n-axis is ``axis`` (default last). ``b`` of shape
``(n,)`` is one problem; ``(B, n)`` is B lockstep problems; ``(B, n, t)``
with ``axis=-2`` is B problems with t right-hand sides each — the charge
layout the batched SpMV kernel takes.

Early exit without a host sync per iteration: whether any lane is still
active is a device value, and reading it waits for the device. Once every
lane is frozen a further iteration changes nothing that is returned (the
steps are 0, ``x``/``r``/``p``/``rz``/``iters`` are kept, ``history``
receives the NaN it already holds), so the test may run only every
``check_every`` iterations and the result stays exactly that of testing
every iteration; the loop then runs up to ``check_every - 1`` idle
iterations past the last active one.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

__all__ = ["CGResult", "cg"]

# iterations between two host reads of "is any lane still active". 1: on
# an H100 (700 W) a KRR solve of the n = 262 144 SIFT plan converges in 4
# iterations of 0.70 ms; reading every 8th trip saves about 10 % a trip,
# but rounds the loop up to 8 trips, 5.0 ms against 2.8 (PERF.md, §6)
CHECK_EVERY = 1


@dataclasses.dataclass
class CGResult:
    """Solution + convergence telemetry of one (batched) CG run.

    ``x`` has ``b``'s shape. ``iters``/``converged``/``resid``/``bnorm``
    have the lane shape (``b``'s shape with the n-axis removed);
    ``history`` appends a trailing ``maxiter + 1`` axis to the lane
    shape: ``history[..., j]`` is the residual 2-norm *after* j
    iterations, NaN for iterations a lane never ran (it had already
    converged, or the loop had exited). ``resid`` is each lane's final
    residual norm; a lane ``converged`` iff ``resid <= tol * bnorm``.
    """
    x: torch.Tensor
    iters: torch.Tensor
    resid: torch.Tensor
    bnorm: torch.Tensor
    converged: torch.Tensor
    history: torch.Tensor


def _norm(v: torch.Tensor, axis: int) -> torch.Tensor:
    """Lane-wise 2-norm, n-axis kept (size 1) for broadcasting."""
    return torch.sqrt(torch.sum(v * v, dim=axis, keepdim=True))


def _dot(u: torch.Tensor, v: torch.Tensor, axis: int) -> torch.Tensor:
    return torch.sum(u * v, dim=axis, keepdim=True)


def cg(A: Callable, b: torch.Tensor, *,
       M: Optional[Callable] = None,
       tol: float = 1e-5,
       maxiter: int = 256,
       axis: int = -1,
       x0: Optional[torch.Tensor] = None,
       check_every: int = CHECK_EVERY) -> CGResult:
    """Preconditioned conjugate gradient on the symmetric operator ``A``.

    Solves ``A x = b`` per lane to relative tolerance
    ``||r|| <= tol * ||b||`` (lanes with ``||b|| == 0`` converge
    immediately to ``x = 0``). ``A`` and ``M`` must accept/return tensors
    of ``b``'s full shape. ``tol`` is taken in float32. ``check_every``
    sets how many iterations pass between two host reads of the early-exit
    test (see the module docstring); every value gives the same result.
    """
    if maxiter < 1:
        raise ValueError(f"cg needs maxiter >= 1, got {maxiter}")
    if check_every < 1:
        raise ValueError(f"cg needs check_every >= 1, got {check_every}")
    ax = axis % b.ndim - b.ndim          # normalize to a negative axis
    M = M if M is not None else (lambda r: r)

    x = torch.zeros_like(b) if x0 is None else x0.to(b.dtype)
    r = b - A(x) if x0 is not None else b
    z = M(r)
    p = z
    rz = _dot(r, z, ax)
    bnorm = _norm(b, ax)
    rnorm0 = _norm(r, ax)
    target = torch.as_tensor(tol, dtype=b.dtype, device=b.device) * bnorm

    # history rides with an explicit trailing axis; the kept n-axis is
    # squeezed out of the lane scalars when writing
    hist = torch.full(rnorm0.squeeze(ax).shape + (maxiter + 1,),
                      float("nan"), dtype=b.dtype, device=b.device)
    hist[..., 0] = rnorm0.squeeze(ax)
    nan = torch.tensor(float("nan"), dtype=b.dtype, device=b.device)

    active = rnorm0 > target
    iters = torch.zeros(rnorm0.shape, dtype=torch.int32, device=b.device)
    for k in range(maxiter):
        if k % check_every == 0 and not bool(active.any()):
            break
        Ap = A(p)
        pAp = _dot(p, Ap, ax)
        # frozen lanes take a zero step (guard the 0/0 of a finished lane)
        alpha = torch.where(active, rz / torch.where(pAp == 0, 1.0, pAp),
                            0.0)
        x = x + alpha * p
        r = r - alpha * Ap
        z_new = M(r)
        rz_new = _dot(r, z_new, ax)
        beta = torch.where(active, rz_new / torch.where(rz == 0, 1.0, rz),
                           0.0)
        p = torch.where(active, z_new + beta * p, p)
        rnorm = _norm(r, ax)
        still = rnorm > target
        iters = iters + active.to(torch.int32)
        hist[..., k + 1] = torch.where(active, rnorm, nan).squeeze(ax)
        rz = torch.where(active, rz_new, rz)
        active = active & still
    resid = _norm(r, ax)
    return CGResult(x=x, iters=iters.squeeze(ax), resid=resid.squeeze(ax),
                    bnorm=bnorm.squeeze(ax),
                    converged=(resid <= target).squeeze(ax), history=hist)
