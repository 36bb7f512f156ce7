"""Kernel ridge regression (and generic solves) on the plan operator.

Rebrova et al. (1803.10274) drive CG for kernel ridge regression through
a hierarchical kernel format; here the format is the plan's ELL-BSR and
the solver never sees anything but matvecs. The regression system

    (K + lam*I) alpha = y,     K = W + self_weight*I

is solved matrix-free: ``W`` is the plan's dressed near-neighbor pattern
(the kNN pattern excludes self-edges, so the kernel's diagonal rides as
an explicit ``self_weight``) and the whole diagonal ``shift =
self_weight + lam`` is folded into the operator — one
``A(v) = plan_apply(v) + shift*v`` per CG iteration.

``solve`` dispatches on the operator kind:

  InteractionPlan  permute -> preconditioner factorization -> CG ->
                   unpermute; each iteration is one ``plan.apply``, for
                   the ``cuda`` backend one launch of the SpMV kernel.
  PlanBatch        the same over stacked ``PlanData`` — B member systems
                   solved in lockstep, each iteration ONE batched apply
                   (one kernel launch for the whole batch), the batched
                   Cholesky preconditioning every lane.
  ShardedPlan      CG in original order over the halo-exchange matvec
                   (one SpMV launch per shard per iteration); the
                   preconditioner factors from the wrapped plan's
                   unsharded tiles and applies in cluster order.

Backends resolve as the plan's own do (``"auto"`` is the ``cuda`` kernel
on a CUDA plan, ``bsr`` on the CPU). A single plan's solve keeps the
reference's rule that a path reading host data (``csr``, which walks the
host COO) or any backend outside ``bsr``/``bsr_ml``/``cuda`` runs as
``bsr``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from repro_torch import api
from repro_torch._device import from_numpy, to_numpy
from repro_torch.core import knn
from repro_torch.core.registry import get_backend, get_preconditioner
from repro_torch.solvers.cg import CGResult, cg

__all__ = ["KRRModel", "solve", "krr_fit", "krr_fit_batch"]

# backends whose compute reads only the plan's device tensors (the
# reference's jit-safe set, with the hand-written ``cuda`` kernel in the
# place of ``pallas``); anything else solves through ``bsr``
_JIT_SAFE = ("bsr", "bsr_ml", "cuda")


def _lane_shift(shift, ndim: int) -> torch.Tensor:
    """Broadcast a scalar or per-lane ``(B,)`` shift against the operand
    layout (lanes lead, the n/rhs axes trail)."""
    return shift.reshape(shift.shape + (1,) * (ndim - shift.ndim))


def _solver_knobs(config, precond, tol, maxiter):
    """Per-call overrides fall back to the plan's configured solver
    knobs (validated at PlanConfig construction)."""
    return (precond if precond is not None else config.precond,
            float(tol) if tol is not None else config.cg_tol,
            int(maxiter) if maxiter is not None else config.cg_maxiter)


def _solve_single(plan, b, shift, tol, backend: str, precond: str,
                  maxiter: int) -> CGResult:
    """One plan: permute -> precondition -> CG -> unpermute."""
    axis = -1 if b.ndim == 1 else -2
    b_cl = torch.index_select(b, 0, plan.pi)
    M = get_preconditioner(precond)(plan.spec, plan.data, shift)
    fn = get_backend(backend)
    sh = _lane_shift(shift, b.ndim)

    def A(v):
        return fn(plan, v) + sh * v

    res = cg(A, b_cl, M=lambda r: M(r, axis=axis), tol=tol,
             maxiter=maxiter, axis=axis)
    return dataclasses.replace(res, x=torch.index_select(res.x, 0, plan.inv))


def _solve_batch(batch, b, shift, tol, backend: str, precond: str,
                 maxiter: int) -> CGResult:
    """Whole-batch solve: stacked permutations, batched preconditioner
    factorization, lockstep CG on the batched SpMV."""
    spec, data = batch.spec, batch.data
    axis = -1 if b.ndim == 2 else -2
    b_cl = api._batch_take(b, data.pi)
    M = get_preconditioner(precond)(spec, data, shift)
    sh = _lane_shift(shift, b.ndim)

    def A(v):
        return api._batch_apply(spec, data, v, backend, "apply",
                                serial=False) + sh * v

    res = cg(A, b_cl, M=lambda r: M(r, axis=axis), tol=tol,
             maxiter=maxiter, axis=axis)
    return dataclasses.replace(res, x=api._batch_take(res.x, data.inv))


def _solve_sharded(sp, b, shift, tol, precond: str,
                   maxiter: int) -> CGResult:
    """CG over the halo-exchange matvec (1-D charges only — the sharded
    apply's contract). The preconditioner factors from the *unsharded*
    tiles the wrapped plan still owns and applies in cluster order."""
    plan = sp.plan
    if b.ndim != 1:
        raise ValueError("sharded solves take 1-D right-hand sides "
                         f"(the sharded matvec contract); got "
                         f"{tuple(b.shape)}")
    M_cl = get_preconditioner(precond)(plan.spec, plan.data, shift)

    def A(v):
        return sp.matvec(v) + shift * v

    def M(r):
        return plan.unpermute(M_cl(plan.permute(r), axis=-1))

    return cg(A, b, M=M, tol=tol, maxiter=maxiter)


def _plan_backend(plan: "api.InteractionPlan", backend) -> str:
    name = plan.resolve_backend(backend)
    return name if name in _JIT_SAFE else "bsr"


def solve(operator, b, *, shift=0.0,
          backend: Optional[str] = None,
          precond: Optional[str] = None,
          tol: Optional[float] = None,
          maxiter: Optional[int] = None) -> CGResult:
    """Solve ``(A + shift*I) x = b`` on a plan-shaped operator.

    ``operator`` is an :class:`~repro_torch.api.InteractionPlan`, a
    :class:`~repro_torch.api.PlanBatch` or a
    :class:`~repro_torch.core.shardplan.ShardedPlan`; ``b`` is in ORIGINAL
    index order — ``(capacity,)`` / ``(capacity, t)`` for a single plan
    (``(capacity,)`` only for a sharded one),
    ``(B, capacity)`` / ``(B, capacity, t)`` for a batch (zero-pad
    dead/hole slots; their solutions come back ``b/shift``, i.e. zero) —
    as a tensor or an array, moved to the operator's device. ``shift`` is
    a number or, for a batch, a per-lane ``(B,)`` tensor. The stored
    pattern must be symmetric (``symmetrize=True`` or symmetric values) —
    CG assumes it. Solver knobs default to the plan's config (``cg_tol``,
    ``cg_maxiter``, ``precond``). Returns a :class:`CGResult` with
    telemetry.
    """
    dev = operator.device
    b = from_numpy(b, dev, torch.float32)
    shift = torch.as_tensor(shift, dtype=torch.float32, device=dev)
    if isinstance(operator, api.PlanBatch):
        batch = operator
        if batch.spec.max_nbr is None:
            raise ValueError("profile-only batch (with_bsr=False) has no "
                             "storage; rebuild with with_bsr=True")
        if b.ndim not in (2, 3) or b.shape[0] != batch.batch \
                or b.shape[1] != batch.capacity:
            raise ValueError(
                f"batched right-hand side must be (B={batch.batch}, "
                f"capacity={batch.capacity}[, t]); got {tuple(b.shape)}")
        name = batch.resolve_backend(backend)
        prec, tol, maxiter = _solver_knobs(batch.spec.config, precond, tol,
                                           maxiter)
        return _solve_batch(batch, b, shift, tol, name, prec, maxiter)
    if isinstance(operator, api.ShardedPlan):   # its shards run B2 alone
        prec, tol, maxiter = _solver_knobs(operator.plan.config, precond,
                                           tol, maxiter)
        return _solve_sharded(operator, b, shift, tol, prec, maxiter)
    plan = operator
    plan._require_bsr()
    if b.shape[0] != plan.n:
        raise ValueError(f"right-hand side has {b.shape[0]} rows, plan "
                         f"capacity is {plan.n}")
    name = _plan_backend(plan, backend)
    prec, tol, maxiter = _solver_knobs(plan.config, precond, tol, maxiter)
    return _solve_single(plan, b, shift, tol, name, prec, maxiter)


# ---------------------------------------------------------------------------
# kernel ridge regression
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class KRRModel:
    """Fitted KRR weights + the solve's convergence telemetry.

    ``alpha`` is in original index order (``(capacity[, t])`` or
    ``(B, capacity[, t])``); dead/hole slots carry zeros. ``predict()``
    with no argument is the in-sample fit ``K alpha``; ``predict(x_new)``
    (single plans only) evaluates the cross-kernel sparsely through the
    k nearest *training* neighbors of each test point — the same
    near-neighbor truncation the training pattern uses.
    """
    operator: "Union[api.InteractionPlan, api.PlanBatch]"
    alpha: torch.Tensor
    lam: float
    self_weight: "float | torch.Tensor"     # per-lane (B,) under "auto"
    result: CGResult

    def predict(self, x_new=None, *, k: Optional[int] = None
                ) -> torch.Tensor:
        op = self.operator
        if x_new is None:
            sw = _lane_shift(torch.as_tensor(self.self_weight,
                                             dtype=torch.float32,
                                             device=op.device),
                             self.alpha.ndim)
            return op.matvec(self.alpha) + sw * self.alpha
        if isinstance(op, api.PlanBatch):
            raise NotImplementedError(
                "out-of-sample prediction is per-member: call "
                "batch.member(i) and fit/predict on the member plan")
        host = op.host
        if host.x is None:
            raise ValueError("plan carries no training coordinates "
                             "(built from_coo without x); out-of-sample "
                             "prediction needs them")
        x_new = np.asarray(to_numpy(x_new), np.float32)
        k = k or op.config.k
        idx, d2 = knn.knn_graph(x_new, host.x, k, valid=host.alive,
                                device=op.device)
        idx_np, d2_np = to_numpy(idx), to_numpy(d2)
        m = x_new.shape[0]
        w = api.edge_values(host, np.repeat(np.arange(m), k),
                            idx_np.reshape(-1), d2_np.reshape(-1))
        w = from_numpy(w.reshape(m, k), op.device)
        anbr = self.alpha[idx]
        if anbr.ndim == 2:                      # (m, k) neighbor weights
            return torch.sum(w * anbr, dim=1)
        return torch.sum(w[..., None] * anbr, dim=1)   # multi-target


def _auto_self_weight(op) -> torch.Tensor:
    """Gershgorin diagonal shift: the max weighted degree of the stored
    pattern (one apply of ones: one launch of the SpMV kernel on a CUDA
    plan). ``W + deg_max*I`` is diagonally dominant, hence PSD, for
    NONNEGATIVE edge weights — the kNN-truncated RBF kernel is indefinite
    in general (truncation destroys positive definiteness), and this shift
    is what makes the KRR system provably SPD whatever the data. Per-lane
    for a batch. Stays on the device (no host sync)."""
    if isinstance(op, api.PlanBatch):
        ones = torch.ones((op.batch, op.capacity), dtype=torch.float32,
                          device=op.device)
        return torch.amax(op.apply(ones), dim=-1)          # (B,)
    deg = op.apply(torch.ones(op.n, dtype=torch.float32, device=op.device))
    return torch.amax(deg)


def _resolve_self_weight(op, self_weight):
    if isinstance(self_weight, str):
        if self_weight != "auto":
            raise ValueError(f"self_weight must be a number or 'auto', "
                             f"got {self_weight!r}")
        return _auto_self_weight(op)
    return self_weight


def krr_fit(plan, y, lam: float, *,
            self_weight: "float | str" = "auto",
            backend: Optional[str] = None,
            precond: Optional[str] = None,
            tol: Optional[float] = None,
            maxiter: Optional[int] = None) -> KRRModel:
    """Fit ``(W + (self_weight + lam) I) alpha = y`` on one plan (or a
    sharded plan, whose model keeps the wrapped plan). ``lam > 0`` is
    required: dead/hole rows contribute a bare ``shift``
    diagonal. ``self_weight="auto"`` (default) uses the Gershgorin shift
    (see :func:`_auto_self_weight`) — the kNN-truncated kernel is NOT
    positive definite on clustered data, so a fixed ``self_weight=1.0``
    (the classical RBF diagonal) only converges when the truncation
    happens to stay definite. ``y``: ``(capacity,)`` or
    ``(capacity, t)``."""
    if lam <= 0:
        raise ValueError(f"krr needs lam > 0, got {lam}")
    sw = _resolve_self_weight(plan, self_weight)
    res = solve(plan, y, shift=sw + lam, backend=backend, precond=precond,
                tol=tol, maxiter=maxiter)
    op = plan.plan if isinstance(plan, api.ShardedPlan) else plan
    return KRRModel(operator=op, alpha=res.x, lam=lam, self_weight=sw,
                    result=res)


def krr_fit_batch(batch, ys, lam: float, *,
                  self_weight: "float | str" = "auto",
                  backend: Optional[str] = None,
                  precond: Optional[str] = None,
                  tol: Optional[float] = None,
                  maxiter: Optional[int] = None) -> KRRModel:
    """Fit B member systems in lockstep — every CG iteration is ONE
    batched apply for the whole batch (``self_weight="auto"`` adds one
    more for the per-lane Gershgorin shift). ``ys``: ``(B, capacity)`` or
    ``(B, capacity, t)`` (``batch.pad_charges`` packs ragged member
    targets)."""
    if lam <= 0:
        raise ValueError(f"krr needs lam > 0, got {lam}")
    sw = _resolve_self_weight(batch, self_weight)
    res = solve(batch, ys, shift=sw + lam, backend=backend,
                precond=precond, tol=tol, maxiter=maxiter)
    return KRRModel(operator=batch, alpha=res.x, lam=lam, self_weight=sw,
                    result=res)
