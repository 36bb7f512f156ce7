"""Matrix-free iterative solvers on the plan operator.

The plan substrate (build -> order -> ELL-BSR -> batched matvec) is this
subsystem's ONLY access to the interaction matrix: CG, Lanczos, kernel
ridge regression and spectral embedding all consume ``InteractionPlan`` /
``PlanBatch`` through their matvecs — on a CUDA plan one launch of the
hand-written SpMV kernel per solver iteration.

  cg        batched preconditioned conjugate gradient (telemetry, early
            exit, one loop for every lane)
  precond   preconditioner factories from the plan's own BSR diagonal
            (block-Jacobi via batched Cholesky; registry-resolved)
  krr       generic ``solve`` dispatch + kernel ridge regression
  lanczos   tridiagonalization with full reorthogonalization
  spectral  KDE similarity graph + normalized-Laplacian embedding

``krr``/``spectral`` import ``repro_torch.api`` and load lazily here so
that ``repro_torch.core.registry``'s preconditioner provider import (which
pulls this package in) never recurses into a partially-initialized
``api``.
"""
from __future__ import annotations

from repro_torch.solvers.cg import CGResult, cg
from repro_torch.solvers.lanczos import LanczosResult, lanczos, lanczos_eigsh
from repro_torch.solvers.precond import (block_jacobi, diag_tiles,
                                         diag_vector, identity, jacobi)

__all__ = [
    "CGResult", "cg",
    "LanczosResult", "lanczos", "lanczos_eigsh",
    "block_jacobi", "diag_tiles", "diag_vector", "identity", "jacobi",
    "KRRModel", "solve", "krr_fit", "krr_fit_batch",
    "RBFValues", "similarity_plan", "redress_rbf", "normalized_operator",
    "spectral_embedding",
]

_LAZY = {
    "KRRModel": "repro_torch.solvers.krr",
    "solve": "repro_torch.solvers.krr",
    "krr_fit": "repro_torch.solvers.krr",
    "krr_fit_batch": "repro_torch.solvers.krr",
    "RBFValues": "repro_torch.solvers.spectral",
    "similarity_plan": "repro_torch.solvers.spectral",
    "redress_rbf": "repro_torch.solvers.spectral",
    "normalized_operator": "repro_torch.solvers.spectral",
    "spectral_embedding": "repro_torch.solvers.spectral",
}


def __getattr__(name: str):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(mod), name)
