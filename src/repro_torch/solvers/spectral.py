"""Spectral embedding over a KDE-weighted similarity graph on the plan.

The plan's kNN pattern *is* a similarity graph waiting for weights: dress
the edges with a Gaussian KDE kernel ``w_ij = exp(-d_ij^2 / (2 h^2))``,
degree-normalize, and the top eigenvectors of

    N = D^{-1/2} W D^{-1/2}

are the classic normalized-Laplacian spectral embedding (``L_sym = I - N``
— top of ``N`` == bottom of ``L_sym``). Nothing is ever densified: ``W``
lives in the plan's ELL-BSR, ``D`` is one matvec of ones, and
``repro_torch.solvers.lanczos`` extracts the Ritz pairs from matvecs alone
(one SpMV launch per Lanczos iteration on a CUDA plan).

Two entry shapes:

  * :func:`similarity_plan` builds the dressed plan from raw points
    (``symmetrize=True`` — CG/Lanczos need the symmetric pattern; the
    bandwidth defaults to the median kNN distance, the usual
    self-tuning heuristic, pinned on the kernel so streaming refresh
    re-dresses patched rows consistently);
  * :func:`redress_rbf` re-dresses an EXISTING plan's pattern through
    ``api.edge_values`` — binary kNN plans from earlier stages become
    KDE similarity graphs without rebuilding ordering or storage.

Streamed plans work mid-lifecycle: dead slots have zero similarity
rows/columns, their degree is clamped, and the scaling zeroes them out of
the operator — they sit in the kernel's nullspace, invisible to the top
of the spectrum.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch import api
from repro_torch.solvers.lanczos import lanczos_eigsh

__all__ = ["RBFValues", "similarity_plan", "redress_rbf",
           "normalized_operator", "spectral_embedding"]


class RBFValues:
    """Gaussian edge kernel ``exp(-d2 / (2 h^2))`` in the plan's values
    protocol ``f(rows, cols, d2) -> vals`` (numpy arrays in and out).

    ``bandwidth=None`` self-tunes: the first batch of edges pins ``h`` to
    the median kNN distance (so later re-dressings — streaming refresh
    patches, out-of-sample cross kernels — reuse the SAME bandwidth and
    stay consistent with the stored weights)."""

    def __init__(self, bandwidth: Optional[float] = None):
        self.bandwidth = None if bandwidth is None else float(bandwidth)

    def __call__(self, rows, cols, d2):
        d2 = np.asarray(d2, np.float32)
        if self.bandwidth is None:
            med = float(np.median(d2[d2 > 0])) if (d2 > 0).any() else 1.0
            self.bandwidth = float(np.sqrt(med))
        h2 = max(self.bandwidth * self.bandwidth, 1e-12)
        return np.exp(-d2 / (2.0 * h2)).astype(np.float32)


def similarity_plan(x, *, k: int = 16,
                    bandwidth: Optional[float] = None,
                    **build_kwargs) -> "api.InteractionPlan":
    """Build a KDE similarity plan over points ``x`` (n, D): symmetrized
    kNN pattern, RBF-dressed edges. Extra kwargs flow to
    :func:`repro_torch.api.build_plan` (``bs``, ``ordering``,
    ``capacity``, ``device``...)."""
    build_kwargs.setdefault("symmetrize", True)
    if not build_kwargs["symmetrize"]:
        raise ValueError("spectral embedding needs a symmetric similarity "
                         "pattern; symmetrize=False breaks it")
    return api.build_plan(x, k=k, values=RBFValues(bandwidth),
                          **build_kwargs)


def redress_rbf(plan: "api.InteractionPlan",
                bandwidth: Optional[float] = None) -> "api.InteractionPlan":
    """Re-dress an existing plan's pattern with the RBF kernel.

    Keeps ordering and storage shapes (``with_values``); only the edge
    weights change, computed through ``api.edge_values`` so the dressing
    goes through the same seam streaming refresh uses. The plan must
    carry coordinates (``host.x``)."""
    host = plan.host
    if host.x is None:
        raise ValueError("plan carries no coordinates (built from_coo "
                         "without x); cannot compute edge distances")
    r2, c2, _ = plan.coo                       # cluster index space
    x_cl = np.asarray(host.x, np.float32)[host.pi]
    diff = x_cl[r2] - x_cl[c2]
    d2 = np.einsum("ij,ij->i", diff, diff)
    fn = RBFValues(bandwidth)
    dressed = dataclasses.replace(host, values_mode="fn", values_fn=fn)
    vals = api.edge_values(dressed, r2, c2, d2)
    out = plan.with_values(vals)
    out.host.values_mode = "fn"                # refresh re-dresses via fn
    out.host.values_fn = fn
    return out


def normalized_operator(plan: "api.InteractionPlan",
                        backend: Optional[str] = None,
                        eps: float = 1e-12):
    """The degree-normalized similarity ``N = D^{-1/2} W' D^{-1/2}`` as a
    matvec over CLUSTER-ordered vectors. Returns ``(N, deg)`` with ``deg``
    the cluster-order degree vector (one matvec of ones; zero-degree —
    dead or isolated — slots are scaled out of the operator)."""
    from repro_torch.solvers.krr import _plan_backend

    plan._require_bsr()
    name = _plan_backend(plan, backend)
    deg = plan.apply(torch.ones(plan.n, dtype=torch.float32,
                                device=plan.device), backend=name)
    s = torch.where(deg > eps, 1.0 / torch.sqrt(torch.clamp_min(deg, eps)),
                    0.0)

    def N(v: torch.Tensor) -> torch.Tensor:
        return s * plan.apply(s * v, backend=name)

    return N, deg


def spectral_embedding(x=None, *, plan: "api.InteractionPlan" = None,
                       n_components: int = 2, k: int = 16,
                       bandwidth: Optional[float] = None,
                       m: int = 0, seed: int = 0,
                       backend: Optional[str] = None,
                       drop_first: bool = True,
                       v0: Optional[torch.Tensor] = None,
                       **build_kwargs
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Spectral embedding of points (or of an existing plan's graph).

    Pass raw points ``x`` (n, D) — a KDE :func:`similarity_plan` is
    built (``device=`` in ``build_kwargs``, ``None`` = ``"cuda"``) — or
    ``plan=`` an already-built symmetric plan, which is re-dressed with
    the RBF kernel through :func:`redress_rbf` (pass ``bandwidth=0`` to
    keep the plan's existing weights). Lanczos extracts the top
    ``n_components (+1)`` Ritz pairs of ``N`` from ``v0`` (cluster order)
    or from a start vector drawn with ``seed`` on the plan's device;
    ``drop_first`` discards the trivial top eigenvector (``D^{1/2} 1``,
    eigenvalue ~1 on a connected graph).

    Returns ``(w, Y)``: eigenvalues ``(n_components,)`` descending and
    the embedding ``Y`` ``(capacity, n_components)`` in ORIGINAL index
    order (dead slots read ~0).
    """
    if (x is None) == (plan is None):
        raise ValueError("pass exactly one of x= (points) or plan=")
    if plan is None:
        plan = similarity_plan(x, k=k, bandwidth=bandwidth, **build_kwargs)
    elif bandwidth != 0:
        plan = redress_rbf(plan, bandwidth)
    N, _deg = normalized_operator(plan, backend=backend)
    k_ritz = n_components + (1 if drop_first else 0)
    w, U = lanczos_eigsh(N, plan.n, k_ritz, m=m, seed=seed, v0=v0,
                         largest=True, device=plan.device)
    if drop_first:
        w, U = w[1:], U[:, 1:]
    return w, plan.unpermute(U)
