"""Unified planner API: one object from points -> ordering -> BSR -> SpMV.

The paper's method is a pipeline; ``build_plan`` runs it end-to-end and
returns an :class:`InteractionPlan` that owns every stage's artifact:

  paper section                       plan artifact
  -------------------------------------------------------------------------
  §2.2  patch-density model           ``plan.gamma`` (Eq. 4 score of the
                                      reordered pattern), ``plan.fill``
  §2.3  ordering quality (γ-score)    computed per ordering; compare by
                                      building profile-only plans
                                      (``with_bsr=False``) per ordering
  §2.4  step 1: low-dim embedding     ``plan.embedding`` (PCA coords)
  §2.4  step 2: hierarchical          ``plan.tree`` (adaptive 2^d tree),
        partitioning                  ``plan.pi`` / ``permute`` /
                                      ``unpermute`` (cluster ordering)
  §2.4  step 3: multi-level           ``plan.bsr`` (two-level ELL-BSR)
        compressed storage
  §2.4  step 4: block-segment         ``plan.apply`` / ``plan.matvec`` over
        interaction                   the pluggable backend registry

Index spaces: ``plan.apply(x)`` computes ``y = A' x`` in *cluster order*
(``A' = P A Pᵀ``); ``plan.matvec(x)`` is the original-order convenience
``unpermute(apply(permute(x)))``. Backends are named entries in
``repro_torch.core.registry`` (``csr``, ``bsr``, ``bsr_ml``, ``cuda``, plus
anything user-registered). ``backend="auto"`` resolves to ``"cuda"`` (the
hand-written kernel) for a plan on a CUDA device and to ``"bsr"`` for a
plan on the CPU.

Devices: every entry point takes ``device=None`` and ``None`` means
``"cuda"``; with no card it raises. A plan lives on one device
(``plan.device``): its tiles, indices and permutation are tensors there,
while the tree, the COO pattern and the bookkeeping stay on the host in
numpy.

Spec/data split: every plan factors into a hashable, structure-only
:class:`PlanSpec` (config + capacity + ELL-BSR layout) and an array-only
:class:`PlanData` (pi/inv, BSR tensors, alive mask);
``InteractionPlan.from_spec_data`` reconstructs a working plan from the
pair.

The plan lifecycle of the reference (refresh, streaming inserts/deletes,
sharding, solvers, batched plans, the iterative-application hooks) is not
ported yet; those entry points raise ``NotImplementedError`` naming what
they wait for.
"""
from __future__ import annotations

import dataclasses
import time
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch._device import DeviceLike, from_numpy, resolve_device, to_numpy
from repro_torch.core import knn, measures
from repro_torch.core import ordering as ordering_mod
from repro_torch.core.blocksparse import BSR, build_bsr
from repro_torch.core.embedding import apply_pca_map, embed, pca_map
from repro_torch.core.hierarchy import Tree, build_tree
from repro_torch.core.ordering import ORDERINGS  # noqa: F401  (re-export)
from repro_torch.core.registry import (backend_names,  # noqa: F401
                                       get_backend, get_batched_backend,
                                       preconditioner_names,
                                       register_backend,
                                       register_batched_backend)

__all__ = [
    "PlanConfig", "PlanSpec", "PlanData", "InteractionPlan", "PlanBatch",
    "RefreshStats", "build_plan", "build_plan_batch", "refresh_plan",
    "update_plan", "cluster_order", "ORDERINGS",
    "register_backend", "register_batched_backend", "backend_names",
    "get_backend", "get_batched_backend", "preconditioner_names",
]


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (port queue item {item} "
        "in ROADMAP.md)")


@dataclass(frozen=True)
class PlanConfig:
    """Static knobs of an interaction plan (hashable).

    Validated at construction: a bad threshold raises a ``ValueError``
    here, not deep inside a later stage. The lifecycle and solver knobs
    are kept (and validated) so a config crosses over from the reference
    unchanged, though the port does not act on them yet.
    """
    k: int = 16                  # neighbors per target (Eq. 1 pattern)
    ordering: str = "dual_tree"  # one of core.ordering.ORDERINGS
    bs: int = 32                 # bottom-level tile size
    sb: int = 8                  # superblock size, in tiles
    backend: str = "auto"        # registry name or "auto"
    d: int = 3                   # embedding dimension (§2.4 step 1)
    bits: int = 10               # Morton quantization bits per dim
    leaf_size: int = 64          # adaptive-tree leaf bound (§2.4 step 2)
    symmetrize: bool = False     # symmetrize the kNN pattern
    seed: int = 0
    # -- refresh lifecycle ---------------------------------------------------
    refresh_policy: str = "auto"  # auto | patch | rebucket | rebuild
    patch_frac: float = 0.10
    rebuild_frac: float = 0.40
    drift_tol: float = 0.25
    ell_slack: int = 0           # spare ELL tile slots per row-block
    # -- streaming -----------------------------------------------------------
    max_dead_frac: float = 0.25
    grow_frac: float = 0.25
    gamma_tol: float = 0.05
    # -- iterative solvers ---------------------------------------------------
    cg_tol: float = 1e-5
    cg_maxiter: int = 256
    precond: str = "block_jacobi"

    def __post_init__(self):
        if self.ell_slack < 0:
            raise ValueError(
                f"ell_slack must be >= 0, got {self.ell_slack}")
        for fname in ("patch_frac", "rebuild_frac", "drift_tol",
                      "gamma_tol"):
            v = getattr(self, fname)
            if not (isinstance(v, (int, float)) and 0.0 <= v <= 1.0):
                raise ValueError(
                    f"{fname} must be a fraction in [0, 1], got {v!r}")
        if self.patch_frac > self.rebuild_frac:
            raise ValueError(
                f"patch_frac={self.patch_frac} > rebuild_frac="
                f"{self.rebuild_frac}: the auto policy would escalate to "
                "rebuild before patch ever applied")
        if not 0.0 < self.max_dead_frac <= 1.0:
            raise ValueError(
                f"max_dead_frac must be in (0, 1], got {self.max_dead_frac}")
        if self.grow_frac <= 0.0:
            raise ValueError(
                f"grow_frac must be > 0, got {self.grow_frac}")
        if not (isinstance(self.cg_tol, (int, float)) and self.cg_tol > 0):
            raise ValueError(
                f"cg_tol must be a positive relative tolerance, got "
                f"{self.cg_tol!r}")
        if not (isinstance(self.cg_maxiter, int) and self.cg_maxiter >= 1):
            raise ValueError(
                f"cg_maxiter must be an int >= 1, got {self.cg_maxiter!r}")
        if self.precond not in preconditioner_names():
            raise ValueError(
                f"unknown preconditioner {self.precond!r}; registered: "
                f"{preconditioner_names()}")


@dataclass(frozen=True)
class PlanSpec:
    """The structure-only half of a plan (hashable; shared across a batch).

    Everything that fixes tensor *shapes* lives here: the config knobs, the
    physical capacity, and the ELL-BSR layout. Two plans with equal specs
    are shape-compatible — their :class:`PlanData` stack on a leading batch
    axis and one kernel launch serves all of them.

    ``bs``/``sb``/``n_rb``/``n_cb``/``max_nbr`` are ``None`` for
    profile-only plans (``with_bsr=False``).
    """
    config: PlanConfig
    capacity: int                 # physical row slots (plan.n)
    bs: Optional[int] = None      # BSR layout, None when no storage
    sb: Optional[int] = None
    n_rb: Optional[int] = None
    n_cb: Optional[int] = None
    max_nbr: Optional[int] = None

    @property
    def shape_key(self) -> tuple:
        """Structural key without the config."""
        return (self.capacity, self.bs, self.sb, self.n_rb, self.n_cb,
                self.max_nbr)


@dataclasses.dataclass
class PlanData:
    """The array-only half of a plan: exactly the device tensors a plan's
    compute path reads — the permutation pair, the ELL-BSR tensors, and
    (for plans with dead slots) the row-validity mask."""
    pi: torch.Tensor
    inv: torch.Tensor
    col_idx: Optional[torch.Tensor] = None
    nbr_mask: Optional[torch.Tensor] = None
    vals: Optional[torch.Tensor] = None
    alive: Optional[torch.Tensor] = None


@dataclasses.dataclass
class RefreshStats:
    """Lifecycle telemetry of a plan lineage (mutable, host-side). Only the
    fields cross over for now; the tiers that move them are not ported."""
    builds: int = 1
    patches: int = 0
    rebuckets: int = 0
    rebuilds: int = 0
    last_action: str = "build"
    last_migrated_frac: float = 0.0
    ordering_drift_frac: float = 0.0
    patched_rows: int = 0
    fill0: Optional[float] = None     # fill at last (re)build of the layout
    gamma0: Optional[float] = None    # γ reference for gamma_drift
    degraded: bool = False
    appends: int = 0
    tombstones: int = 0
    compactions: int = 0
    restripes: int = 0
    grows: int = 0
    inserted_total: int = 0
    deleted_total: int = 0


@dataclasses.dataclass(eq=False)
class _PlanHost:
    """Host-side (numpy) artifacts of a plan."""
    pi: np.ndarray                       # sorted position -> original index
    inv: np.ndarray                      # original index -> sorted position
    coo: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]  # reordered
    tree: Optional[Tree]
    embedding: Optional[np.ndarray]      # (n, d) PCA coords the ordering
    #   was derived from
    sigma: float = 1.0                   # γ-score bandwidth (Eq. 4)
    gamma: Optional[float] = None        # lazily scored on first access
    coo_dev: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None
    embed_mean: Optional[np.ndarray] = None   # (D,) fitted PCA map
    embed_axes: Optional[np.ndarray] = None   # (D, d)
    y_last: Optional[np.ndarray] = None
    sources: Optional[np.ndarray] = None  # fixed source set, original order
    pattern_from_knn: bool = False       # pattern derives from the coords
    values_mode: str = "ones"            # ones | fn | static
    values_fn: Optional[Callable] = None
    refresh: RefreshStats = dataclasses.field(default_factory=RefreshStats)
    x: Optional[np.ndarray] = None       # (capacity, D) original coords
    alive: Optional[np.ndarray] = None   # (capacity,) bool row validity;
    #   None means every physical slot holds a live point
    timings: dict = dataclasses.field(default_factory=dict)
    # ^ wall seconds of the build stages (knn, embedding, tree, build_bsr)


@contextmanager
def _stage(timings: dict, name: str, device: torch.device):
    """Wall time of one build stage, with the device drained at its end so
    the time belongs to the stage that queued the work."""
    t0 = time.perf_counter()
    yield
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    timings[name] = timings.get(name, 0.0) + time.perf_counter() - t0


def _symmetrize_pattern(rows: np.ndarray, cols: np.ndarray,
                        aux: np.ndarray, n: int):
    """Pattern-union symmetrization; first occurrence of an (i, j) wins
    for the rider array ``aux`` (values or distances)."""
    r2 = np.concatenate([rows, cols])
    c2 = np.concatenate([cols, rows])
    a2 = np.concatenate([aux, aux])
    key = r2.astype(np.int64) * n + c2
    _, first = np.unique(key, return_index=True)
    return r2[first], c2[first], a2[first]


class InteractionPlan:
    """Planner object owning ordering, storage, and compute backend.

    One plan = the pipeline's artifacts over one point set: the
    principal-axis embedding frame, the 2^d-tree ordering
    (``pi``/``inv``), the γ profile score, and the two-level ELL-BSR
    storage on ``device``, plus host-side state (COO edges, tree).
    Compute (:meth:`matvec`/:meth:`apply`) dispatches through the backend
    registry. A plan is never mutated: :meth:`with_values` returns a new
    one.
    """

    def __init__(self, config: PlanConfig, n: int, bsr: Optional[BSR],
                 pi: torch.Tensor, inv: torch.Tensor, host: _PlanHost):
        self.config = config
        self.n = n
        self.bsr = bsr
        self.pi = pi
        self.inv = inv
        self.host = host

    @property
    def device(self) -> torch.device:
        return self.pi.device

    # -- construction ------------------------------------------------------

    @classmethod
    def from_coo(cls, rows, cols, vals, n: int, *,
                 x: Optional[np.ndarray] = None,
                 pi: Optional[np.ndarray] = None,
                 config: Optional[PlanConfig] = None,
                 sigma: Optional[float] = None,
                 with_bsr: bool = True,
                 max_nbr: Optional[int] = None,
                 device: DeviceLike = None,
                 _symmetrized: bool = False,
                 _timings: Optional[dict] = None,
                 **overrides) -> "InteractionPlan":
        """Plan from an explicit COO pattern (original index space).

        The ordering is ``pi`` if given, else computed from ``x`` with
        ``config.ordering``, else identity (pattern already cluster-ordered).
        """
        dev = resolve_device(device)
        config = dataclasses.replace(config or PlanConfig(), **overrides)
        timings = {} if _timings is None else _timings
        rows = to_numpy(rows)
        cols = to_numpy(cols)
        vals = (np.ones(len(rows), np.float32) if vals is None
                else np.asarray(to_numpy(vals), np.float32))
        if config.symmetrize and not _symmetrized:
            rows, cols, vals = _symmetrize_pattern(rows, cols, vals, n)

        tree = None
        embedding = None
        emean = eaxes = None
        if pi is None and x is not None:
            x = np.asarray(to_numpy(x), np.float32)
            if config.ordering == "dual_tree":
                d = min(config.d, x.shape[1])
                with _stage(timings, "embedding", dev):
                    xd = from_numpy(x, dev)
                    emean_t, eaxes_t = pca_map(xd, d, device=dev)
                    y = apply_pca_map(xd, emean_t, eaxes_t, device=dev)
                    emean, eaxes = to_numpy(emean_t), to_numpy(eaxes_t)
                    embedding = to_numpy(y)
                    del xd
                with _stage(timings, "tree", dev):
                    tree = build_tree(y, bits=config.bits,
                                      leaf_size=config.leaf_size, device=dev)
                pi = tree.perm
            else:
                with _stage(timings, "ordering", dev):
                    pi = ordering_mod.compute_ordering(
                        config.ordering, x, rows, cols, seed=config.seed,
                        device=dev)
        if pi is None:
            pi = np.arange(n)
        pi = np.asarray(pi)
        inv = np.empty_like(pi)
        inv[pi] = np.arange(n)

        r2, c2 = ordering_mod.apply_ordering(rows, cols, pi)
        sigma = sigma if sigma is not None else max(config.k / 2.0, 1.0)
        bsr = None
        if with_bsr:
            with _stage(timings, "build_bsr", dev):
                bsr = build_bsr(r2, c2, vals, n, bs=config.bs, sb=config.sb,
                                max_nbr=max_nbr, slack=config.ell_slack,
                                device=dev)
        host = _PlanHost(pi=pi, inv=inv, coo=(r2, c2, vals), tree=tree,
                         embedding=embedding, sigma=sigma,
                         embed_mean=emean, embed_axes=eaxes,
                         y_last=embedding, x=x, timings=timings)
        host.refresh.fill0 = bsr.fill if bsr is not None else None
        return cls(config, n, bsr, from_numpy(pi, dev, torch.int64),
                   from_numpy(inv, dev, torch.int64), host)

    @classmethod
    def from_spec_data(cls, spec: PlanSpec, data: PlanData,
                       host: Optional[_PlanHost] = None,
                       fill: float = 0.0) -> "InteractionPlan":
        """Thin view over a (spec, data) pair — the split's constructor.

        ``spec`` pins shapes, ``data`` carries every tensor (and with them
        the device). With no ``host``, a minimal host is derived so the
        view is a fully working single plan. ``fill`` dresses the
        reconstructed BSR's (data-dependent) fill statistic.
        """
        bsr = None
        if spec.max_nbr is not None and data.vals is not None:
            bsr = BSR(bs=spec.bs, sb=spec.sb, n=spec.capacity,
                      n_rb=spec.n_rb, n_cb=spec.n_cb, col_idx=data.col_idx,
                      nbr_mask=data.nbr_mask, vals=data.vals, fill=fill,
                      max_nbr=spec.max_nbr)
        if host is None:
            host = _PlanHost(pi=to_numpy(data.pi), inv=to_numpy(data.inv),
                             coo=None, tree=None, embedding=None,
                             alive=(None if data.alive is None
                                    else to_numpy(data.alive)))
        return cls(spec.config, spec.capacity, bsr, data.pi.long(),
                   data.inv.long(), host)

    @classmethod
    def from_bsr(cls, bsr: BSR,
                 config: Optional[PlanConfig] = None) -> "InteractionPlan":
        """Wrap an existing BSR (identity ordering, no COO/tree/gamma); the
        plan lives on the BSR's device."""
        config = config or PlanConfig(bs=bsr.bs, sb=bsr.sb, backend="bsr")
        pi = np.arange(bsr.n)
        host = _PlanHost(pi=pi, inv=pi, coo=None, tree=None, embedding=None)
        dev = torch.arange(bsr.n, dtype=torch.int64, device=bsr.device)
        return cls(config, bsr.n, bsr, dev, dev, host)

    # -- spec/data split ---------------------------------------------------

    @property
    def spec(self) -> PlanSpec:
        """Structure-only half: hashable, shared by shape-compatible
        plans (see :class:`PlanSpec`)."""
        b = self.bsr
        if b is None:
            return PlanSpec(config=self.config, capacity=self.n)
        return PlanSpec(config=self.config, capacity=self.n, bs=b.bs,
                        sb=b.sb, n_rb=b.n_rb, n_cb=b.n_cb,
                        max_nbr=b.max_nbr)

    @property
    def data(self) -> PlanData:
        """Array-only half: the tensors this plan's compute path reads.
        ``from_spec_data(spec, data)`` reconstructs an equivalent view."""
        b = self.bsr
        alive = (None if self.host.alive is None
                 else from_numpy(self.host.alive, self.device))
        if b is None:
            return PlanData(pi=self.pi, inv=self.inv, alive=alive)
        return PlanData(pi=self.pi, inv=self.inv, col_idx=b.col_idx,
                        nbr_mask=b.nbr_mask, vals=b.vals, alive=alive)

    # -- stage artifacts ---------------------------------------------------

    @property
    def tree(self) -> Optional[Tree]:
        """The 2^d hierarchy the ordering was derived from."""
        return self.host.tree

    @property
    def embedding(self) -> Optional[np.ndarray]:
        """Principal-axis embedding of the points (n, d) — the image the
        tree ordered (§2.2)."""
        return self.host.embedding

    @property
    def coo(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Reordered COO ``(rows, cols, vals)`` (cluster index space)."""
        if self.host.coo is None:
            raise ValueError("plan has no COO pattern (built from_bsr)")
        return self.host.coo

    def coo_device(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Reordered COO as device tensors (cached — the csr backend is
        called repeatedly and must not re-upload O(nnz) data per call)."""
        if self.host.coo_dev is None:
            r, c, v = self.coo
            self.host.coo_dev = (from_numpy(r, self.device, torch.int64),
                                 from_numpy(c, self.device, torch.int64),
                                 from_numpy(v, self.device, torch.float32))
        return self.host.coo_dev

    # -- logical n vs physical capacity ------------------------------------

    @property
    def capacity(self) -> int:
        """Physical row slots (== ``plan.n``, the matvec dimension every
        backend sees)."""
        return self.n

    @property
    def alive(self) -> np.ndarray:
        """Row-validity mask over physical slots (original index space)."""
        if self.host.alive is None:
            return np.ones(self.n, bool)
        return self.host.alive

    @property
    def n_alive(self) -> int:
        """Logical point count: physical slots holding a live point."""
        if self.host.alive is None:
            return self.n
        return int(self.host.alive.sum())

    @property
    def dead_frac(self) -> float:
        """Tombstoned fraction of capacity."""
        return 1.0 - self.n_alive / max(self.n, 1)

    @property
    def gamma(self) -> Optional[float]:
        """γ-score (Eq. 4) of the reordered pattern, computed lazily.

        Dead rows are ignored: the live pattern is projected to compacted
        (hole-free) coordinates before scoring."""
        if self.host.gamma is None and self.host.coo is not None:
            r2, c2, _ = self.host.coo
            n_eff = self.n
            if self.host.alive is not None and not self.host.alive.all():
                r2, c2, n_eff = measures.compact_live(
                    r2, c2, self.host.alive[self.host.pi])
            self.host.gamma = float(measures.gamma_score(
                r2, c2, self.host.sigma, n_eff, device=self.device))
        return self.host.gamma

    @property
    def fill(self) -> Optional[float]:
        """Dense-entry fraction of the kept ELL tiles (``None`` for
        profile-only plans)."""
        return self.bsr.fill if self.bsr is not None else None

    @property
    def stats(self) -> dict:
        """One-call telemetry: live count, capacity, dead fraction, γ,
        fill, kept tiles, ELL width, and the resolved backend."""
        kept = (int(self.bsr.nbr_mask.sum()) if self.bsr is not None else 0)
        return {"n": self.n_alive, "capacity": self.capacity,
                "dead_frac": self.dead_frac,
                "gamma": self.gamma, "fill": self.fill,
                "kept_tiles": kept,
                "max_nbr": self.bsr.max_nbr if self.bsr else None,
                "backend": self.resolve_backend()}

    # -- permutation helpers (§2.4 step 2) ---------------------------------

    def permute(self, a):
        """Original order -> cluster order along the leading axis (numpy in,
        numpy out; tensor in, tensor out on the plan's device)."""
        if isinstance(a, np.ndarray):
            return a[self.host.pi]
        return torch.index_select(from_numpy(a, self.device), 0, self.pi)

    def unpermute(self, a):
        """Cluster order -> original order along the leading axis."""
        if isinstance(a, np.ndarray):
            return a[self.host.inv]
        return torch.index_select(from_numpy(a, self.device), 0, self.inv)

    # -- backend resolution ------------------------------------------------

    def resolve_backend(self, name: Optional[str] = None) -> str:
        """Resolve ``name`` (default: the config backend). ``"auto"`` is
        ``"cuda"`` — the hand-written kernel — for a plan on a CUDA device
        and ``"bsr"`` for a plan on the CPU."""
        name = name or self.config.backend
        if name != "auto":
            return name
        return "cuda" if self.device.type == "cuda" else "bsr"

    # -- interaction (§2.4 step 4) -----------------------------------------

    def apply(self, x, backend: Optional[str] = None,
              **kwargs) -> torch.Tensor:
        """``y = A' x`` in cluster order (``A'`` the reordered matrix).
        ``x`` (n,) or (n, f): a tensor, or an array moved to the plan's
        device."""
        name = self.resolve_backend(backend)
        if self.bsr is None and name != "csr":
            raise ValueError(
                f"profile-only plan has no BSR for backend {name!r}; "
                "rebuild with with_bsr=True (only 'csr' runs off the COO)")
        x = from_numpy(x, self.device, torch.float32)
        return get_backend(name)(self, x, **kwargs)

    def matvec(self, x, backend: Optional[str] = None,
               **kwargs) -> torch.Tensor:
        """``y = A x`` in original order: unpermute ∘ apply ∘ permute."""
        x = from_numpy(x, self.device, torch.float32)
        return self.unpermute(self.apply(self.permute(x), backend, **kwargs))

    def with_values(self, vals) -> "InteractionPlan":
        """New plan with the same pattern/ordering but fresh edge values
        (aligned with ``plan.coo``). Storage shapes are pinned (``max_nbr``
        carried over)."""
        r2, c2, _ = self.coo
        vals = np.asarray(to_numpy(vals), np.float32)
        b = self._require_bsr()
        bsr = build_bsr(r2, c2, vals, self.n, bs=b.bs, sb=b.sb,
                        max_nbr=b.max_nbr, device=self.device)
        host = dataclasses.replace(self.host, coo=(r2, c2, vals),
                                   coo_dev=None)
        return InteractionPlan(self.config, self.n, bsr, self.pi, self.inv,
                               host)

    # -- not ported yet ------------------------------------------------------

    def solve(self, *args, **kwargs):
        raise _not_ported("plan.solve", "A8")

    def eigs(self, *args, **kwargs):
        raise _not_ported("plan.eigs", "A8")

    def tsne_attractive(self, *args, **kwargs):
        raise _not_ported("plan.tsne_attractive", "A3")

    def meanshift_step(self, *args, **kwargs):
        raise _not_ported("plan.meanshift_step", "A3")

    def shard(self, *args, **kwargs):
        raise _not_ported("plan.shard", "A11")

    def refresh(self, *args, **kwargs):
        raise _not_ported("plan.refresh", "A6")

    def insert(self, *args, **kwargs):
        raise _not_ported("plan.insert", "A6")

    def delete(self, *args, **kwargs):
        raise _not_ported("plan.delete", "A6")

    def update(self, *args, **kwargs):
        raise _not_ported("plan.update", "A6")

    def compact(self, *args, **kwargs):
        raise _not_ported("plan.compact", "A6")

    @property
    def refresh_stats(self) -> RefreshStats:
        """Lifecycle counters for this plan lineage."""
        return self.host.refresh

    def _require_bsr(self) -> BSR:
        if self.bsr is None:
            raise ValueError("profile-only plan: rebuild with with_bsr=True")
        return self.bsr

    def __repr__(self) -> str:
        g = (f"{self.host.gamma:.2f}" if self.host.gamma is not None
             else "unscored" if self.host.coo is not None else "n/a")
        f = f"{self.fill:.3f}" if self.fill is not None else "n/a"
        size = (f"n={self.n}" if self.host.alive is None
                else f"n={self.n_alive}/cap={self.capacity}")
        return (f"InteractionPlan({size}, ordering="
                f"{self.config.ordering!r}, bs={self.config.bs}, "
                f"sb={self.config.sb}, gamma={g}, fill={f}, "
                f"backend={self.config.backend!r}, "
                f"device={str(self.device)!r})")


class PlanBatch:
    """Stacked spec-identical plans — not ported yet."""

    def __init__(self, *args, **kwargs):
        raise _not_ported("PlanBatch", "A4")


def build_plan_batch(*args, **kwargs):
    raise _not_ported("build_plan_batch", "A4")


def refresh_plan(*args, **kwargs):
    raise _not_ported("refresh_plan", "A6")


def update_plan(*args, **kwargs):
    raise _not_ported("update_plan", "A6")


def cluster_order(x, *, ordering: str = "dual_tree", d: int = 3,
                  bits: int = 10, leaf_size: int = 64,
                  seed: int = 0, device: DeviceLike = None) -> np.ndarray:
    """Pipeline steps 1–2 only (§2.4): the cluster permutation of ``x``,
    with no interaction pattern built. Graph-based orderings (``rcm``) need
    a pattern — use :func:`build_plan` for those.
    """
    dev = resolve_device(device)
    x = np.asarray(to_numpy(x), np.float32)
    if ordering == "rcm":
        raise ValueError("rcm needs an interaction pattern; use build_plan")
    if ordering == "dual_tree":
        y = embed(x, d, device=dev)
        return build_tree(y, bits=bits, leaf_size=leaf_size, device=dev).perm
    return ordering_mod.compute_ordering(ordering, x, np.empty(0, np.int64),
                                         np.empty(0, np.int64), seed=seed,
                                         device=dev)


def build_plan(x, *, k: int = 16, ordering: str = "dual_tree", bs: int = 32,
               sb: int = 8, backend: str = "auto", d: int = 3,
               bits: int = 10, leaf_size: int = 64, symmetrize: bool = False,
               seed: int = 0,
               values: "np.ndarray | Callable | None" = None,
               sigma: Optional[float] = None,
               with_bsr: bool = True,
               sources: Optional[np.ndarray] = None,
               config: Optional[PlanConfig] = None,
               capacity: Optional[int] = None,
               device: DeviceLike = None,
               **cfg_overrides) -> InteractionPlan:
    """Run the full pipeline (§2.4) over points ``x`` (n, D) on ``device``
    (``None`` = ``"cuda"``; raises when there is no card).

    Builds the kNN interaction pattern (Eq. 1), orders it, scores it (γ,
    Eq. 4, lazily), and compresses it into the two-level ELL-BSR. ``values``
    dresses the pattern: ``None`` -> 1.0 per edge, an array aligned with the
    (row-major, post-symmetrization) kNN edges, or a callable
    ``f(rows, cols, dist2) -> vals`` over numpy arrays. ``with_bsr=False``
    builds a profile-only plan (ordering + γ, no storage) — cheap for
    comparing orderings as in §2.3. ``sources`` (n, D) switches to the
    fixed-source-set pattern of §3.2: neighbors of the targets ``x`` among
    ``sources``; the target ordering is applied to both sides, so both must
    have n points. ``config`` overrides every individual knob at once.
    ``capacity`` beyond ``len(x)`` (pre-allocated streaming slots) is not
    ported yet and raises ``NotImplementedError``.

    Example:
        >>> import numpy as np
        >>> from repro_torch import api
        >>> x = np.random.default_rng(0).standard_normal((64, 8))
        >>> plan = api.build_plan(x, k=4, bs=8, sb=2, backend="bsr",
        ...                       device="cpu")
        >>> plan.n, plan.bsr.bs
        (64, 8)
        >>> tuple(plan.matvec(np.ones(64, np.float32)).shape)
        (64,)
    """
    dev = resolve_device(device)
    if config is None:
        config = PlanConfig(k=k, ordering=ordering, bs=bs, sb=sb,
                            backend=backend, d=d, bits=bits,
                            leaf_size=leaf_size, symmetrize=symmetrize,
                            seed=seed, **cfg_overrides)
    elif cfg_overrides:
        config = dataclasses.replace(config, **cfg_overrides)
    x = np.asarray(to_numpy(x), np.float32)
    n = x.shape[0]
    if capacity is not None:
        if capacity < n:
            raise ValueError(f"capacity={capacity} < n={n} points")
        if capacity > n:
            raise _not_ported("build_plan(capacity > n)", "A6")
    if sources is not None:
        sources = np.asarray(to_numpy(sources), np.float32)
        if sources.shape[0] != n:
            raise ValueError(
                f"sources has {sources.shape[0]} points, targets have {n}; "
                "one ordering indexes both sides of the square plan")
        if config.symmetrize:
            raise ValueError("symmetrize crosses the target/source index "
                             "spaces; not meaningful with fixed sources")
    timings: dict = {}
    with _stage(timings, "knn", dev):
        xd = from_numpy(x, dev)
        sd = xd if sources is None else from_numpy(sources, dev)
        rows, cols, d2 = (to_numpy(a) for a in knn.knn_coo(
            xd, sd, config.k, exclude_self=sources is None, device=dev))
        del xd, sd

    if config.symmetrize:
        # pattern-level symmetrization (first occurrence wins, like the
        # paper's Fig. 2 interaction patterns) — before values, so a
        # callable sees the symmetrized edge list
        rows, cols, d2 = _symmetrize_pattern(rows, cols, d2, n)

    if values is None:
        vals = np.ones(len(rows), np.float32)
    elif callable(values):
        vals = np.asarray(values(rows, cols, d2), np.float32)
    else:
        vals = np.asarray(to_numpy(values), np.float32)
        if vals.shape[0] != len(rows):
            raise ValueError(
                f"values has {vals.shape[0]} entries, pattern has "
                f"{len(rows)} edges (symmetrize={config.symmetrize})")

    plan = InteractionPlan.from_coo(rows, cols, vals, n, x=x, config=config,
                                    sigma=sigma, with_bsr=with_bsr,
                                    device=dev, _symmetrized=True,
                                    _timings=timings)
    plan.host.pattern_from_knn = True
    plan.host.sources = sources
    if callable(values):
        plan.host.values_mode = "fn"
        plan.host.values_fn = values
    elif values is not None:
        plan.host.values_mode = "static"
    return plan
