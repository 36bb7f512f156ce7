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

Iterative applications (paper §3): ``plan.tsne_attractive(y)`` computes
the t-SNE attractive force over the stored affinities — through the
hand-written CUDA kernel (``kernels/csrc/tsne_force.cu``) for a plan on a
CUDA device, through the plain blockwise path on the CPU or when the
caller names ``backend="bsr"`` — and ``plan.meanshift_step`` one
mean-shift iteration over the stored neighbor pattern. Both run in a loop
with ``plan.refresh(x_new)``, which escalates through the reference's
three tiers (patch / rebucket / rebuild) as the points move; a patch
updates the plan's tile tensors in place (see :func:`refresh_plan`).

Batched plans: :class:`PlanBatch` stacks spec-identical plans (one per
attention head in ClusterKV) and runs the whole batch through one batched
call — for the ``cuda`` backend one launch of the batched SpMV kernel;
``build_plan_batch`` builds the members and stacks them.

Not ported yet, raising ``NotImplementedError`` with their ROADMAP item:
the streaming half of the lifecycle (insert, delete, update, compact,
``update_plan``, ``capacity > n``, batches of members of different sizes),
sharding and the solvers.
"""
from __future__ import annotations

import dataclasses
import time
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch._device import DeviceLike, from_numpy, resolve_device, to_numpy
from repro_torch.core import hierarchy, interact, knn, measures
from repro_torch.core import ordering as ordering_mod
from repro_torch.core.blocksparse import BSR, append_rows, build_bsr, patch_bsr
from repro_torch.core.embedding import apply_pca_map, embed, pca_map
from repro_torch.core.hierarchy import Tree, build_tree
from repro_torch.core.ordering import ORDERINGS  # noqa: F401  (re-export)
from repro_torch.core.registry import (backend_names,  # noqa: F401
                                       get_backend, get_batched_backend,
                                       preconditioner_names,
                                       register_backend,
                                       register_batched_backend)
from repro_torch.kernels import ops as kernel_ops

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
    """Lifecycle telemetry of a plan lineage (mutable, host-side). The
    refresh tiers move the first block of fields; the streaming counters
    (appends ... deleted_total) cross over but nothing in the port moves
    them yet."""
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

    # -- iterative value-update hooks (paper §3) ---------------------------

    def tsne_attractive(self, y, backend: Optional[str] = None
                        ) -> torch.Tensor:
        """t-SNE attractive force (§3.1) on embedding ``y`` (n, d), cluster
        order; the stored tiles are the (fixed-profile) affinities ``p``.

        ``backend``: ``None``/``"auto"`` launches the CUDA kernel for a plan
        on a CUDA device and takes the plain blockwise path for a plan on
        the CPU; ``"cuda"`` is the kernel (``kernels.ops.tsne_force``);
        ``"bsr"`` is the plain blockwise path (``interact.tsne_attractive``).
        """
        b = self._require_bsr()
        name = backend or "auto"
        if name == "auto":
            name = "cuda" if self.device.type == "cuda" else "bsr"
        y = from_numpy(y, self.device, torch.float32)
        if name == "cuda":
            return kernel_ops.tsne_force(b.vals, b.col_idx, y, self.n,
                                         nbr_mask=b.nbr_mask,
                                         indices_checked=True)
        if name == "bsr":
            return interact.tsne_attractive(b.vals, b.col_idx, b.nbr_mask,
                                            y, self.n)
        raise ValueError(f"unknown tsne_attractive backend {backend!r}; "
                         "expected None | 'auto' | 'cuda' | 'bsr'")

    def meanshift_step(self, targets, sources, h2: float) -> torch.Tensor:
        """One mean-shift iteration (§3.2). ``targets`` and ``sources``
        (n, d) in cluster order; the stored tiles are the 0/1 neighbor
        pattern. Runs the plain blockwise path on the plan's device."""
        b = self._require_bsr()
        s = from_numpy(sources, self.device, torch.float32)
        s = interact._pad_rows(s, b.n_cb * b.bs)
        s_blocked = s.reshape(b.n_cb, b.bs, -1)
        return interact.meanshift_step(
            b.vals, b.col_idx, s_blocked,
            from_numpy(targets, self.device, torch.float32), h2, self.n)

    # -- lifecycle (refresh + drift monitoring) ----------------------------

    def refresh(self, x_new, *, policy: Optional[str] = None
                ) -> "InteractionPlan":
        """See :func:`refresh_plan`."""
        return refresh_plan(self, x_new, policy=policy)

    def gamma_drift(self) -> float:
        """Relative γ degradation against the lineage's reference score
        (positive = locality got worse). The reference is pinned at the
        first scoring after a (re)build; γ itself is computed lazily, so
        hot loops that never call this never pay for scoring."""
        st = self.host.refresh
        g = self.gamma
        if st.gamma0 is None:
            st.gamma0 = g
            return 0.0
        return measures.gamma_drift(st.gamma0, g)

    # -- not ported yet ------------------------------------------------------

    def solve(self, *args, **kwargs):
        raise _not_ported("plan.solve", "A8")

    def eigs(self, *args, **kwargs):
        raise _not_ported("plan.eigs", "A8")

    def shard(self, *args, **kwargs):
        raise _not_ported("plan.shard", "A11")

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


# ---------------------------------------------------------------------------
# batched plans (many small problems in lockstep: one plan per head/batch
# entry, one kernel launch for the whole batch)
# ---------------------------------------------------------------------------


def _pow2_capacity(n: int, bs: int) -> int:
    """Shared physical capacity for a batch: the next power of two at or
    above ``n``, rounded up to a whole bottom-level block. Quantizing keeps
    a *stream* of heterogeneous batches on a handful of specs instead of
    one per max-member-size."""
    cap = 1 << max(int(np.ceil(np.log2(max(n, 1)))), 0)
    cap = max(cap, n)
    return -(-cap // bs) * bs


# backends whose compute reads only the plan's device tensors (plan.bsr and
# n), so they run over stacked PlanData; csr reads the host COO and dist
# runs collectives
_BATCHED_BACKENDS = ("bsr", "bsr_ml", "cuda")


def _batch_take(xs: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-member permutation of a stacked batch: ``xs`` (B, n, ...) indexed
    by ``idx`` (B, n) along axis 1, as ONE flat offset gather."""
    B, n = idx.shape
    flat = xs.reshape((B * n,) + tuple(xs.shape[2:]))
    off = (torch.arange(B, device=idx.device) * n)[:, None]
    return flat[(idx.long() + off).reshape(-1)].reshape(xs.shape)


def _member_data(data: PlanData, i: int) -> PlanData:
    def pick(a):
        return None if a is None else a[i]
    return PlanData(pi=data.pi[i], inv=data.inv[i],
                    col_idx=pick(data.col_idx), nbr_mask=pick(data.nbr_mask),
                    vals=pick(data.vals), alive=pick(data.alive))


def _batch_apply(spec: PlanSpec, data: PlanData, xs: torch.Tensor,
                 backend: str, mode: str, serial: bool) -> torch.Tensor:
    """The whole stacked batch through one backend.

    A backend with a registered *batched* implementation
    (``register_batched_backend``: ``bsr``, ``bsr_ml`` and ``cuda`` ship
    one) gets the whole stack in ONE call — for ``cuda`` one kernel
    launch, however many members ride the batch. Anything else, or
    ``serial=True``, loops the members through the single-plan path, each
    over a view rebuilt by ``InteractionPlan.from_spec_data`` (the
    counterpart of the reference's ``lax.scan`` variant: one member's
    tiles in flight at a time).
    """
    bfn = None if serial else get_batched_backend(backend)
    if bfn is not None:
        if mode == "matvec":
            xs = _batch_take(xs, data.pi)
        ys = bfn(spec, data, xs)
        if mode == "matvec":
            ys = _batch_take(ys, data.inv)
        return ys

    fn = get_backend(backend)
    out = []
    for i in range(xs.shape[0]):
        d = _member_data(data, i)
        view = InteractionPlan.from_spec_data(spec, d)
        x = xs[i]
        if mode == "matvec":
            x = torch.index_select(x, 0, d.pi.long())
        y = fn(view, x)
        if mode == "matvec":
            y = torch.index_select(y, 0, d.inv.long())
        out.append(y)
    return torch.stack(out)


class PlanBatch:
    """Many spec-identical plans stacked on a leading batch axis.

    The highest-traffic consumers of near-neighbor interaction run many
    *small* problems in lockstep — one interaction pattern per attention
    head or batch entry (the ClusterKV workload). A ``PlanBatch`` holds ONE
    :class:`PlanSpec` plus stacked :class:`PlanData`, and every
    ``matvec``/``apply`` is one batched call (for the ``cuda`` backend one
    kernel launch) for the whole batch.

    Members share one size: their ELL widths are padded to the widest
    member's (the extra slots are empty, exactly ``ell_slack`` headroom), so
    a member view (:meth:`member`) is a fully working single plan. Members
    of different sizes, ``capacity`` beyond the member size and the
    lockstep streaming of :meth:`update` need the streaming tiers and wait
    for ROADMAP A6b.
    """

    def __init__(self, spec: PlanSpec, data: PlanData,
                 hosts: Sequence[_PlanHost], fills: Sequence[float]):
        self.spec = spec
        self.data = data
        self.hosts = list(hosts)
        self.fills = list(fills)

    # -- construction ------------------------------------------------------

    @classmethod
    def from_plans(cls, plans: Sequence[InteractionPlan], *,
                   capacity: Optional[int] = None) -> "PlanBatch":
        """Stack shape-compatible plans into one batch.

        Every member must share one ``PlanConfig`` (the spec is shared, so
        the knobs must be too), one device, one size and agree on
        ``with_bsr``-ness. Narrower members are widened to the widest
        member's ELL width by :func:`~repro_torch.core.blocksparse.append_rows`.
        """
        plans = list(plans)
        if not plans:
            raise ValueError("PlanBatch needs at least one plan")
        cfg = plans[0].config
        has_bsr = plans[0].bsr is not None
        for p in plans:
            if p.config != cfg:
                raise ValueError(
                    "PlanBatch members must share one PlanConfig (the "
                    f"spec is shared); got {p.config} vs {cfg}")
            if (p.bsr is not None) != has_bsr:
                raise ValueError("cannot mix profile-only (with_bsr=False) "
                                 "and storage-backed plans in one batch")
            if p.device != plans[0].device:
                raise ValueError("PlanBatch members must share one device; "
                                 f"got {p.device} and {plans[0].device}")
        ns = [p.n for p in plans]
        if capacity is not None and capacity < max(ns):
            raise ValueError(f"capacity={capacity} < largest member "
                             f"n={max(ns)}")
        if len(set(ns)) != 1:
            raise _not_ported("PlanBatch of members of different sizes",
                              "A6b")
        if capacity is not None and capacity > ns[0]:
            raise _not_ported("PlanBatch(capacity > n)", "A6b")

        if has_bsr:
            m = max(p.bsr.max_nbr for p in plans)
            plans = [
                p if p.bsr.max_nbr == m
                else InteractionPlan(p.config, p.n,
                                     append_rows(p.bsr, p.n,
                                                 extra_nbr=m - p.bsr.max_nbr),
                                     p.pi, p.inv, p.host)
                for p in plans]
        spec = plans[0].spec
        for p in plans[1:]:
            assert p.spec == spec, (p.spec, spec)

        def stack(get):
            return torch.stack([get(p) for p in plans]) if has_bsr else None

        any_alive = any(p.host.alive is not None for p in plans)
        dev = plans[0].device
        data = PlanData(
            pi=torch.stack([p.pi for p in plans]),
            inv=torch.stack([p.inv for p in plans]),
            col_idx=stack(lambda p: p.bsr.col_idx),
            nbr_mask=stack(lambda p: p.bsr.nbr_mask),
            vals=stack(lambda p: p.bsr.vals),
            alive=(torch.stack([from_numpy(p.alive, dev) for p in plans])
                   if any_alive else None))
        fills = [p.bsr.fill if has_bsr else 0.0 for p in plans]
        return cls(spec, data, [p.host for p in plans], fills)

    # -- shape surface -----------------------------------------------------

    def __len__(self) -> int:
        return len(self.hosts)

    @property
    def batch(self) -> int:
        """Number of stacked members (the leading data axis B)."""
        return len(self.hosts)

    @property
    def capacity(self) -> int:
        """Shared physical capacity of every member."""
        return self.spec.capacity

    @property
    def device(self) -> torch.device:
        return self.data.pi.device

    @property
    def n_alive(self) -> np.ndarray:
        """(B,) live point count per member."""
        return np.array([int(np.asarray(h.alive).sum())
                         if h.alive is not None else self.capacity
                         for h in self.hosts])

    @property
    def stats(self) -> dict:
        """Batch telemetry: size, shared layout, per-member live counts,
        mean fill, and the resolved backend."""
        return {"batch": self.batch, "capacity": self.capacity,
                "max_nbr": self.spec.max_nbr,
                "n_alive": self.n_alive.tolist(),
                "fill_mean": float(np.mean(self.fills)),
                "backend": self.resolve_backend()}

    def __repr__(self) -> str:
        return (f"PlanBatch(B={self.batch}, capacity={self.capacity}, "
                f"bs={self.spec.bs}, max_nbr={self.spec.max_nbr}, "
                f"backend={self.spec.config.backend!r}, "
                f"device={str(self.device)!r})")

    # -- members (single-plan views over slices of the stacked data) -------

    def member(self, i: int) -> InteractionPlan:
        """The i-th plan as a real single ``InteractionPlan`` view (its BSR
        tensors are slices of the stacked data; its host is the member's
        own, so refresh works on it)."""
        return InteractionPlan.from_spec_data(
            self.spec, _member_data(self.data, i), host=self.hosts[i],
            fill=self.fills[i])

    def members(self) -> List[InteractionPlan]:
        return [self.member(i) for i in range(self.batch)]

    # -- charges -----------------------------------------------------------

    def pad_charges(self, charges: Sequence) -> torch.Tensor:
        """Per-member charge arrays (n_i, ...) -> one (B, capacity, ...)
        float32 batch on the batch's device, zero-padded on the capacity
        slots (member points occupy physical slots 0..n_i-1)."""
        if len(charges) != self.batch:
            raise ValueError(f"{len(charges)} charge arrays for batch of "
                             f"{self.batch}")
        first = np.asarray(to_numpy(charges[0]))
        out = np.zeros((self.batch, self.capacity) + first.shape[1:],
                       np.float32)
        for i, c in enumerate(charges):
            c = np.asarray(to_numpy(c), np.float32)
            out[i, :c.shape[0]] = c
        return from_numpy(out, self.device)

    # -- interaction (one call for the whole batch) -------------------------

    def resolve_backend(self, name: Optional[str] = None) -> str:
        """Resolve a backend for the *whole batch* (one shared decision).
        ``"auto"`` is ``"cuda"`` — one launch of the batched kernel — for a
        batch on a CUDA device and ``"bsr"`` on the CPU."""
        name = name or self.spec.config.backend
        if name == "auto":
            return "cuda" if self.device.type == "cuda" else "bsr"
        if name in ("csr", "dist"):
            raise ValueError(
                f"backend {name!r} cannot run batched: csr reads the "
                "host-side COO and dist issues collectives — use one of "
                f"{_BATCHED_BACKENDS} (or register a batched backend)")
        return name

    def _dispatch(self, xs, backend: Optional[str], mode: str,
                  serial: bool) -> torch.Tensor:
        if self.spec.max_nbr is None:
            raise ValueError("profile-only batch (with_bsr=False) has no "
                             "storage; rebuild with with_bsr=True")
        xs = from_numpy(xs, self.device, torch.float32)
        if xs.ndim not in (2, 3) or xs.shape[0] != self.batch \
                or xs.shape[1] != self.capacity:
            raise ValueError(
                f"batched charges must be (B={self.batch}, "
                f"capacity={self.capacity}) or (B, capacity, f); got "
                f"{tuple(xs.shape)} (pad_charges packs ragged member "
                "charges)")
        name = self.resolve_backend(backend)
        return _batch_apply(self.spec, self.data, xs, name, mode, serial)

    def apply(self, xs, backend: Optional[str] = None, *,
              serial: bool = False) -> torch.Tensor:
        """Batched ``y_b = A'_b x_b`` in each member's cluster order.
        ``serial=True`` loops the members through the single-plan path."""
        return self._dispatch(xs, backend, "apply", serial)

    def matvec(self, xs, backend: Optional[str] = None, *,
               serial: bool = False) -> torch.Tensor:
        """Batched ``y_b = A_b x_b`` in original order (per-member
        permute/apply/unpermute around the one batched call)."""
        return self._dispatch(xs, backend, "matvec", serial)

    # -- not ported yet ------------------------------------------------------

    def solve(self, *args, **kwargs):
        raise _not_ported("PlanBatch.solve", "A8")

    def update(self, *args, **kwargs):
        raise _not_ported("PlanBatch.update", "A6b")

    def insert(self, *args, **kwargs):
        raise _not_ported("PlanBatch.insert", "A6b")

    def delete(self, *args, **kwargs):
        raise _not_ported("PlanBatch.delete", "A6b")

    def compact(self, *args, **kwargs):
        raise _not_ported("PlanBatch.compact", "A6b")

    @property
    def refresh_stats(self) -> List[RefreshStats]:
        """Per-member lifecycle counters, in batch order."""
        return [h.refresh for h in self.hosts]


def build_plan_batch(xs, *, k: int = 16, ordering: str = "dual_tree",
                     bs: int = 32, sb: int = 8, backend: str = "auto",
                     d: int = 3, bits: int = 10, leaf_size: int = 64,
                     symmetrize: bool = False, seed: int = 0,
                     values: "Callable | None" = None,
                     sigma: Optional[float] = None,
                     with_bsr: bool = True,
                     capacity: Optional[int] = None,
                     config: Optional[PlanConfig] = None,
                     device: DeviceLike = None,
                     **cfg_overrides) -> PlanBatch:
    """Run the pipeline once per member and stack the results (§2.4 × B).

    ``xs`` is a (B, n, D) array or tensor, or a sequence of (n, D) point
    sets of one size (members of different sizes, and ``capacity`` beyond
    it, wait for ROADMAP A6b). Every member shares one ``PlanConfig``;
    ``values`` must be ``None`` or a callable (a static per-member value
    array cannot ride the shared spec — dress members individually and use
    ``PlanBatch.from_plans`` for that). Runs on ``device`` (``None`` =
    ``"cuda"``; raises when there is no card).

    Example:
        >>> import numpy as np
        >>> from repro_torch import api
        >>> rng = np.random.default_rng(0)
        >>> xs = rng.standard_normal((2, 48, 8))
        >>> batch = api.build_plan_batch(xs, k=4, bs=8, sb=2, backend="bsr",
        ...                              device="cpu")
        >>> batch.batch, batch.capacity
        (2, 48)
        >>> tuple(batch.matvec(np.ones((2, 48), np.float32)).shape)
        (2, 48)
    """
    if values is not None and not callable(values):
        raise ValueError(
            "build_plan_batch values= must be None or a callable; a "
            "static value array is member-specific — build members with "
            "build_plan and stack them via PlanBatch.from_plans")
    dev = resolve_device(device)
    if config is None:
        config = PlanConfig(k=k, ordering=ordering, bs=bs, sb=sb,
                            backend=backend, d=d, bits=bits,
                            leaf_size=leaf_size, symmetrize=symmetrize,
                            seed=seed, **cfg_overrides)
    elif cfg_overrides:
        config = dataclasses.replace(config, **cfg_overrides)
    members = [np.asarray(to_numpy(x), np.float32) for x in xs]
    if not members:
        raise ValueError("build_plan_batch needs at least one point set")
    ns = [m.shape[0] for m in members]
    if capacity is not None and capacity < max(ns):
        raise ValueError(f"capacity={capacity} < largest member "
                         f"n={max(ns)}")
    if len(set(ns)) != 1:
        raise _not_ported("build_plan_batch over members of different "
                          "sizes", "A6b")
    if capacity is not None and capacity > ns[0]:
        raise _not_ported("build_plan_batch(capacity > n)", "A6b")
    plans = [build_plan(x, config=config, values=values, sigma=sigma,
                        with_bsr=with_bsr, device=dev)
             for x in members]
    return PlanBatch.from_plans(plans)


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


# ---------------------------------------------------------------------------
# plan refresh (lifecycle: the non-stationary targets of paper §3.2)
# ---------------------------------------------------------------------------


def _cmp_shift(n: int, d: int, bits: int, tree: Optional[Tree],
               leaf_size: int) -> int:
    """Morton-code shift at which cell identity is compared for migration.

    Uses the tree's realized depth (cells at leaf granularity) when one
    exists, else the depth a balanced 2^d tree would need for ~leaf_size
    points per cell. Comparing at full code resolution would flag every
    sub-cell wiggle as migration."""
    total = d * hierarchy.eff_bits(d, bits)
    if tree is not None and tree.n_levels > 1:
        level = tree.n_levels - 1
    else:
        cells_per_dim = max(float(n) / max(leaf_size, 1), 1.0) ** (1.0 / d)
        level = max(int(np.ceil(np.log2(max(cells_per_dim, 1.0)))), 1)
    return max(total - level * d, 0)


def _cell_migration(y_ref: np.ndarray, y_new: np.ndarray, bits: int,
                    shift: int, device: DeviceLike = None) -> np.ndarray:
    """Mask of points whose Morton cell (at leaf granularity) changed.

    Both coordinate sets are quantized against their joint bounding box,
    so a global translation/expansion of the cloud (which leaves relative
    order intact) does not read as migration. The codes are computed on
    ``device``."""
    lo = np.minimum(y_ref.min(0), y_new.min(0))
    hi = np.maximum(y_ref.max(0), y_new.max(0))
    ca = to_numpy(hierarchy.morton_codes_box(y_ref, lo, hi, bits, device))
    cb = to_numpy(hierarchy.morton_codes_box(y_new, lo, hi, bits, device))
    return (ca >> shift) != (cb >> shift)


def _knn_subset(x_new: np.ndarray, rows_idx: np.ndarray,
                sources: Optional[np.ndarray], k: int,
                valid: Optional[np.ndarray] = None,
                device: DeviceLike = None):
    """Exact kNN edges (original index space) for a subset of target rows,
    computed on ``device``.

    ``valid`` masks the candidate sources (tombstoned physical slots hold
    stale coordinates and must never be picked as neighbors).
    """
    tq = x_new[rows_idx]
    # query block sized to the subset, as the reference sizes its scan
    block = min(1 << max(7, int(np.ceil(np.log2(max(len(rows_idx), 1))))),
                1024)
    if sources is None:
        # targets are a subset of the sources: take k+1 and drop each
        # row's own point (knn_graph's exclude_self assumes aligned sets)
        idx, d2 = knn.knn_graph(tq, x_new, k + 1, block=block, valid=valid,
                                device=device)
        idx, d2 = to_numpy(idx), to_numpy(d2)
        keep = idx != rows_idx[:, None]
        order = np.argsort(~keep, axis=1, kind="stable")  # kept first,
        idx = np.take_along_axis(idx, order, 1)[:, :k]    # distance order
        d2 = np.take_along_axis(d2, order, 1)[:, :k]      # preserved
    else:
        idx, d2 = knn.knn_graph(tq, sources, k, block=block, valid=valid,
                                device=device)
        idx, d2 = to_numpy(idx), to_numpy(d2)
    return np.repeat(rows_idx, k), idx.reshape(-1), d2.reshape(-1)


def edge_values(host: _PlanHost, rows, cols, d2) -> np.ndarray:
    """Edge weights for a batch of (row, col, squared-distance) triples
    under the host's values mode — the single place interaction strengths
    are computed for migrated rows."""
    if host.values_mode == "fn":
        return np.asarray(host.values_fn(rows, cols, d2), np.float32)
    return np.ones(len(rows), np.float32)


def _patch_pattern(host: _PlanHost, cfg: PlanConfig, n: int,
                   x_new: np.ndarray, rows_m: np.ndarray,
                   device: DeviceLike = None):
    """Original-space COO with migrated rows' kNN edges recomputed."""
    r2, c2, v2 = host.coo
    r_o, c_o = host.pi[r2], host.pi[c2]
    drop = np.isin(r_o, rows_m)
    if cfg.symmetrize:
        drop |= np.isin(c_o, rows_m)
    nr, nc, nd2 = _knn_subset(x_new, rows_m, host.sources, cfg.k,
                              valid=host.alive, device=device)
    nv = edge_values(host, nr, nc, nd2)
    if cfg.symmetrize:
        nr, nc, nv = _symmetrize_pattern(nr, nc, nv, n)
    r_all = np.concatenate([r_o[~drop], nr])
    c_all = np.concatenate([c_o[~drop], nc])
    v_all = np.concatenate([v2[~drop], nv])
    if cfg.symmetrize:  # mirrored new edges may duplicate kept ones
        key = r_all.astype(np.int64) * n + c_all
        _, first = np.unique(key, return_index=True)
        r_all, c_all, v_all = r_all[first], c_all[first], v_all[first]
    dropped_rows = r_o[drop]
    return r_all, c_all, v_all, dropped_rows


def _refresh_patch(plan: InteractionPlan, x_new, y_new, moved, stats,
                   moved_frac: float, drift_frac: float):
    """Cheapest tier: permutation kept, migrated rows' tiles patched in
    place. Returns None when a patched row-block overflows the pinned ELL
    width (caller escalates to rebucket); the storage is then untouched."""
    host, cfg, n = plan.host, plan.config, plan.n
    rows_m = np.nonzero(moved)[0]
    refreshes_pattern = (host.pattern_from_knn
                         and host.values_mode != "static"
                         and len(rows_m) > 0)
    stats = dataclasses.replace(
        stats, patches=stats.patches + 1, last_action="patch",
        last_migrated_frac=moved_frac, ordering_drift_frac=drift_frac,
        patched_rows=stats.patched_rows
        + (len(rows_m) if refreshes_pattern else 0))
    if not refreshes_pattern:
        # pattern does not follow the coords (or nothing changed cells):
        # bookkeeping only; ordering drift keeps accumulating
        host2 = dataclasses.replace(host, y_last=y_new, refresh=stats,
                                    x=x_new)
        return InteractionPlan(cfg, n, plan.bsr, plan.pi, plan.inv, host2)
    r_all, c_all, v_all, dropped_rows = _patch_pattern(
        host, cfg, n, x_new, rows_m, device=plan.device)
    r2n, c2n = ordering_mod.apply_ordering(r_all, c_all, host.pi)
    bsr = plan.bsr
    affected = np.concatenate([host.inv[dropped_rows], host.inv[rows_m]])
    touched_rb = np.unique(affected // cfg.bs)
    if bsr is not None:
        try:
            bsr = patch_bsr(bsr, r2n, c2n, v_all, touched_rb)
        except ValueError:
            return None
        if measures.fill_drift(stats.fill0, bsr.fill) > cfg.drift_tol:
            stats = dataclasses.replace(stats, degraded=True)
    host2 = dataclasses.replace(host, coo=(r2n, c2n, v_all), coo_dev=None,
                                gamma=None, y_last=y_new, refresh=stats,
                                x=x_new)
    return InteractionPlan(cfg, n, bsr, plan.pi, plan.inv, host2)


def _refresh_rebucket(plan: InteractionPlan, x_new, y_new, moved, stats,
                      moved_frac: float) -> InteractionPlan:
    """Middle tier: stable partial reorder + re-bucketed tree levels;
    embedding map, quantization frame and unmigrated kNN rows reused."""
    host, cfg, n, dev = plan.host, plan.config, plan.n, plan.device
    if host.tree is not None:
        tree = hierarchy.rebucket(y_new, host.tree, cfg.leaf_size,
                                  device=dev)
        pi = np.asarray(tree.perm)
    else:
        # a host carried across without its tree arrays: the ordering
        # still refreshes, by a stable re-sort of the new codes
        codes = to_numpy(hierarchy.morton_codes(y_new, cfg.bits, dev))
        pi = ordering_mod.stable_partial_reorder(host.pi, codes)
        tree = None
    inv = np.empty_like(pi)
    inv[pi] = np.arange(n)

    rows_m = np.nonzero(moved)[0]
    refreshes_pattern = (host.pattern_from_knn
                         and host.values_mode != "static"
                         and len(rows_m) > 0)
    if refreshes_pattern:
        r_o, c_o, v2, _ = _patch_pattern(host, cfg, n, x_new, rows_m,
                                         device=dev)
    else:
        r2, c2, v2 = host.coo
        r_o, c_o = host.pi[r2], host.pi[c2]
    r2n, c2n = ordering_mod.apply_ordering(r_o, c_o, pi)
    bsr = (build_bsr(r2n, c2n, v2, n, bs=cfg.bs, sb=cfg.sb,
                     slack=cfg.ell_slack, device=dev)
           if plan.bsr is not None else None)
    stats = dataclasses.replace(
        stats, rebuckets=stats.rebuckets + 1, last_action="rebucket",
        last_migrated_frac=moved_frac, ordering_drift_frac=0.0,
        patched_rows=stats.patched_rows
        + (len(rows_m) if refreshes_pattern else 0),
        fill0=bsr.fill if bsr is not None else None, gamma0=None,
        degraded=False)
    host2 = dataclasses.replace(
        host, pi=pi, inv=inv, coo=(r2n, c2n, v2), coo_dev=None, tree=tree,
        embedding=y_new, y_last=y_new, gamma=None, refresh=stats, x=x_new)
    return InteractionPlan(cfg, n, bsr, from_numpy(pi, dev, torch.int64),
                           from_numpy(inv, dev, torch.int64), host2)


def _refresh_rebuild(plan: InteractionPlan, x_new, stats,
                     moved_frac: float) -> InteractionPlan:
    """Top tier: the full pipeline again (fresh embedding fit, tree, kNN,
    BSR); only the config and lineage telemetry carry over."""
    host, cfg, dev = plan.host, plan.config, plan.device
    if host.pattern_from_knn and host.values_mode != "static":
        values = host.values_fn if host.values_mode == "fn" else None
        new = build_plan(x_new, config=cfg, values=values, sigma=host.sigma,
                         sources=host.sources,
                         with_bsr=plan.bsr is not None, device=dev)
    else:
        r2, c2, v2 = host.coo
        r_o, c_o = host.pi[r2], host.pi[c2]
        new = InteractionPlan.from_coo(
            r_o, c_o, v2, plan.n, x=x_new, config=cfg, sigma=host.sigma,
            with_bsr=plan.bsr is not None, device=dev, _symmetrized=True)
        new.host.pattern_from_knn = host.pattern_from_knn
        new.host.values_mode = host.values_mode
        new.host.values_fn = host.values_fn
        new.host.sources = host.sources
    new.host.refresh = dataclasses.replace(
        new.host.refresh, builds=stats.builds + 1, patches=stats.patches,
        rebuckets=stats.rebuckets, rebuilds=stats.rebuilds + 1,
        last_action="rebuild", last_migrated_frac=moved_frac,
        patched_rows=stats.patched_rows)
    return new


def refresh_plan(plan: InteractionPlan, x_new,
                 *, policy: Optional[str] = None) -> InteractionPlan:
    """Refresh ``plan`` for moved points ``x_new`` (n, D, original order).

    Re-embeds the points through the plan's *stored* PCA map, detects
    Morton-cell migration at leaf granularity (old/new coords quantized
    jointly), and escalates through three tiers:

      patch     permutation kept; kNN recomputed for migrated rows only,
                affected BSR row-block tiles patched in place
      rebucket  stable partial reorder + re-bucketed tree levels; storage
                rebuilt, everything upstream reused
      rebuild   full ``build_plan`` pipeline

    ``policy`` (or ``plan.config.refresh_policy``) forces a tier; the
    default ``"auto"`` picks by the ordering-drift fraction against
    ``PlanConfig.patch_frac`` / ``rebuild_frac``, with recorded fill
    degradation (``refresh_stats.degraded``) forcing escalation; a patch
    that overflows the pinned ELL width escalates to rebucket. The pattern
    follows the points only when edge values are recomputable (default 1.0
    or a ``values`` callable); plans with static value arrays or an
    externally fixed COO pattern refresh their *ordering* only. γ/fill of
    the result are recomputed lazily.

    Returns a new plan. Where the reference's patch copies the tile
    tensor, the port's patch tier updates it in place: the returned plan
    shares its storage with ``plan``, whose tiles then describe the
    refreshed pattern — carry on with the returned plan. The other tiers
    leave ``plan`` as it was.
    """
    host, cfg, dev = plan.host, plan.config, plan.device
    if host.embed_axes is None or host.embedding is None:
        raise ValueError(
            "plan is not refreshable: no stored embedding map (build with "
            "ordering='dual_tree' and coordinates x)")
    x_new = np.asarray(to_numpy(x_new), np.float32)
    if x_new.shape[0] != plan.n:
        raise ValueError(
            f"refresh expects the same {plan.n}-slot physical buffer, got "
            f"{x_new.shape[0]} (use plan.insert/plan.delete/update_plan "
            "for growing or shrinking point sets)")
    if x_new.shape[1] != host.embed_axes.shape[0]:
        raise ValueError(
            f"refresh expects {host.embed_axes.shape[0]}-dim points, got "
            f"{x_new.shape[1]}")
    stats = host.refresh
    y_new = to_numpy(apply_pca_map(x_new, host.embed_mean, host.embed_axes,
                                   device=dev))
    d = y_new.shape[1]
    shift = _cmp_shift(plan.n, d, cfg.bits, host.tree, cfg.leaf_size)
    holey = host.alive is not None and not host.alive.all()
    if holey:
        # tombstoned slots carry stale/garbage coordinates: they must
        # neither read as migration nor pollute the joint quantization
        # bounding box, so detection runs on the live rows only
        live = np.nonzero(host.alive)[0]
        drift = np.zeros(plan.n, bool)
        moved = np.zeros(plan.n, bool)
        drift[live] = _cell_migration(host.embedding[live], y_new[live],
                                      cfg.bits, shift, dev)
        moved[live] = _cell_migration(host.y_last[live], y_new[live],
                                      cfg.bits, shift, dev)
        denom = max(live.size, 1)
    else:
        drift = _cell_migration(host.embedding, y_new, cfg.bits, shift, dev)
        moved = _cell_migration(host.y_last, y_new, cfg.bits, shift, dev)
        denom = plan.n
    drift_frac = float(drift.sum()) / denom
    moved_frac = float(moved.sum()) / denom

    action = policy or cfg.refresh_policy
    if action == "auto":
        if drift_frac > cfg.rebuild_frac:
            action = "rebuild"
        elif drift_frac > cfg.patch_frac or stats.degraded:
            action = "rebucket"
        else:
            action = "patch"
    if action not in ("patch", "rebucket", "rebuild"):
        raise ValueError(f"unknown refresh policy {action!r}; expected "
                         "auto | patch | rebucket | rebuild")
    if action == "rebuild" and holey:
        if policy == "rebuild":
            raise ValueError(
                "rebuild on a plan with tombstoned rows would renumber "
                "the physical slots; use plan.compact() (or "
                "update_plan(policy='compact')) to rebuild on the "
                "survivors explicitly")
        action = "rebucket"  # index-stable escalation cap for streamers

    # free γ-reference snapshot: if a score was already computed for the
    # outgoing pattern, keep it as the drift baseline for this lineage
    if stats.gamma0 is None and host.gamma is not None:
        stats = dataclasses.replace(stats, gamma0=host.gamma)

    if action == "patch":
        out = _refresh_patch(plan, x_new, y_new, moved, stats, moved_frac,
                             drift_frac)
        if out is not None:
            return out
        action = "rebucket"  # pinned ELL width overflowed: escalate
    if action == "rebucket":
        return _refresh_rebucket(plan, x_new, y_new, moved, stats,
                                 moved_frac)
    return _refresh_rebuild(plan, x_new, stats, moved_frac)
