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
anything user-registered). ``backend="auto"`` is ``cuda`` on a CUDA plan;
on a CPU plan ``core.autotune.tune_backend`` resolves it: the analytic
cost model (``core.costmodel``) ranks the plain backends on the plan's
structural shape, and the decision is memoized (``cuda`` would run its
plain version there and is not ranked).

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
three tiers (patch / rebucket / rebuild) as the points move.

Streaming point sets: a plan distinguishes logical n from physical
capacity (``build_plan(capacity=)``); ``plan.insert/delete/update`` and
:func:`update_plan` stream arrivals and retirements through the tombstone,
append, rebucket, restripe, grow and compact tiers, and
:func:`apply_pending_layout` runs a layout repair that an update deferred.
Every lifecycle call returns a new plan and leaves its input valid: the
tiers that patch tiles patch a copy of the tile tensors.

Batched plans: :class:`PlanBatch` stacks spec-identical plans (one per
attention head in ClusterKV) and runs the whole batch through one batched
call — for the ``cuda`` backend one launch of the batched SpMV kernel;
``build_plan_batch`` builds the members and stacks them, and
``PlanBatch.update`` streams every member in lockstep.

Solvers (``repro_torch.solvers``): ``plan.solve`` / ``PlanBatch.solve``
run preconditioned CG on ``(A + shift*I) x = b`` and ``plan.eigs`` runs
Lanczos, each iteration one ``apply`` — on a CUDA plan one launch of the
SpMV kernel, for the whole batch in a ``PlanBatch`` solve.

Sharded plans: ``plan.shard(mesh)`` (``core.shardplan``) splits the row
blocks over the devices of a :class:`~repro_torch.launch.mesh.Mesh` with
the minimal halo exchange of charges; each shard runs the single-plan SpMV
kernel on its window. ``backend="dist"`` (``core.dist``) applies through
the memoized shards.
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
from repro_torch.core.blocksparse import (BSR, append_rows, build_bsr,
                                          index_mask, patch_bsr,
                                          tombstone_rows)
from repro_torch.core.embedding import apply_pca_map, embed, pca_map
from repro_torch.core.hierarchy import Tree, build_tree
from repro_torch.core.ordering import ORDERINGS  # noqa: F401  (re-export)
from repro_torch.core.shardplan import ShardedPlan, shard
from repro_torch.core.registry import (backend_names,  # noqa: F401
                                       get_backend, get_batched_backend,
                                       get_preconditioner,
                                       preconditioner_names,
                                       register_backend,
                                       register_batched_backend,
                                       register_preconditioner)
from repro_torch.kernels import ops as kernel_ops

__all__ = [
    "PlanConfig", "PlanSpec", "PlanData", "InteractionPlan", "PlanBatch",
    "RefreshStats", "build_plan", "build_plan_batch", "refresh_plan",
    "update_plan", "apply_pending_layout", "cluster_order", "shard",
    "ShardedPlan", "ORDERINGS",
    "register_backend", "register_batched_backend", "backend_names",
    "get_backend", "get_batched_backend", "preconditioner_names",
    "get_preconditioner", "register_preconditioner",
]


@dataclass(frozen=True)
class PlanConfig:
    """Static knobs of an interaction plan (hashable).

    Validated at construction: a bad threshold raises a ``ValueError``
    here, not deep inside a later stage. The knobs are the reference's,
    so a config crosses over from it unchanged.
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
    """Lifecycle telemetry of a plan lineage (mutable, host-side): the
    refresh tiers move the first block of fields, the streaming tiers
    (:func:`update_plan`) the counters from ``appends`` on."""
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
    x: Optional[np.ndarray] = None       # (capacity, D) original coords —
    #   inserts kNN against these (dead rows are garbage, masked by alive)
    alive: Optional[np.ndarray] = None   # (capacity,) bool row validity;
    #   None means every physical slot holds a live point
    codes: Optional[np.ndarray] = None   # (capacity,) uint64 Morton codes
    #   in the frozen code box below (leaf placement of streamed inserts;
    #   tombstoned slots keep their last code so holes stay localized)
    code_lo: Optional[np.ndarray] = None  # (d,) frozen quantization box —
    code_hi: Optional[np.ndarray] = None  # new points code comparably
    last_inserted_idx: Optional[np.ndarray] = None  # physical slots the
    #   last update_plan insert batch landed in (post-compact indices when
    #   the batch triggered a compaction)
    peak_alive: Optional[int] = None  # highest live count this layout has
    #   held (None = never streamed): the compaction trigger measures
    #   debris against this peak, so pre-allocated holes are not decay
    compact_map: Optional[np.ndarray] = None  # (old_capacity,) old physical
    #   slot -> new index after the last compaction, -1 for dead slots
    last_patch_rb: Optional[np.ndarray] = None  # row-blocks the last patch
    #   tier touched (None once the ordering or the ELL layout changed) —
    #   ShardedPlan.update patches exactly these shards instead of
    #   re-sharding
    pending_layout: Optional[str] = None  # layout tier a defer_layout
    #   update recorded instead of running ("rebucket" | "compact"):
    #   apply_pending_layout runs it
    timings: dict = dataclasses.field(default_factory=dict)
    # ^ wall seconds of the build stages (knn, embedding, tree, build_bsr)
    shard_cache: dict = dataclasses.field(default_factory=dict)
    # ^ memoized ShardedPlans keyed by (device count, mesh axis), validated
    #   by BSR identity, so a refreshed lineage re-shards lazily


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
    registry. A plan is never mutated: :meth:`with_values`, the lifecycle
    methods (:meth:`refresh`, :meth:`insert`/:meth:`delete`/:meth:`update`,
    :meth:`compact`) all return new plans, and the input's tensors keep
    what they held.
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

    def resolve_backend(self, name: Optional[str] = None,
                        x: Optional[torch.Tensor] = None) -> str:
        """Resolve ``name`` (default: the config backend). ``"auto"`` is
        ``cuda`` on a CUDA plan (the kernel, with no lookup and no host
        sync) and on a CPU plan the uncalibrated cost model's winner for
        the plan's shape and the charges' ndim
        (``core.autotune.tune_backend(calibrate=False)``, memoized)."""
        name = name or self.config.backend
        if name != "auto":
            return name
        if self.device.type == "cuda":
            return "cuda"
        from repro_torch.core.autotune import tune_backend
        return tune_backend(self, x, calibrate=False)[0]

    # -- interaction (§2.4 step 4) -----------------------------------------

    def apply(self, x, backend: Optional[str] = None,
              **kwargs) -> torch.Tensor:
        """``y = A' x`` in cluster order (``A'`` the reordered matrix).
        ``x`` (n,) or (n, f): a tensor, or an array moved to the plan's
        device."""
        x = from_numpy(x, self.device, torch.float32)
        name = self.resolve_backend(backend, x)
        if self.bsr is None and name != "csr":
            raise ValueError(
                f"profile-only plan has no BSR for backend {name!r}; "
                "rebuild with with_bsr=True (only 'csr' runs off the COO)")
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
                                   coo_dev=None, shard_cache={})
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

    # -- streaming (insert / delete / compact) -----------------------------

    def insert(self, x_new, *, policy: Optional[str] = None
               ) -> Tuple["InteractionPlan", np.ndarray]:
        """Insert points ``x_new`` (m, D); returns ``(plan, idx)`` where
        ``idx`` are the physical slots the points landed in (their row
        indices for ``matvec``/``delete``). See :func:`update_plan`."""
        plan = update_plan(self, insert=x_new, policy=policy)
        return plan, plan.host.last_inserted_idx

    def delete(self, idx, *, policy: Optional[str] = None
               ) -> "InteractionPlan":
        """Tombstone the live points at physical slots ``idx``.
        See :func:`update_plan`."""
        return update_plan(self, delete=idx, policy=policy)

    def update(self, *, insert=None, delete=None,
               policy: Optional[str] = None) -> "InteractionPlan":
        """See :func:`update_plan` (one batched insert+delete step)."""
        return update_plan(self, insert=insert, delete=delete,
                           policy=policy)

    def compact(self) -> "InteractionPlan":
        """Force the compaction tier: rebuild on the surviving points
        (capacity shrinks to ``n_alive``; ``host.compact_map`` maps old
        physical slots to new indices). See :func:`update_plan`."""
        return update_plan(self, policy="compact")

    # -- iterative solvers (repro_torch.solvers rides the matvec) ----------

    def solve(self, b, *, shift: float = 0.0,
              backend: Optional[str] = None, precond: Optional[str] = None,
              tol: Optional[float] = None, maxiter: Optional[int] = None):
        """Solve ``(A + shift*I) x = b`` by preconditioned CG on this
        plan's matvec (original index order; symmetric pattern required).
        Knobs default to the config's ``cg_tol``/``cg_maxiter``/
        ``precond``; returns :class:`repro_torch.solvers.CGResult` with
        per-iteration telemetry. Each iteration is one ``apply`` (one
        launch of the SpMV kernel on a CUDA plan)."""
        from repro_torch.solvers.krr import solve as _solve
        return _solve(self, b, shift=shift, backend=backend,
                      precond=precond, tol=tol, maxiter=maxiter)

    def eigs(self, k: int = 6, *, m: int = 0, seed: int = 0,
             backend: Optional[str] = None, largest: bool = True,
             v0=None):
        """Top (or bottom) ``k`` eigenpairs of the symmetric plan
        operator by Lanczos on the matvec — ``(w, U)`` with ``U``
        ``(capacity, k)`` in original index order. ``v0`` (cluster
        order) replaces the start vector drawn with ``seed`` on the
        plan's device."""
        from repro_torch.solvers.krr import _plan_backend
        from repro_torch.solvers.lanczos import lanczos_eigsh
        self._require_bsr()
        name = _plan_backend(self, backend)
        w, U = lanczos_eigsh(lambda v: self.apply(v, backend=name),
                             self.n, k, m=m, seed=seed, v0=v0,
                             largest=largest, device=self.device)
        return w, self.unpermute(U)

    # -- sharding ------------------------------------------------------------

    def shard(self, mesh=None, axis: str = "data") -> ShardedPlan:
        """Per-device row-block shards with halo exchange — see
        :func:`repro_torch.core.shardplan.shard`."""
        return shard(self, mesh, axis=axis)

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

    Members are padded to the shared spec at construction: capacity is
    the members' size, or pow2-quantized (:func:`_pow2_capacity`) when
    sizes differ, with the spare slots living as tombstoned streaming
    holes, and the ELL width is the widest member's (extra slots are
    exactly ``ell_slack`` headroom). A member view (:meth:`member`) is a
    fully working, streamable single plan.

    Streaming runs in lockstep: :meth:`update` pushes per-member
    insert/delete batches through the tiers of :func:`update_plan`
    (escalation decided per member), then re-unifies the spec — capacity
    and width only grow when some member outgrew the shared layout.
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
        the knobs must be too), one device and agree on
        ``with_bsr``-ness. Members are padded to a common capacity (given,
        or the max member size pow2-quantized when sizes differ) by
        :func:`_grow_plan` with the new holes spread through each member's
        ordering, and narrower members are widened to the widest member's
        ELL width by :func:`~repro_torch.core.blocksparse.append_rows`.
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
        bs = plans[0].bsr.bs if has_bsr else cfg.bs
        if capacity is None:
            cap = ns[0] if len(set(ns)) == 1 else _pow2_capacity(max(ns), bs)
        else:
            if capacity < max(ns):
                raise ValueError(f"capacity={capacity} < largest member "
                                 f"n={max(ns)}")
            cap = capacity

        padded = []
        for p in plans:
            if p.n < cap:
                p = _grow_plan(p, cap)
                if p.host.embedding is not None:
                    # interleave the new holes through the ordering, like
                    # build_plan(capacity=): streamed inserts then land
                    # near their Morton leaf instead of at the tail
                    p = _spread_holes(p)
            padded.append(p)
        plans = padded
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

    def resolve_backend(self, name: Optional[str] = None,
                        x: Optional[torch.Tensor] = None) -> str:
        """Resolve a backend for the *whole batch* (one shared decision).
        ``"auto"`` is ``cuda`` on a CUDA batch and on a CPU batch the
        uncalibrated cost model's winner over the batchable backends
        (``core.autotune.tune_batch_backend(calibrate=False)``, memoized
        structurally, so spec-identical batches decide once)."""
        name = name or self.spec.config.backend
        if name == "auto":
            if self.device.type == "cuda":
                return "cuda"
            from repro_torch.core.autotune import tune_batch_backend
            return tune_batch_backend(self, x, calibrate=False)[0]
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
        name = self.resolve_backend(backend, xs)
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

    def solve(self, bs, *, shift=0.0,
              backend: Optional[str] = None, precond: Optional[str] = None,
              tol: Optional[float] = None, maxiter: Optional[int] = None):
        """Solve all B member systems ``(A_b + shift*I) x_b = b_b`` in
        lockstep — each CG iteration ONE batched apply (one launch of the
        batched SpMV kernel for the whole batch on the ``cuda`` backend),
        batched-Cholesky preconditioning, per-lane early freeze.
        ``bs``: (B, capacity) or (B, capacity, t), original order, zeros
        on hole slots; ``shift`` a number or a per-lane (B,) tensor.
        Returns :class:`repro_torch.solvers.CGResult` with per-lane
        telemetry."""
        from repro_torch.solvers.krr import solve as _solve
        return _solve(self, bs, shift=shift, backend=backend,
                      precond=precond, tol=tol, maxiter=maxiter)

    # -- lockstep streaming (per-member tiers, one shared re-spec) ---------

    @staticmethod
    def _per_member(arg, B: int, what: str) -> list:
        if arg is None:
            return [None] * B
        if isinstance(arg, (list, tuple)):
            if len(arg) != B:
                raise ValueError(f"{what} has {len(arg)} entries for a "
                                 f"batch of {B}")
            return list(arg)
        arr = np.asarray(to_numpy(arg))
        if arr.shape[0] != B:
            raise ValueError(f"{what} leading axis {arr.shape[0]} != batch "
                             f"{B} (pass a (B, ...) array or a length-B "
                             "list, None entries to skip members)")
        return [arr[i] for i in range(B)]

    def update(self, *, insert=None, delete=None,
               policy: Optional[str] = None) -> "PlanBatch":
        """One lockstep streaming step over every member.

        ``insert``: (B, m, D) array or length-B list of (m_i, D) arrays
        (``None`` entries skip a member); ``delete`` likewise with
        physical row indices. Each member escalates through its own tiers
        (:func:`update_plan`), then the batch re-unifies: capacity and ELL
        width grow only when some member outgrew the shared layout.
        Returns a new
        batch; the input batch stays valid (a member's update patches a
        copy of its tiles, never the stacked tensors). Members skipped
        with ``None`` entries are carried through untouched — their host
        telemetry (``last_inserted_idx`` included) still reflects their
        *previous* step (:meth:`insert` masks this for its return value).
        """
        B = self.batch
        ins = self._per_member(insert, B, "insert")
        dels = self._per_member(delete, B, "delete")
        new = []
        for i in range(B):
            p = self.member(i)
            if ins[i] is not None or dels[i] is not None \
                    or policy == "compact":
                p = update_plan(p, insert=ins[i], delete=dels[i],
                                policy=policy)
            new.append(p)
        cap = max(p.n for p in new)
        cap = (self.capacity if cap <= self.capacity
               else _pow2_capacity(cap, self.spec.bs or self.spec.config.bs))
        return PlanBatch.from_plans(new, capacity=cap)

    def insert(self, xs) -> Tuple["PlanBatch", List[Optional[np.ndarray]]]:
        """Lockstep insert; returns ``(batch, idx)`` with each member's
        landed physical row indices (see ``InteractionPlan.insert``).
        Members skipped with a ``None`` entry get ``None`` back."""
        ins = self._per_member(xs, self.batch, "insert")
        out = self.update(insert=xs)
        return out, [out.hosts[i].last_inserted_idx
                     if ins[i] is not None else None
                     for i in range(self.batch)]

    def delete(self, idxs) -> "PlanBatch":
        """Lockstep tombstone of per-member physical row indices."""
        return self.update(delete=idxs)

    def compact(self) -> "PlanBatch":
        """Force every member through the compaction tier (fresh build on
        each member's survivors), then re-stack."""
        return self.update(policy="compact")

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

    ``xs`` is a (B, n, D) array or tensor, or a sequence of (n_i, D) point
    sets (sizes may differ — members are padded to a shared pow2-quantized
    capacity, or to ``capacity``, the spare slots living as streaming holes
    interleaved through each member's leaves). Every member shares one
    ``PlanConfig``;
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
    if capacity is None:
        cap = ns[0] if len(set(ns)) == 1 else _pow2_capacity(max(ns),
                                                             config.bs)
    else:
        if capacity < max(ns):
            raise ValueError(f"capacity={capacity} < largest member "
                             f"n={max(ns)}")
        cap = capacity
    plans = [build_plan(x, config=config, values=values, sigma=sigma,
                        with_bsr=with_bsr,
                        capacity=cap if cap > x.shape[0] else None,
                        device=dev)
             for x in members]
    return PlanBatch.from_plans(plans, capacity=cap)


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
    ``capacity`` pre-allocates physical row slots beyond ``len(x)``: the
    extra slots are tombstoned (dead) holes, spread through the ordering,
    until ``plan.insert`` claims them.

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
    if capacity is not None and capacity < n:
        raise ValueError(f"capacity={capacity} < n={n} points")
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
    if capacity is not None and capacity > n:
        plan = _spread_holes(_grow_plan(plan, capacity))
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
    """Cheapest tier: permutation kept, migrated rows' tiles patched (in a
    copy of the storage: ``plan`` keeps its tiles). Returns None when a
    patched row-block overflows the pinned ELL width (caller escalates to
    rebucket)."""
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
                                    x=x_new, codes=None,
                                    last_patch_rb=np.empty(0, np.int64))
        return InteractionPlan(cfg, n, plan.bsr, plan.pi, plan.inv, host2)
    r_all, c_all, v_all, dropped_rows = _patch_pattern(
        host, cfg, n, x_new, rows_m, device=plan.device)
    r2n, c2n = ordering_mod.apply_ordering(r_all, c_all, host.pi)
    bsr = plan.bsr
    affected = np.concatenate([host.inv[dropped_rows], host.inv[rows_m]])
    touched_rb = np.unique(affected // cfg.bs)
    if bsr is not None:
        try:
            bsr = _patch_copy(bsr, r2n, c2n, v_all, touched_rb)
        except ValueError:
            return None
        if measures.fill_drift(stats.fill0, bsr.fill) > cfg.drift_tol:
            stats = dataclasses.replace(stats, degraded=True)
    host2 = dataclasses.replace(host, coo=(r2n, c2n, v_all), coo_dev=None,
                                gamma=None, y_last=y_new, refresh=stats,
                                x=x_new, codes=None,
                                last_patch_rb=touched_rb, shard_cache={})
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
        embedding=y_new, y_last=y_new, gamma=None, refresh=stats, x=x_new,
        codes=None, code_lo=None, code_hi=None, last_patch_rb=None,
        shard_cache={})
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
                affected BSR row-block tiles patched (in a copy of the
                tile tensors)
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

    Returns a new plan; the input is not mutated (the patch tier writes a
    copy of the tile tensors, so ``plan.matvec`` keeps giving what it
    gave); γ/fill of the result are recomputed lazily.
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


# ---------------------------------------------------------------------------
# streaming point sets (lifecycle: growing/shrinking n, capacity layout)
# ---------------------------------------------------------------------------


def _round_up(v: int, q: int) -> int:
    return -(-v // q) * q


def _clone_storage(bsr: BSR) -> BSR:
    """A BSR whose tensors are copies of ``bsr``'s: ``patch_bsr`` and
    ``tombstone_rows`` write their input in place, and the streaming and
    refresh tiers patch such a copy, so the input plan (or the batch a
    member view slices) keeps its tiles."""
    return dataclasses.replace(bsr, col_idx=bsr.col_idx.clone(),
                               nbr_mask=bsr.nbr_mask.clone(),
                               vals=bsr.vals.clone())


def _patch_copy(bsr: BSR, rows, cols, vals, touched_rb) -> BSR:
    """``patch_bsr`` on a copy of the storage (see :func:`_clone_storage`);
    nothing to patch returns ``bsr`` itself."""
    if np.asarray(touched_rb).size == 0:
        return bsr
    return patch_bsr(_clone_storage(bsr), rows, cols, vals, touched_rb)


def _stream_codes(host: _PlanHost, cfg: PlanConfig,
                  device: DeviceLike = None):
    """Per-physical-slot Morton codes (``np.uint64``) in a frozen
    quantization box.

    Computed lazily on the first streamed insert of a lineage (and
    invalidated by every refresh tier, whose coordinates supersede them):
    live slots code their current embedding against the live bounding
    box, on ``device``; holes are seeded with quantile codes
    (:func:`_seed_hole_codes`) so they interleave through the ordering on
    the next rebucket. The box is frozen so codes of points inserted later
    are comparable — new points outside it clip to the boundary cells.
    """
    if host.codes is not None:
        return host.codes.copy(), host.code_lo, host.code_hi
    emb = host.embedding
    alive = (np.ones(len(emb), bool) if host.alive is None
             else host.alive)
    live = emb[alive]
    lo, hi = live.min(0), live.max(0)
    codes = np.empty(len(emb), np.uint64)
    codes[alive] = to_numpy(hierarchy.morton_codes_box(
        live, lo, hi, cfg.bits, device)).astype(np.uint64)
    holes = ~alive
    if holes.any():
        codes[holes] = _seed_hole_codes(codes[alive], int(holes.sum()))
    return codes, lo, hi


def _seed_hole_codes(live_codes: np.ndarray, n_holes: int) -> np.ndarray:
    """Codes for unoccupied capacity: quantiles of the live code
    distribution. On the next rebucket the holes interleave *uniformly
    through the ordering* (proportional to point density), so streamed
    inserts find a free slot close to their Morton leaf."""
    qs = np.sort(live_codes)
    idx = ((np.arange(n_holes) + 0.5) * len(qs) / n_holes).astype(np.int64)
    return qs[np.clip(idx, 0, len(qs) - 1)]


def _sq_dists(x: np.ndarray, a: np.ndarray, b: np.ndarray,
              chunk: int = 1 << 20) -> np.ndarray:
    """Squared distances ``|x[a] - x[b]|^2`` in float32: ``b`` is (m,),
    one partner per row, or (m, c), ``c`` candidates per row. Computed in
    blocks of rows of about ``chunk`` coordinates, so the gathered
    operands stay in cache instead of materialising (m, c, D) arrays;
    every block is the same numpy expression on the same array shape as
    the whole, so the result is bit for bit the unblocked one."""
    per_row = x.shape[1] * (b.shape[1] if b.ndim == 2 else 1)
    step = max(1, chunk // max(per_row, 1))
    out = np.empty(b.shape, np.float32)
    for s in range(0, len(a), step):
        xa, xb = x[a[s:s + step]], x[b[s:s + step]]
        if b.ndim == 2:
            out[s:s + step] = np.sum((xa[:, None, :] - xb) ** 2, axis=2)
        else:
            out[s:s + step] = np.sum((xa - xb) ** 2, axis=1)
    return out


def _route_dead_edges(r2, c2, v2, dead_cl, C, host, x, pi, cfg):
    """Replacement edges for rows that lose a tombstoned neighbor.

    Each broken edge (i -> j_dead) is *routed around the tombstone*: i
    adopts the one of j's own surviving neighbors nearest to it (they are
    already in the pattern and within one hop of the lost edge), so the
    pattern stays near-k-full and local between compactions without a
    distance scan per deletion. Pure numpy.

    Returns cluster-space ``(rows, cols, vals)`` of the replacement edges
    (both endpoints alive; deduplicated against existing edges).
    """
    empty = (np.empty(0, r2.dtype), np.empty(0, c2.dtype),
             np.empty(0, np.float32))
    dead_c = index_mask(c2, dead_cl, C)
    dead_r = index_mask(r2, dead_cl, C)
    lost = dead_c & ~dead_r             # surviving row -> dead neighbor
    if not lost.any():
        return empty
    lost_r, lost_j = r2[lost], c2[lost]
    sel = dead_r & ~dead_c              # dead row -> surviving neighbor
    order = np.argsort(r2[sel], kind="stable")
    j_s, nbr_s = r2[sel][order], c2[sel][order]
    uj, ustart = np.unique(j_s, return_index=True)
    if uj.size == 0:
        return empty
    counts = np.diff(np.append(ustart, len(j_s)))
    kmax = int(counts.max(initial=0))
    # candidate table: row g holds dead point uj[g]'s surviving neighbors
    mat = np.full((len(uj), kmax), -1, np.int64)
    grp = np.searchsorted(uj, j_s)
    mat[grp, np.arange(len(j_s)) - ustart[grp]] = nbr_s
    pos = np.searchsorted(uj, lost_j)
    has = (pos < len(uj)) & (uj[np.clip(pos, 0, len(uj) - 1)] == lost_j)
    if not has.any():
        return empty
    lost_r, pos = lost_r[has], pos[has]
    cand = mat[pos]                                      # (L, kmax)
    valid = (cand >= 0) & (cand != lost_r[:, None])
    # a candidate i already points at is no replacement
    kept_key = np.sort(r2[~(dead_r | dead_c)].astype(np.int64) * C
                       + c2[~(dead_r | dead_c)])
    ckey = lost_r[:, None].astype(np.int64) * C + np.clip(cand, 0, None)
    if kept_key.size:                   # membership in the sorted keys
        at = np.minimum(np.searchsorted(kept_key, ckey), kept_key.size - 1)
        valid &= kept_key[at] != ckey
    # nearest valid candidate, by actual distance
    d2 = np.where(valid, _sq_dists(x, pi[lost_r], pi[np.clip(cand, 0, None)]),
                  np.inf)
    best = np.argmin(d2, axis=1)
    bd2 = d2[np.arange(len(best)), best]
    ok = np.isfinite(bd2)
    if not ok.any():
        return empty
    rr = lost_r[ok]
    cc = cand[np.arange(len(best)), best][ok]
    dd2 = bd2[ok]
    # two broken edges of one row may route to the same candidate
    key = rr.astype(np.int64) * C + cc
    _, first = np.unique(key, return_index=True)
    rr, cc, dd2 = rr[first], cc[first], dd2[first]
    if host.values_mode == "fn":
        vv = np.asarray(host.values_fn(pi[rr], pi[cc], dd2), np.float32)
    else:
        vv = np.ones(rr.size, np.float32)
    return rr, cc, vv


def _guard_gamma(r2, c2, alive_sorted, sigma: float, C: int,
                 device: DeviceLike = None) -> float:
    """γ of the live pattern, for the streaming drift guard: the estimator
    of ``plan.gamma`` (dead slots compacted away) scored at grid size
    ``C`` (stable across steps, unlike the live count) on a coarse
    256-cell grid, on ``device``. Only the *relative* drift matters to the
    guard."""
    if alive_sorted.all():
        rr, cc = r2, c2
    else:
        rr, cc, _ = measures.compact_live(r2, c2, alive_sorted)
    return float(measures.gamma_score(rr, cc, sigma, C, cells=256,
                                      device=device))


def _adopt_arrivals(r2, c2, v2, rn, cn, d2_fwd, host, x, pi, C,
                    cfg: PlanConfig):
    """Online reverse-kNN maintenance: existing rows adopt an arrival.

    Each neighbor ``q`` of an arrival ``p`` adopts ``p`` iff ``d(q, p)``
    beats ``q``'s current worst neighbor, which is then dropped, so rows
    keep k edges and nnz stays balanced. One adoption per row per batch,
    the closest arrival. Pure numpy.

    ``(rn, cn, d2_fwd)`` are the arrivals' forward edges p -> q (cluster
    space, squared distances). Returns the updated ``(r2, c2, v2)`` plus
    the adopters' row set (their blocks join the patch).
    """
    no_rows = np.empty(0, np.int64)
    # best arrival per adopter q (closest first occurrence)
    order = np.lexsort((d2_fwd, cn))
    uq, first = np.unique(cn[order], return_index=True)
    chosen = order[first]
    q_all, p_all, d2_all = cn[chosen], rn[chosen], d2_fwd[chosen]

    # current worst neighbor of each candidate adopter (distances derived
    # from coordinates — the pattern does not store them)
    sel = np.nonzero(index_mask(r2, q_all, C))[0]
    if sel.size == 0:
        return r2, c2, v2, no_rows
    er, ec = r2[sel], c2[sel]
    ed2 = _sq_dists(x, pi[er], pi[ec])
    worst_order = np.lexsort((-ed2, er))
    wq, wfirst = np.unique(er[worst_order], return_index=True)
    worst_idx = sel[worst_order[wfirst]]          # global COO index
    worst_d2 = ed2[worst_order[wfirst]]

    pos = np.searchsorted(wq, q_all)
    hasq = (pos < len(wq)) & (wq[np.clip(pos, 0, max(len(wq) - 1, 0))]
                              == q_all)
    adopt = hasq & (d2_all < worst_d2[np.clip(pos, 0, max(len(wq) - 1, 0))])
    if not adopt.any():
        return r2, c2, v2, no_rows
    q_a, p_a, d2_a = q_all[adopt], p_all[adopt], d2_all[adopt]
    drop_idx = worst_idx[pos[adopt]]

    keep = np.ones(len(r2), bool)
    keep[drop_idx] = False
    if host.values_mode == "fn":
        va = np.asarray(host.values_fn(pi[q_a], pi[p_a], d2_a), np.float32)
    else:
        va = np.ones(q_a.size, np.float32)
    r2 = np.concatenate([r2[keep], q_a])
    c2 = np.concatenate([c2[keep], p_a])
    v2 = np.concatenate([v2[keep], va])
    return r2, c2, v2, np.unique(q_a)


def _stream_rebucket(pi, codes, r2, c2, C: int):
    """Stable re-sort of the physical slots by their maintained Morton
    codes; relabels the cluster-space COO to match (see
    :func:`repro_torch.core.ordering.stream_rebucket`)."""
    return ordering_mod.stream_rebucket(pi, codes, r2, c2, C)


def _spread_holes(plan: InteractionPlan) -> InteractionPlan:
    """Interleave pre-allocated capacity through the ordering (build-time
    only): seed the holes with quantile codes and rebucket once, so the
    spare slots sit inside the leaves inserts will target."""
    host, cfg, dev = plan.host, plan.config, plan.device
    if host.embedding is None:
        return plan            # no spatial ordering to interleave into
    codes, lo, hi = _stream_codes(host, cfg, dev)
    r2, c2, v2 = host.coo
    pi, inv, r2n, c2n = _stream_rebucket(host.pi, codes, r2, c2, plan.n)
    bsr = (build_bsr(r2n, c2n, v2, plan.n, bs=cfg.bs, sb=cfg.sb,
                     slack=cfg.ell_slack, device=dev)
           if plan.bsr is not None else None)
    stats = host.refresh
    if bsr is not None:
        stats = dataclasses.replace(stats, fill0=bsr.fill)
    host2 = dataclasses.replace(
        host, pi=pi, inv=inv, coo=(r2n, c2n, v2), coo_dev=None, tree=None,
        codes=codes, code_lo=lo, code_hi=hi, refresh=stats,
        last_patch_rb=None, shard_cache={})
    return InteractionPlan(cfg, plan.n, bsr, from_numpy(pi, dev, torch.int64),
                           from_numpy(inv, dev, torch.int64), host2)


def _require_streamable(plan: InteractionPlan) -> None:
    host = plan.host
    if host.embed_axes is None or host.embedding is None:
        raise ValueError(
            "plan is not streamable: no stored embedding map (build with "
            "ordering='dual_tree' and coordinates x)")
    if host.x is None:
        raise ValueError(
            "plan is not streamable: original coordinates were not "
            "retained (rebuild via build_plan, or restore a checkpoint "
            "saved from a streamable plan)")
    if not host.pattern_from_knn or host.values_mode == "static":
        raise ValueError(
            "plan is not streamable: its pattern/values are externally "
            "fixed, so edges for inserted points cannot be derived "
            "(build from points with values=None or a callable)")
    if host.sources is not None:
        raise ValueError(
            "fixed-source plans (sources=) tie targets and sources to "
            "one index space; streaming inserts/deletes are not "
            "meaningful there")


def _compact_plan(plan: InteractionPlan, alive: np.ndarray, x: np.ndarray,
                  stats: RefreshStats, n_ins: int, n_del: int,
                  inserted_phys: Optional[np.ndarray],
                  grows: int) -> InteractionPlan:
    """Compaction tier: full build on the surviving points (capacity
    shrinks to the live count — identical, bit for bit, to a fresh
    ``build_plan`` over those points on the same device) with lineage
    telemetry carried and ``host.compact_map`` recording old physical slot
    -> new index."""
    host, cfg = plan.host, plan.config
    values = host.values_fn if host.values_mode == "fn" else None
    new = build_plan(x[alive], config=cfg, values=values, sigma=host.sigma,
                     with_bsr=plan.bsr is not None, device=plan.device)
    cmap = np.full(len(alive), -1, np.int64)
    cmap[alive] = np.arange(int(alive.sum()))
    new.host.compact_map = cmap
    if inserted_phys is not None:
        new.host.last_inserted_idx = cmap[inserted_phys]
    if stats.gamma0 is not None or host.gamma is not None:
        # the lineage had a γ reference: score the compacted plan so the
        # guard stays armed. gamma0 itself is left None — the next
        # update_plan re-derives the reference with the guard's own
        # (coarse-grid) estimator, which is not comparable to this score.
        _ = new.gamma
    new.host.refresh = dataclasses.replace(
        new.host.refresh, builds=stats.builds + 1, patches=stats.patches,
        rebuckets=stats.rebuckets, rebuilds=stats.rebuilds,
        appends=stats.appends + (1 if n_ins else 0),
        tombstones=stats.tombstones + (1 if n_del else 0),
        compactions=stats.compactions + 1, grows=grows,
        restripes=stats.restripes,
        inserted_total=stats.inserted_total + n_ins,
        deleted_total=stats.deleted_total + n_del,
        last_action="compact")
    return new


def _grow_plan(plan: InteractionPlan, capacity: int) -> InteractionPlan:
    """Reallocate the physical layout to ``capacity`` slots: new slots
    are appended at the tail of both index spaces as tombstoned (dead)
    capacity — empty BSR row-blocks (``blocksparse.append_rows``), tail
    permutation entries, seeded placement codes."""
    host, dev = plan.host, plan.device
    n0, grow = plan.n, capacity - plan.n
    if grow <= 0:
        return plan
    pi = np.concatenate([host.pi, np.arange(n0, capacity)])
    inv = np.concatenate([host.inv, np.arange(n0, capacity)])
    alive = np.zeros(capacity, bool)
    alive[:n0] = True if host.alive is None else host.alive
    pad2 = ((0, grow), (0, 0))

    def _pad_rows(a, fill=0.0):
        return (None if a is None
                else np.pad(a, pad2, constant_values=fill))

    live_mask = (np.ones(n0, bool) if host.alive is None else host.alive)
    codes = (None if host.codes is None
             else np.concatenate([host.codes,
                                  _seed_hole_codes(
                                      host.codes[live_mask], grow)]))
    host2 = dataclasses.replace(
        host, pi=pi, inv=inv, alive=alive, x=_pad_rows(host.x),
        embedding=_pad_rows(host.embedding), y_last=_pad_rows(host.y_last),
        codes=codes, coo_dev=None, last_patch_rb=None, shard_cache={})
    bsr = (append_rows(plan.bsr, capacity)
           if plan.bsr is not None else None)
    return InteractionPlan(plan.config, capacity, bsr,
                           from_numpy(pi, dev, torch.int64),
                           from_numpy(inv, dev, torch.int64), host2)


def update_plan(plan: InteractionPlan, *, insert=None, delete=None,
                policy: Optional[str] = None,
                defer_layout: bool = False) -> InteractionPlan:
    """One streaming step: delete ``delete`` (physical row indices), then
    insert ``insert`` (m, D) new points, escalating through the streaming
    tiers of the drift policy:

      tombstone  (deletes) rows are marked dead in the validity mask, the
                 COO drops every edge touching them (broken edges are
                 routed around the tombstone, see ``_route_dead_edges``),
                 and only the row-blocks that held such an edge are
                 re-dressed (``blocksparse.tombstone_rows``) — the
                 permutation and every other block are untouched
      append     (inserts) points re-embed through the stored PCA map,
                 claim the free (tombstoned) cluster slot nearest their
                 Morton leaf, kNN is computed for the new rows only (on
                 the plan's device), and the affected row-blocks are
                 patched; when no free slot remains, capacity grows by
                 ``PlanConfig.grow_frac`` (tail slots, amortized O(1))
      rebucket   once the lineage holds a γ reference (score the plan once
                 to arm it), a γ drift beyond ``PlanConfig.gamma_tol``
                 re-sorts the slots by their maintained Morton codes and
                 restripes the storage
      restripe   an append that overflows the pinned ELL width (slack
                 from ``PlanConfig.ell_slack``) rebuilds the *storage
                 only* from the maintained COO — ordering, permutation
                 and kNN rows kept (counted in ``RefreshStats.restripes``)
      compact    full rebuild on the surviving points — triggered when
                 the capacity fraction lost since the lineage's live
                 peak exceeds ``PlanConfig.max_dead_frac`` (pre-allocated
                 holes never count) or an overflow restripe shows fill
                 degradation beyond ``PlanConfig.drift_tol``; identical,
                 bit for bit, to a fresh ``build_plan`` over the
                 survivors on the same device, with ``host.compact_map``
                 mapping old physical slots to new indices

    ``policy`` forces a tier: ``"append"``/``"tombstone"`` pin the
    in-place tiers (an ELL overflow then raises instead of restriping),
    ``"compact"`` forces the rebuild, ``None``/``"auto"`` escalate as
    above. Between compactions the pattern is maintained approximately
    (γ telemetry and ``plan.dead_frac`` expose the decay). Returns a new
    plan; the input is never mutated — the patch tiers write a copy of
    its tile tensors, so its ``matvec`` keeps giving what it gave. The
    inserted points' physical row indices land in
    ``host.last_inserted_idx`` (see :meth:`InteractionPlan.insert`).

    ``defer_layout=True`` keeps the step on the in-place tiers: the
    *optional* layout repairs (γ-drift rebucket, debris/fill-drift
    compaction) are detected but not run — the tier that fired is
    recorded in ``host.pending_layout`` for :func:`apply_pending_layout`
    to execute later. An ELL overflow still restripes synchronously, and
    an explicit ``policy="compact"`` still runs.

    Example:
        >>> import numpy as np
        >>> from repro_torch import api
        >>> x = np.random.default_rng(0).standard_normal((64, 8))
        >>> plan = api.build_plan(x, k=4, bs=8, sb=2, backend="bsr",
        ...                       device="cpu")
        >>> p2 = api.update_plan(plan, delete=[3, 11])
        >>> p2.n_alive, p2.refresh_stats.last_action
        (62, 'tombstone')
        >>> api.update_plan(p2, insert=x[:2]).n_alive   # reuses the holes
        64
        >>> p3 = api.update_plan(plan, delete=list(range(24)),
        ...                      defer_layout=True)     # past max_dead_frac
        >>> p3.host.pending_layout
        'compact'
        >>> api.apply_pending_layout(p3).n_alive
        40

    Raises:
        ValueError: on a non-streamable plan, out-of-range/already-dead
            delete indices, mis-shaped inserts, too few surviving points
            (``<= k``), an unknown ``policy``, or an ELL overflow under a
            forced in-place policy.
    """
    if policy not in (None, "auto", "append", "tombstone", "compact"):
        raise ValueError(f"unknown streaming policy {policy!r}; expected "
                         "auto | append | tombstone | compact")
    _require_streamable(plan)
    host, cfg, dev = plan.host, plan.config, plan.device
    stats = host.refresh

    ins = None
    if insert is not None:
        ins = np.asarray(to_numpy(insert), np.float32)
        if ins.ndim != 2 or ins.shape[1] != host.embed_axes.shape[0]:
            raise ValueError(
                f"insert expects (m, {host.embed_axes.shape[0]}) points, "
                f"got shape {ins.shape}")
        if ins.shape[0] == 0:
            ins = None
    del_idx = None
    if delete is not None:
        del_idx = np.unique(np.asarray(to_numpy(delete), np.int64))
        if del_idx.size == 0:
            del_idx = None
    if ins is None and del_idx is None and policy != "compact":
        return plan

    grows = stats.grows

    # -- copy-on-write streaming state (the input plan stays valid) --------
    C = plan.n
    alive = (np.ones(C, bool) if host.alive is None else host.alive.copy())
    x = host.x.copy()
    emb = host.embedding.copy()
    y_last = (emb.copy() if host.y_last is None else host.y_last.copy())
    pi, inv = host.pi, host.inv
    r2, c2, v2 = host.coo
    bsr = plan.bsr
    touched_parts = []
    overflow = False
    restriped_del = False

    n_del = 0
    if del_idx is not None:
        if del_idx.min(initial=0) < 0 or del_idx.max(initial=-1) >= C:
            raise ValueError(
                f"delete indices out of range for capacity {C}")
        if not alive[del_idx].all():
            dead = del_idx[~alive[del_idx]]
            raise ValueError(
                f"delete of already-dead rows {dead[:8].tolist()}"
                f"{'...' if dead.size > 8 else ''}")
        n_del = int(del_idx.size)
        alive[del_idx] = False
        if int(alive.sum()) <= cfg.k:
            raise ValueError(
                f"deleting {n_del} rows leaves {int(alive.sum())} live "
                f"points <= k={cfg.k}; the kNN pattern needs more")
        if not cfg.symmetrize:
            # route broken edges around the tombstones before they are
            # filtered (replacements touch the same blocks the drops do)
            rr, cc, vv = _route_dead_edges(r2, c2, v2, inv[del_idx], C,
                                           host, x, pi, cfg)
            if rr.size:
                r2 = np.concatenate([r2, rr])
                c2 = np.concatenate([c2, cc])
                v2 = np.concatenate([v2, vv])
        if bsr is not None and ins is None:
            # pure delete: the storage-level tombstone primitive, on a copy
            # of the storage. The routed replacement edges above can push
            # an ELL-full block over its width — restripe then.
            try:
                bsr, r2, c2, v2, touched_del = tombstone_rows(
                    _clone_storage(bsr), r2, c2, v2, inv[del_idx])
            except ValueError:
                dead_cl = inv[del_idx]
                drop = (index_mask(r2, dead_cl, C)
                        | index_mask(c2, dead_cl, C))
                r2, c2, v2 = r2[~drop], c2[~drop], v2[~drop]
                if policy in ("append", "tombstone"):
                    raise ValueError(
                        "a routed tombstone edge overflowed the pinned "
                        f"ELL width under policy={policy!r}; raise "
                        "PlanConfig.ell_slack or let the auto policy "
                        "restripe")
                bsr = build_bsr(r2, c2, v2, C, bs=cfg.bs, sb=cfg.sb,
                                slack=cfg.ell_slack, device=dev)
                restriped_del = True
                touched_del = np.empty(0, np.int64)
        else:
            # combined with an insert below: filter the pattern here and
            # re-dress delete- and insert-touched blocks in ONE patch
            dead_cl = inv[del_idx]
            drop = (index_mask(r2, dead_cl, C)
                    | index_mask(c2, dead_cl, C))
            touched_del = np.unique(np.concatenate(
                [r2[drop] // cfg.bs, dead_cl // cfg.bs]))
            r2, c2, v2 = r2[~drop], c2[~drop], v2[~drop]
        touched_parts.append(touched_del)

    inserted_phys = None
    n_ins = 0
    codes = code_lo = code_hi = None
    if ins is not None:
        n_ins = int(ins.shape[0])
        # codes from the *pre-delete* validity state: a slot tombstoned
        # this very step keeps its point's code, so the hole it leaves
        # advertises the leaf neighborhood it sits in
        codes, code_lo, code_hi = _stream_codes(host, cfg, dev)
        free_phys = np.nonzero(~alive)[0]
        if n_ins > free_phys.size:
            # grow capacity: reallocate with a chunk of tail slots so the
            # amortized cost per insert is O(1)
            need = n_ins - free_phys.size
            grow = max(need, int(np.ceil(cfg.grow_frac * C)))
            C2 = _round_up(C + grow, cfg.bs)
            scratch = InteractionPlan(cfg, C, bsr, plan.pi, plan.inv,
                                      dataclasses.replace(
                                          host, alive=alive, x=x,
                                          embedding=emb, y_last=y_last,
                                          codes=codes, code_lo=code_lo,
                                          code_hi=code_hi,
                                          coo=(r2, c2, v2)))
            grown = _grow_plan(scratch, C2)
            h2 = grown.host
            C, bsr = C2, grown.bsr
            alive, x, emb, y_last = h2.alive, h2.x, h2.embedding, h2.y_last
            pi, inv, codes = h2.pi, h2.inv, h2.codes
            grows += 1

        y_ins = to_numpy(apply_pca_map(ins, host.embed_mean, host.embed_axes,
                                       device=dev))
        codes_ins = to_numpy(hierarchy.morton_codes_box(
            y_ins, code_lo, code_hi, cfg.bits, dev)).astype(np.uint64)

        # claim the free cluster slot nearest each point's Morton leaf;
        # claiming in code order keeps batch-mates from the same leaf in
        # adjacent slots (tail blocks then see a compact column footprint)
        free_pos = np.nonzero(~alive[pi])[0]
        targets = hierarchy.insertion_positions(codes[pi], codes_ins)
        order = np.argsort(codes_ins, kind="stable")
        pos_sorted = ordering_mod.claim_free_slots(free_pos, targets[order])
        pos = np.empty_like(pos_sorted)
        pos[order] = pos_sorted
        phys = np.asarray(pi[pos], np.int64)
        alive[phys] = True
        x[phys] = ins
        emb[phys] = y_ins
        y_last[phys] = y_ins
        codes[phys] = codes_ins
        inserted_phys = phys

        if int(alive.sum()) <= cfg.k:
            raise ValueError(
                f"{int(alive.sum())} live points after insert but "
                f"k={cfg.k}; the kNN pattern needs more")
        nr, nc, nd2 = _knn_subset(x, phys, None, cfg.k, valid=alive,
                                  device=dev)
        nv = edge_values(host, nr, nc, nd2)
        if cfg.symmetrize:
            nr, nc, nv = _symmetrize_pattern(nr, nc, nv, C)
        rn, cn = ordering_mod.apply_ordering(nr, nc, pi)
        if not cfg.symmetrize:
            # reverse maintenance: rows whose kNN the arrivals enter
            # adopt them (dropping their previous worst neighbor), like
            # a fresh build would point them at the new points
            r2, c2, v2, adopters = _adopt_arrivals(
                r2, c2, v2, rn, cn, nd2, host, x, pi, C, cfg)
            if adopters.size:
                touched_parts.append(np.unique(adopters // cfg.bs))
        r2 = np.concatenate([r2, rn])
        c2 = np.concatenate([c2, cn])
        v2 = np.concatenate([v2, nv])
        if cfg.symmetrize:   # mirrored edges may duplicate kept ones
            key = r2.astype(np.int64) * C + c2
            _, first = np.unique(key, return_index=True)
            r2, c2, v2 = r2[first], c2[first], v2[first]
        touched_ins = np.unique(rn // cfg.bs)
        touched_parts.append(touched_ins)

    # -- tier decision ------------------------------------------------------
    # debris, not holes: the compaction trigger measures live points LOST
    # since the layout's peak, so capacity pre-allocated as insert
    # headroom (build_plan(capacity=) / PlanBatch pow2 padding) never
    # reads as decay
    n_alive_now = int(alive.sum())
    prev_alive = plan.n if host.alive is None else int(host.alive.sum())
    peak = max(host.peak_alive or 0, prev_alive, n_alive_now)
    debris_frac = (peak - n_alive_now) / max(C, 1)
    force_inplace = policy in ("append", "tombstone")
    pending = host.pending_layout if defer_layout else None
    if (policy == "compact" or debris_frac > cfg.max_dead_frac) \
            and not force_inplace:
        if defer_layout and policy != "compact":
            pending = "compact"   # hygiene, not correctness: defer it
        else:
            return _compact_plan(plan, alive, x, stats, n_ins, n_del,
                                 inserted_phys, grows)

    # γ-drift guard (armed once the lineage holds a γ reference): displaced
    # inserts decay the *ordering*, which a streaming rebucket repairs at
    # build_bsr cost — a stable re-sort of the maintained per-slot Morton
    # codes, no kNN, no re-embedding
    g_now = None
    rebucketed = False
    alive_sorted = alive[pi]
    if bsr is not None and n_ins and not force_inplace:
        ref = stats.gamma0
        if ref is None and host.gamma is not None:
            # arm the guard: the reference must come from the same (cheap,
            # coarse-grid) estimator the per-step evaluations use, so
            # score the pre-update pattern once
            r0, c0, _ = host.coo
            prev_alive = (np.ones(plan.n, bool) if host.alive is None
                          else host.alive)[host.pi]
            ref = _guard_gamma(r0, c0, prev_alive, host.sigma, C, dev)
        if ref is not None:
            if stats.gamma0 is None:
                stats = dataclasses.replace(stats, gamma0=ref)
            g_now = _guard_gamma(r2, c2, alive_sorted, host.sigma, C, dev)
            rebucketed = measures.gamma_drift(ref, g_now) > cfg.gamma_tol

    gamma0_next = stats.gamma0
    if rebucketed and (defer_layout or pending == "compact"):
        # drift detected but the repair is deferred (a pending compact
        # subsumes it); the step stays on the in-place patch below, and
        # the reference is kept so the guard keeps firing until the
        # repair lands
        pending = pending or "rebucket"
        rebucketed = False
    if rebucketed:
        pi, inv, r2, c2 = _stream_rebucket(pi, codes, r2, c2, C)
        bsr = build_bsr(r2, c2, v2, C, bs=cfg.bs, sb=cfg.sb,
                        slack=cfg.ell_slack, device=dev)
        # re-score under the repaired ordering: the new γ is both the
        # plan's score and the reference the guard stays armed with
        g_now = _guard_gamma(r2, c2, alive[pi], host.sigma, C, dev)
        gamma0_next = g_now
    elif bsr is not None and touched_parts and ins is not None:
        # in-place: delete- and insert-touched blocks re-dressed in ONE
        # patch pass of a copy of the storage (pure deletes were patched
        # by tombstone_rows); the ELL layout is kept
        touched_now = np.unique(np.concatenate(touched_parts))
        try:
            bsr = _patch_copy(bsr, r2, c2, v2, touched_now)
        except ValueError:
            overflow = True   # pinned ELL width exhausted

    restriped = restriped_del
    if overflow:
        # restripe: rebuild the *storage only* from the maintained COO —
        # ordering, permutation, kNN rows all kept — re-deriving the ELL
        # width (plus fresh slack). Never deferred: the patch failed, so
        # stored tiles would not match the maintained COO.
        if force_inplace:
            raise ValueError(
                "streamed insert overflowed the pinned ELL width under "
                f"policy={policy!r}; raise PlanConfig.ell_slack or let "
                "the auto policy restripe/compact")
        bsr = build_bsr(r2, c2, v2, C, bs=cfg.bs, sb=cfg.sb,
                        slack=cfg.ell_slack, device=dev)
        restriped = True
        if measures.fill_drift(stats.fill0, bsr.fill) > cfg.drift_tol:
            # the restriped layout shows real locality decay: escalate
            if defer_layout:
                pending = "compact"
            else:
                return _compact_plan(plan, alive, x, stats, n_ins, n_del,
                                     inserted_phys, grows)

    layout_changed = rebucketed or restriped
    stats2 = dataclasses.replace(
        stats,
        appends=stats.appends + (1 if n_ins else 0),
        tombstones=stats.tombstones + (1 if n_del else 0),
        grows=grows,
        restripes=stats.restripes + (1 if restriped else 0),
        rebuckets=stats.rebuckets + (1 if rebucketed else 0),
        fill0=(bsr.fill if layout_changed and bsr is not None
               else stats.fill0),
        gamma0=gamma0_next,
        inserted_total=stats.inserted_total + n_ins,
        deleted_total=stats.deleted_total + n_del,
        last_action="append" if n_ins else "tombstone")
    touched = (np.unique(np.concatenate(touched_parts))
               if touched_parts else np.empty(0, np.int64))
    if layout_changed:
        touched = None    # the ELL layout (or the ordering) changed whole
    host2 = dataclasses.replace(
        host, pi=pi, inv=inv, coo=(r2, c2, v2), coo_dev=None,
        gamma=None,   # lazily rescored; the guard chain (gamma0) is kept
        #   on its own capacity-grid estimator, see _guard_gamma
        tree=None if rebucketed else host.tree,
        embedding=emb, y_last=y_last, x=x, alive=alive,
        codes=codes if codes is not None else host.codes,
        code_lo=code_lo if codes is not None else host.code_lo,
        code_hi=code_hi if codes is not None else host.code_hi,
        refresh=stats2, last_patch_rb=touched, peak_alive=peak,
        last_inserted_idx=inserted_phys, compact_map=None,
        pending_layout=pending, shard_cache={})
    new_dev = C != plan.n or rebucketed
    pi_dev = from_numpy(pi, dev, torch.int64) if new_dev else plan.pi
    inv_dev = from_numpy(inv, dev, torch.int64) if new_dev else plan.inv
    return InteractionPlan(cfg, C, bsr, pi_dev, inv_dev, host2)


def _apply_stream_rebucket(plan: InteractionPlan) -> InteractionPlan:
    """Run the streaming rebucket tier on ``plan`` as it stands: stable
    re-sort of the physical slots by their maintained Morton codes, then
    a restripe of the storage under the repaired ordering. A pure function
    of the input plan."""
    host, cfg, C, dev = plan.host, plan.config, plan.n, plan.device
    stats = host.refresh
    codes, lo, hi = _stream_codes(host, cfg, dev)
    r2, c2, v2 = host.coo
    pi, inv, r2n, c2n = _stream_rebucket(host.pi, codes, r2, c2, C)
    bsr = (build_bsr(r2n, c2n, v2, C, bs=cfg.bs, sb=cfg.sb,
                     slack=cfg.ell_slack, device=dev)
           if plan.bsr is not None else None)
    alive = np.ones(C, bool) if host.alive is None else host.alive
    gamma0 = stats.gamma0
    if gamma0 is not None:
        # keep the guard armed with the repaired ordering's own score
        gamma0 = _guard_gamma(r2n, c2n, alive[pi], host.sigma, C, dev)
    stats2 = dataclasses.replace(
        stats, rebuckets=stats.rebuckets + 1, last_action="rebucket",
        fill0=bsr.fill if bsr is not None else stats.fill0,
        gamma0=gamma0)
    host2 = dataclasses.replace(
        host, pi=pi, inv=inv, coo=(r2n, c2n, v2), coo_dev=None,
        gamma=None, tree=None, codes=codes, code_lo=lo, code_hi=hi,
        refresh=stats2, last_patch_rb=None, pending_layout=None,
        shard_cache={})
    return InteractionPlan(cfg, C, bsr, from_numpy(pi, dev, torch.int64),
                           from_numpy(inv, dev, torch.int64), host2)


def apply_pending_layout(plan: InteractionPlan) -> InteractionPlan:
    """Run the layout tier a ``defer_layout`` update recorded.

      ``"rebucket"``  γ drifted past ``PlanConfig.gamma_tol`` — re-sort
                      the slots by their maintained Morton codes and
                      restripe the storage under the repaired ordering
      ``"compact"``   tombstone debris or fill drift — full rebuild on
                      the survivors, bit-identical to a fresh
                      ``build_plan`` over them (``host.compact_map``
                      maps old physical slots to new indices)

    Returns the successor plan (``pending_layout`` cleared; the input is
    never mutated and keeps serving valid results while this runs), or
    ``plan`` itself when nothing was pending.
    """
    kind = plan.host.pending_layout
    if kind is None:
        return plan
    if kind == "rebucket":
        return _apply_stream_rebucket(plan)
    if kind == "compact":
        host, stats = plan.host, plan.host.refresh
        alive = (np.ones(plan.n, bool) if host.alive is None
                 else host.alive)
        return _compact_plan(plan, alive, host.x, stats, 0, 0, None,
                             stats.grows)
    raise ValueError(f"unknown pending layout tier {kind!r}")
