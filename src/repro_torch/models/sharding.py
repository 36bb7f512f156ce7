"""Logical-axis sharding: models declare PartitionSpecs over logical tokens,
the launcher resolves them onto the physical mesh, as the reference's
``models/sharding.py``.

Tokens:
  "dp"    batch axis            -> ("pod", "data") on multi-pod, ("data",) else
  "fsdp"  param ZeRO-3 axis     -> "data"
  "tp"    tensor-parallel axis  -> "model"
  "ep"    expert-parallel axis  -> "model"
  "seq"   sequence shards       -> "data" (decode KV)
Specs on a mesh without the token's axis resolve to replicated.

The port's :class:`P` stands in for ``jax.sharding.PartitionSpec`` (a
tuple of entries: ``None``, an axis name, or a tuple of axis names), and
:class:`NamedSharding` for its namesake: a mesh and a fitted spec. On a
process mesh (``launch.mesh.init_process_mesh``) a sharding becomes
DTensor placements (:func:`placements`) and :func:`place` is the
reference's ``device_put``: ``distribute_tensor`` of each leaf.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch.launch.mesh import Mesh
from repro_torch.models.param import tree_map

TOKEN_AXES = ("dp", "fsdp", "tp", "ep", "seq")

# Layouts: how logical tokens map onto the (pod, data, model) mesh.
#   2d       baseline: DP/FSDP over 'data', TP over 'model'
#   dp_all   no tensor parallelism: batch + ZeRO over BOTH axes
#   moe_dp   experts resident over 'model' (EP), everything else DP/ZeRO
#            over both axes
#   serve_tp serving: weights resident TP-only (no per-step ZeRO gathers)
LAYOUTS = {
    "2d": {"dp": ("pod", "data"), "fsdp": ("data",), "tp": "model",
           "ep": "model", "seq": "data"},
    "dp_all": {"dp": ("pod", "data", "model"),
               "fsdp": ("data", "model"), "tp": None, "ep": None,
               "seq": "data"},
    "moe_dp": {"dp": ("pod", "data", "model"),
               "fsdp": ("data", "model"), "tp": None, "ep": "model",
               "seq": "data"},
    "serve_tp": {"dp": ("pod", "data"), "fsdp": None, "tp": "model",
                 "ep": "model", "seq": "data"},
}
_current_layout = "2d"


class P(tuple):
    """A PartitionSpec: one entry per tensor axis, each ``None``, a mesh
    axis (or logical token) name, or a tuple of names."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return "P(" + ", ".join(map(repr, self)) + ")"


@dataclass(frozen=True)
class NamedSharding:
    """A mesh and a spec over its axis names."""
    mesh: Mesh
    spec: P


def set_layout(name: str) -> None:
    global _current_layout
    if name not in LAYOUTS:
        raise KeyError(f"unknown layout {name!r}; known: {list(LAYOUTS)}")
    _current_layout = name


def get_layout() -> str:
    return _current_layout


def _resolve_token(token, mesh_axes) -> Any:
    if token is None:
        return None
    if isinstance(token, (tuple, list)):
        out: Tuple[str, ...] = ()
        for t in token:
            r = _resolve_token(t, mesh_axes)
            if r is not None:
                out += r if isinstance(r, tuple) else (r,)
        return out or None
    if token in TOKEN_AXES:
        mapped = LAYOUTS[_current_layout][token]
        if isinstance(mapped, tuple):
            avail = tuple(a for a in mapped if a in mesh_axes)
            return avail or None
        return mapped if mapped in mesh_axes else None
    # already a physical axis name
    return token if token in mesh_axes else None


def tp_axis(mesh: Mesh):
    """Physical tensor-parallel axis under the current layout (or None)."""
    return _resolve_token("tp", mesh.axis_names)


def ep_axis(mesh: Mesh):
    """Physical expert-parallel axis under the current layout (or None)."""
    return _resolve_token("ep", mesh.axis_names)


def dp_axes(mesh: Mesh) -> Tuple[str, ...]:
    """The physical axes the batch is split over (possibly none)."""
    dp = resolve_spec(P("dp"), mesh)[0]
    return () if dp is None else (dp if isinstance(dp, tuple) else (dp,))


def resolve_spec(spec, mesh: Mesh) -> P:
    return P(*(_resolve_token(t, mesh.axis_names) for t in spec))


def whole(specs):
    """A spec tree of the same shapes with every axis unsplit."""
    return tree_map(lambda s: P(*([None] * len(s))), specs)


def resolve_tree(tree, mesh: Mesh):
    """Map a tree of logical PartitionSpecs to NamedShardings on mesh."""
    return tree_map(lambda s: NamedSharding(mesh, resolve_spec(s, mesh)), tree)


def spec_tree(tree, mesh: Mesh):
    """Same, but keep PartitionSpecs."""
    return tree_map(lambda s: resolve_spec(s, mesh), tree)


def fit_spec(dims, spec, mesh: Mesh) -> P:
    """Make a resolved spec valid for an argument of shape ``dims``: drop
    mesh axes from dims they don't divide evenly, and drop duplicate axis
    uses (first dim wins), as the reference's ``fit_spec`` (DTensor could
    shard unevenly; the reference's argument shardings are exact)."""
    sizes = mesh.shape
    used: set = set()
    new = []
    for i, entry in enumerate(spec):
        if entry is None or i >= len(dims):
            new.append(None if i >= len(dims) else entry)
            continue
        axes = [a for a in (entry if isinstance(entry, (tuple, list))
                            else (entry,)) if a not in used]
        while axes:
            prod = 1
            for a in axes:
                prod *= sizes[a]
            if dims[i] % prod == 0:
                break
            axes.pop()
        used.update(axes)
        new.append(tuple(axes) if len(axes) > 1
                   else (axes[0] if axes else None))
    return P(*new)


def shardings_for(shapes_tree, logical_specs_tree, mesh: Mesh):
    """Resolve logical tokens -> NamedShardings fitted to the shapes (any
    leaf with a ``.shape``: tensors, ``meta`` tensors)."""
    return tree_map(lambda sh, sp: NamedSharding(
        mesh, fit_spec(tuple(sh.shape), resolve_spec(sp, mesh), mesh)),
        shapes_tree, logical_specs_tree)


def placements(sharding: NamedSharding) -> tuple:
    """DTensor placements of a sharding, one per mesh axis: ``Shard(i)``
    where tensor axis ``i`` names the mesh axis, ``Replicate()`` where no
    axis does. A tensor axis split over several mesh axis names them in
    the mesh's axis order (DTensor's order: the first mesh axis is the
    outer split); another order raises."""
    from torch.distributed.tensor import Replicate, Shard

    names = sharding.mesh.axis_names
    out = [Replicate()] * len(names)
    for i, entry in enumerate(sharding.spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, (tuple, list)) else (entry,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(
                f"tensor axis {i} is split over {tuple(axes)}, which is not "
                f"the mesh's axis order {names}: DTensor would lay the "
                "shards out in another order")
        for j in idx:
            out[j] = Shard(i)
    return tuple(out)


def _device_mesh(mesh: Mesh):
    if getattr(mesh, "device_mesh", None) is None:
        raise ValueError(
            "placing tensors over a mesh (training on a mesh, ROADMAP A14b) "
            "needs a process mesh (launch.mesh.init_process_mesh): this "
            "mesh has no process group")
    return mesh.device_mesh


def place(tree, shardings):
    """The reference's ``device_put``: every leaf of ``tree`` distributed
    over its sharding's process mesh (``distribute_tensor``, rank 0's
    values scattered to every rank)."""
    from torch.distributed.tensor import distribute_tensor

    def one(x: torch.Tensor, sh: NamedSharding):
        dm = _device_mesh(sh.mesh)
        return distribute_tensor(x.detach().to(dm.device_type), dm,
                                 placements(sh))
    return tree_map(one, tree, shardings)


# ---------------------------------------------------------------------------
# tensor parallelism on a process mesh: the two collectives of a split
# matmul pair, each with the backward of the whole mesh's loss
# ---------------------------------------------------------------------------


class _SumOverGroup(torch.autograd.Function):
    """Forward: the sum over ``group`` of every rank's partial product.
    Backward: the output's gradient as it is, the same on every rank (what
    follows runs replicated over ``group``)."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _EnterGroup(torch.autograd.Function):
    """Forward: the replicated input as it is. Backward: the sum over
    ``group`` of each rank's gradient (each rank used it for its share of
    a split matmul)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def _all_gather(x: torch.Tensor, dim: int, n: int, group) -> torch.Tensor:
    """The ``n`` ranks' ``x`` of ``group`` concatenated along ``dim``, in
    rank order (no autograd: a serving step's)."""
    import torch.distributed as dist

    x = x.movedim(dim, 0).contiguous()
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    getattr(dist, "all_gather_single", dist.all_gather_into_tensor)(
        out, x, group=group)
    return out.movedim(0, dim)


@dataclass(frozen=True)
class TensorSplit:
    """The ``n``-way tensor-parallel axis of a process mesh: ``enter``
    before a column-split matmul, ``sum`` after the row-split one;
    ``index`` is this rank's position on the axis (its block of heads or
    columns)."""
    axis: str
    n: int
    group: Any
    index: int = 0

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        return _EnterGroup.apply(x, self.group)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        return _SumOverGroup.apply(x, self.group)

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's block of ``x`` along ``dim``, whole."""
        return _all_gather(x, dim, self.n, self.group)


def tensor_split(mesh: Optional[Mesh]) -> Optional[TensorSplit]:
    """The split of ``mesh``'s tensor-parallel axis under the current
    layout, when it is a process mesh with such an axis of two or more
    ranks; else None (the layers then compute whole)."""
    if mesh is None or getattr(mesh, "device_mesh", None) is None:
        return None
    tp = tp_axis(mesh)
    if tp is None or mesh.shape[tp] == 1:
        return None
    dm = mesh.device_mesh
    return TensorSplit(tp, mesh.shape[tp], dm.get_group(tp),
                       dm.get_local_rank(tp))


@dataclass(frozen=True)
class SeqSplit:
    """A decode cache whose sequence is split over the ``n`` ranks of a
    process mesh axis: this rank holds positions ``[start, start + size)``
    of it. Attention over it computes a partial softmax ``(m, l, o)`` on
    the slice and ``combine``s the partials over ``group`` (the
    reference's ``pmax``/``psum``)."""
    axis: str
    n: int
    group: Any
    index: int
    size: int

    @property
    def start(self) -> int:
        return self.index * self.size

    def combine(self, m: torch.Tensor, l: torch.Tensor, o: torch.Tensor
                ) -> torch.Tensor:
        """``o / l`` of the whole sequence from this rank's partial max
        ``m``, sum ``l`` and weighted values ``o`` (``o`` has one more
        trailing dim)."""
        import torch.distributed as dist

        mm = m.clone()
        dist.all_reduce(mm, op=dist.ReduceOp.MAX, group=self.group)
        alpha = torch.exp(m - mm)
        ll, oo = l * alpha, o * alpha[..., None]
        dist.all_reduce(ll, group=self.group)
        dist.all_reduce(oo, group=self.group)
        return oo / torch.clamp(ll, min=1e-30)[..., None]


@dataclass(frozen=True)
class ShardCtx:
    """Threaded through model code: the mesh of the sharded paths (the
    long-context decode shards its cache over it; on a process mesh the
    layers split heads, MLP columns and experts over it), the mesh
    steps' per-layer gather (``layer``), and, in a decode step on a
    process mesh whose cache sequence is split, this rank's slice of it
    (``seq``)."""
    mesh: Optional[Mesh] = None
    gather: Optional[Callable[[dict, str], dict]] = None
    seq: Optional[SeqSplit] = None

    def cst(self, x: torch.Tensor, *tokens) -> torch.Tensor:
        """The reference's activation sharding constraint, which never
        changes values. The port's activations are plain tensors (on a
        process mesh the train step hands the families local tensors), so
        ``x`` comes back as it is."""
        return x

    def layer(self, lp: dict, stack: str) -> dict:
        """One layer's parameters ``lp`` of the stacked tree
        ``params[stack]`` as the layer computes with them. The mesh train
        step hands the families each rank's shards of the stacked trees and
        gathers one layer at a time here, inside the layer's remat, so
        backward gathers it again; elsewhere ``lp`` comes back as it is."""
        return lp if self.gather is None else self.gather(lp, stack)


NO_SHARD = ShardCtx(None)
