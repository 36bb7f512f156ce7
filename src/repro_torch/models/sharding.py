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


def ceil_block(size: int, n: int, r: int) -> Tuple[int, int]:
    """Rank ``r``'s block ``[start, stop)`` of ``size`` items over ``n``
    ranks: ceil boundaries, so an earlier rank holds at least as many as a
    later one (rank 0, which the dry run counts, the most); where ``n``
    divides ``size`` it is DTensor's ``Shard`` chunk."""
    return -(-r * size // n), -(-(r + 1) * size // n)


class Part(P):
    """A compute spec (``model_api.compute_specs``) that is no DTensor
    placement: the leaf gathered as its entries say (none names ``axis``),
    so whole over the tensor axis ``axis``, then this rank's ``blocks``
    (``(start, stop)`` pairs) of tensor dim ``dim``, concatenated. Its
    gradient is summed over ``axis``: each rank's blocks land where they
    belong and zeros elsewhere, and ranks that share a block (a kv head
    held by several ranks) add theirs up. The head-aligned and uneven
    splits take it; an even split of one block is a plain ``P``."""

    def __new__(cls, *entries, axis, dim: int, blocks):
        self = super().__new__(cls, *entries)
        self.axis, self.dim, self.blocks = axis, dim, tuple(blocks)
        return self

    def __repr__(self) -> str:
        return (f"Part({', '.join(map(repr, self))}; {self.axis!r} dim "
                f"{self.dim} blocks {list(self.blocks)})")

    def take(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's blocks of ``x`` (the leaf whole over ``axis``)."""
        parts = [x.narrow(self.dim, a, b - a) for a, b in self.blocks]
        return parts[0] if len(parts) == 1 else torch.cat(parts, self.dim)

    def inner(self) -> "Part":
        """The spec of one layer of a stacked leaf (its leading axis off)."""
        return Part(*self[1:], axis=self.axis, dim=self.dim - 1,
                    blocks=self.blocks)


def inner_spec(spec: P) -> P:
    """The spec of one layer of a stacked leaf at ``spec``."""
    return spec.inner() if isinstance(spec, Part) else P(*spec[1:])


def stacked_spec(spec: P) -> P:
    """The spec of a stack of layers at ``spec`` (a leading axis on)."""
    if isinstance(spec, Part):
        return Part(None, *spec, axis=spec.axis, dim=spec.dim + 1,
                    blocks=spec.blocks)
    return P(None, *spec)


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
        # contiguous: ranks may hold one value in differently strided
        # layouts (their shares' shapes differ), and the collective sums
        # their buffers in memory order
        out = x.clone(memory_format=torch.contiguous_format)
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
        g = g.clone(memory_format=torch.contiguous_format)
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

    def total(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the group of every rank's partial ``x``, which each
        rank then uses for its own share: both passes all-reduce (``sum``
        then ``enter``)."""
        return self.enter(self.sum(x))

    def block(self, size: int, rank: Optional[int] = None
              ) -> Tuple[int, int]:
        """This rank's (or ``rank``'s) block of ``size`` items
        (:func:`ceil_block`)."""
        return ceil_block(size, self.n, self.index if rank is None else rank)

    def spec(self, ndim: int, dim: int, size: int, width: int = 1,
             blocks=None) -> P:
        """The compute spec of a leaf of ``ndim`` dims whose dim ``dim``
        (``size`` items of ``width`` each) this rank takes its block of:
        the tensor axis there where the block is DTensor's even chunk, else
        a :class:`Part` (``blocks``, in items, replace the block)."""
        if blocks is None and size % self.n == 0:
            return P(*[self.axis if i == dim else None for i in range(ndim)])
        blocks = blocks if blocks is not None else (self.block(size),)
        return Part(*([None] * ndim), axis=self.axis, dim=dim,
                    blocks=[(a * width, b * width) for a, b in blocks])

    def gather_blocks(self, x: torch.Tensor, dim: int, blocks
                      ) -> torch.Tensor:
        """Every rank's block of a dim along ``dim``, whole: ``blocks[r]``
        is rank ``r``'s ``(start, stop)``; blocks may repeat (a kv head
        held by several ranks: the first holder's is taken) and may differ
        in size (each is padded to the largest for one all-gather). No
        autograd (a serving step's)."""
        size = max(b - a for a, b in blocks)
        own = x.shape[dim]
        if own < size:
            pad = [0, 0] * (x.ndim - 1 - dim) + [0, size - own]
            x = torch.nn.functional.pad(x, pad)
        every = _all_gather(x, dim, self.n, self.group)
        parts, done = [], 0
        for r, (a, b) in enumerate(blocks):
            if b > done:
                parts.append(every.narrow(dim, r * size + done - a, b - done))
                done = b
        return torch.cat(parts, dim)

    def cat(self, x: torch.Tensor, dim: int, size: int) -> torch.Tensor:
        """Every rank's block (:meth:`block` of ``size``) of a dim along
        ``dim`` concatenated whole, for a replicated use: backward takes
        this rank's block of the gradient."""
        return _CatOverGroup.apply(x, dim, size, self)


class _CatOverGroup(torch.autograd.Function):
    """Forward: every rank's block of a dim, whole. Backward: this rank's
    block of the output's gradient (the same on every rank: what follows
    runs replicated over the group)."""

    @staticmethod
    def forward(ctx, x, dim, size, split):
        ctx.dim, ctx.blk = dim, split.block(size)
        return split.gather_blocks(x, dim, [split.block(size, r)
                                            for r in range(split.n)])

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.blk
        return g.narrow(ctx.dim, a, b - a), None, None, None


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


def head_blocks(n_q: int, n_kv: int, n: int, r: int):
    """Rank ``r``'s ``(q heads, kv heads)`` blocks of a head-aligned
    split of ``n_q`` query heads in ``n_kv`` groups over ``n`` ranks,
    Megatron-style. With ``n_kv >= n`` each rank holds whole kv groups
    (:func:`ceil_block` of the groups) with all their query heads. With
    fewer kv heads than ranks, kv head ``k`` is held by ranks
    ``[ceil(k n / n_kv), ceil((k + 1) n / n_kv))`` and its group's query
    heads are split over them by :func:`ceil_block`, unevenly where they
    do not divide (Qwen2-0.5B's 7 over 8 ranks: one rank holds none)."""
    g = n_q // n_kv
    if n_kv >= n:
        k0, k1 = ceil_block(n_kv, n, r)
        return (k0 * g, k1 * g), (k0, k1)
    k = r * n_kv // n
    lo = ceil_block(n, n_kv, k)
    j0, j1 = ceil_block(g, lo[1] - lo[0], r - lo[0])
    return (k * g + j0, k * g + j1), (k, k + 1)


@dataclass(frozen=True)
class HeadSplit:
    """Attention heads over a tensor split, head-aligned
    (:func:`head_blocks`): this rank's query heads ``q`` and kv heads
    ``kv`` (each ``(start, stop)``). ``enter``/``sum`` are the split's; a
    kv head held by several ranks has its projections' gradient summed
    over them (the weights' compute spec is a :class:`Part`)."""
    split: TensorSplit
    n_q: int
    n_kv: int
    q: Tuple[int, int]
    kv: Tuple[int, int]

    @property
    def axis(self):
        return self.split.axis

    @property
    def n(self) -> int:
        return self.split.n

    @property
    def group(self):
        return self.split.group

    @property
    def even(self) -> bool:
        """Every rank holds ``n_kv / n`` whole kv groups: the plain
        Megatron split (DTensor's even chunk of every head column)."""
        return self.n_kv % self.split.n == 0

    @property
    def n_q_local(self) -> int:
        return self.q[1] - self.q[0]

    @property
    def n_kv_local(self) -> int:
        return self.kv[1] - self.kv[0]

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        return self.split.enter(x)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        return self.split.sum(x)

    def kv_blocks(self) -> list:
        """Every rank's kv heads."""
        return [head_blocks(self.n_q, self.n_kv, self.n, r)[1]
                for r in range(self.n)]

    def q_spec(self, ndim: int, dim: int, width: int) -> P:
        """Compute spec of a leaf whose dim ``dim`` holds ``width``
        columns (or rows) per query head."""
        if self.even:
            return self.split.spec(ndim, dim, self.n_q * width)
        return self.split.spec(ndim, dim, self.n_q, width, (self.q,))

    def kv_spec(self, ndim: int, dim: int, width: int) -> P:
        """The same for ``width`` per kv head."""
        if self.even:
            return self.split.spec(ndim, dim, self.n_kv * width)
        return self.split.spec(ndim, dim, self.n_kv, width, (self.kv,))

    def gather_kv(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Every kv head of ``x``, which holds this rank's along ``dim``
        (no autograd: a serving step's)."""
        return self.split.gather_blocks(x, dim, self.kv_blocks())


def head_split(split: Optional[TensorSplit], n_q: int, n_kv: int,
               what: str = "attention") -> Optional[HeadSplit]:
    """The head-aligned split of ``n_q`` query heads in ``n_kv`` kv groups
    over ``split`` (None without one). A count it cannot take raises,
    naming it: a query head count the kv heads do not divide."""
    if split is None:
        return None
    if n_kv <= 0 or n_q % n_kv:
        raise ValueError(f"{what}: {n_q} query heads do not form {n_kv} kv "
                         f"groups, so they cannot split head-aligned over "
                         f"the {split.n}-way {split.axis!r} axis")
    q, kv = head_blocks(n_q, n_kv, split.n, split.index)
    return HeadSplit(split, n_q, n_kv, q, kv)


class _MaxOverGroup(torch.autograd.Function):
    """The max over ``group`` of every rank's ``x``, as a constant (the
    cross-entropy's shift: the loss does not depend on it)."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return None, None


@dataclass(frozen=True)
class VocabSplit:
    """The vocab over a tensor split, as the reference's embedding
    ``("tp", "fsdp")`` and head ``("fsdp", "tp")`` specs: this rank holds
    the rows (and head columns) ``block`` of ``vocab`` (:func:`ceil_block`;
    uneven where the split does not divide it). The embedding is a masked
    lookup summed over the split; the logits are this rank's columns; the
    cross-entropy all-reduces its max, its sum of exponentials and the
    target's logit."""
    split: TensorSplit
    vocab: int

    @property
    def block(self) -> Tuple[int, int]:
        return self.split.block(self.vocab)

    def spec(self, ndim: int, dim: int) -> P:
        """The compute spec of a leaf whose dim ``dim`` is the vocab."""
        return self.split.spec(ndim, dim, self.vocab)

    def lookup(self, table: torch.Tensor, tokens: torch.Tensor
               ) -> torch.Tensor:
        """Rows of the embedding for ``tokens``: this rank's ``table``
        rows where a token falls in its block, zeros elsewhere, summed
        over the split."""
        lo, hi = self.block
        t = tokens.long() - lo
        mine = (t >= 0) & (t < hi - lo)
        rows = table[t.clamp(0, hi - lo - 1)]
        rows = torch.where(mine[..., None], rows, torch.zeros_like(rows))
        return self.split.sum(rows)

    def ce_sum(self, h: torch.Tensor, w: torch.Tensor, labels: torch.Tensor
               ) -> torch.Tensor:
        """Sum over rows of ``logsumexp(logits) - logits[label]``, the
        logits ``h @ w`` (this rank's columns) in float32: the max, the sum
        of exponentials and the target's logit all-reduced over the
        split. ``h`` is replicated and already ``enter``ed."""
        lo, hi = self.block
        logits = (h @ w).float()
        m = _MaxOverGroup.apply(logits.amax(-1), self.split.group)
        se = self.split.sum(torch.exp(logits - m[:, None]).sum(-1))
        t = labels.long() - lo
        mine = (t >= 0) & (t < hi - lo)
        gold = logits.gather(-1, t.clamp(0, hi - lo - 1)[:, None])[:, 0]
        gold = self.split.sum(torch.where(mine, gold,
                                          torch.zeros_like(gold)))
        return (torch.log(se) + m - gold).sum()

    def gather(self, logits: torch.Tensor) -> torch.Tensor:
        """Every column of ``logits`` (..., this rank's block), whole (no
        autograd)."""
        return self.split.gather_blocks(
            logits, logits.ndim - 1,
            [self.split.block(self.vocab, r) for r in range(self.split.n)])


def vocab_split(mesh: Optional[Mesh], vocab: int) -> Optional[VocabSplit]:
    """The vocab split of ``mesh``'s tensor axis (None where there is
    none); a vocab smaller than the axis raises."""
    split = tensor_split(mesh)
    if split is None:
        return None
    if vocab < split.n:
        raise ValueError(f"a vocab of {vocab} does not split over the "
                         f"{split.n}-way {split.axis!r} axis")
    return VocabSplit(split, vocab)


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
    families split over it what the reference's specs split: heads, MLP
    columns, experts, mamba channels, the vocab), the mesh
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
