"""Mixture-of-Experts FFN: sort-based capacity routing, static shapes.

The single-device path of the reference's ``models/moe.py``: the router in
float32, top-k gates renormalized, tokens sorted by expert (stable) and
given a rank inside their expert; tokens beyond an expert's capacity
``ceil(T * k * capacity_factor / E)`` are dropped (Switch-style) and the
residual stream carries them unchanged. The expert products are batched
matmuls, as the reference leaves them to XLA.

The reference's two scatter-adds become writes whose order is fixed, so a
result is bit-equal run to run on a card (``index_add_`` there is atomic
and sums in a changing order):

* dispatch: kept slots are unique, so the kept rows are COPIED into the
  expert buffer (``index_copy_``), every dropped row aimed at one spare
  row past the buffer that is then cut off. The reference adds each row
  onto zeros, which gives the same values.
* combine: each token gathers its ``k`` weighted expert rows and sums them
  in ascending position of the expert sort, i.e. ascending expert id, the
  order in which the reference's scatter-add meets them (ROADMAP C36).

Under a process mesh (``launch.mesh.init_process_mesh``) the FFN splits
as the reference's ``shard_map`` does, through ``local_map`` with the
reference's ``in_specs``/``out_specs``. Each rank holds its rows of the
batch (``dp``) and routes them on its own, with the capacity of its shard:

* expert tensor parallelism: every expert's hidden dim split over ``tp``;
  the row-parallel down projection is summed over ``tp`` before the
  gates (the reference's ``psum``);
* expert parallelism (``expert_parallel`` and the experts divide the
  ``ep`` axis): the experts split over ``ep``, the tokens split further
  by sequence over ``tp`` (when it is not a batch axis), and two
  ``all_to_all_single`` exchanges carry each token row to its expert's
  owner and back.

The expert weights arrive as this rank's shards, in the layout
``compute_specs`` names (the trainer gathers them so). Each collective is
an ``autograd.Function`` whose backward gives the gradient of the whole
mesh's loss, as ``jax.grad`` through the reference's
``shard_map(check_vma=False)`` does. The aux loss counts the experts'
tokens over the whole batch (an all-reduce over ``dp``), as the
reference's, which routes outside ``shard_map``. Under a single-controller
mesh (``launch.mesh.make_mesh``) the same shards are routed one after
another in one process, on whole weights.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.clusterkv import topk_stable
from repro_torch.models import param as pm
from repro_torch.models.sharding import (NO_SHARD, NamedSharding, P,
                                         ShardCtx, dp_axes, ep_axis,
                                         placements, tensor_split, tp_axis)


def init_moe(cfg: ModelConfig) -> dict:
    m = cfg.moe
    d, e, f = cfg.d_model, m.n_experts, m.d_ff_expert
    scale_in = 1.0 / math.sqrt(d)
    ep = "ep" if m.expert_parallel else None
    tp_in = None if m.expert_parallel else "tp"
    p = {"router": {"w": pm.normal((d, e), scale_in, ("fsdp", None))},
         "wg": pm.normal((e, d, f), scale_in, (ep, "fsdp", tp_in)),
         "wu": pm.normal((e, d, f), scale_in, (ep, "fsdp", tp_in)),
         "wd": pm.normal((e, f, d), 1.0 / math.sqrt(f), (ep, tp_in, "fsdp"))}
    if m.n_shared_experts:
        fs = f * m.n_shared_experts
        p["shared"] = {"wg": pm.normal((d, fs), scale_in, ("fsdp", "tp")),
                       "wu": pm.normal((d, fs), scale_in, ("fsdp", "tp")),
                       "wd": pm.normal((fs, d), 1.0 / math.sqrt(fs),
                                       ("tp", "fsdp"))}
    return p


def route(eidx: torch.Tensor, n_experts: int, capacity: int):
    """The sort-based routing of ``(T, k)`` expert ids: ``order`` (the
    stable sort of the flattened ids), ``keep`` (rank inside the expert
    below ``capacity``), ``dest`` (buffer row ``expert * capacity +
    min(rank, capacity - 1)``) and ``token_of``, each in sorted order."""
    t, k = eidx.shape
    flat_e = eidx.reshape(-1)
    order = torch.sort(flat_e, stable=True).indices
    sorted_e = flat_e[order]
    counts = torch.bincount(flat_e, minlength=n_experts)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(t * k, device=eidx.device) - starts[sorted_e]
    keep = rank < capacity
    dest = sorted_e * capacity + torch.clamp(rank, max=capacity - 1)
    return order, keep, dest, order // k


def _dispatch(xf, keep, dest, token_of, rows: int) -> torch.Tensor:
    """The ``(rows, d)`` expert buffer: each kept sorted entry's token row
    copied to its slot, the rest zeros."""
    buf = torch.zeros((rows + 1, xf.shape[-1]), dtype=xf.dtype,
                      device=xf.device)
    buf.index_copy_(0, torch.where(keep, dest, rows), xf[token_of])
    return buf[:rows]


def _experts(bufe, wg, wu, wd):
    """SwiGLU of every expert on its buffer: bufe (E, C, d) -> (E, C, d)."""
    dt = bufe.dtype
    h = torch.nn.functional.silu(torch.bmm(bufe, wg.to(dt)))
    h = h * torch.bmm(bufe, wu.to(dt))
    return torch.bmm(h, wd.to(dt))


def _route_local(xf, eidx, gates, wg, wu, wd, capacity: int,
                 psum=None):
    """Sort-based dispatch on one device (or one shard).

    xf (T, d); eidx/gates (T, k); wg/wu (E, d, f); wd (E, f, d). ``psum``,
    when given, sums the expert outputs over the tensor axis before the
    gates (the experts' hidden dim ``f`` is then this rank's share)."""
    t, k = eidx.shape
    e, d = wg.shape[0], xf.shape[-1]
    order, keep, dest, token_of = route(eidx, e, capacity)
    buf = _dispatch(xf, keep, dest, token_of, e * capacity)
    out = _experts(buf.reshape(e, capacity, d), wg, wu, wd).reshape(-1, d)
    if psum is not None:
        out = psum(out)
    return _combine(out, gates, order, keep, dest, t, k)


def _combine(out, gates, order, keep, dest, t: int, k: int):
    """Each token's ``k`` gated expert rows of ``out``, summed in
    ascending position of the expert sort (ROADMAP C36)."""
    g = (gates.reshape(-1)[order] * keep)[:, None].to(out.dtype)
    contrib = out[dest] * g                                  # sorted order
    # each token's k entries of the sort, in ascending sort position
    inv = torch.empty_like(order)
    inv[order] = torch.arange(t * k, device=order.device)
    pos = torch.sort(inv.reshape(t, k), dim=-1).values
    y = torch.zeros((t, out.shape[-1]), dtype=out.dtype, device=out.device)
    for j in range(k):
        y = y + contrib[pos[:, j]]
    return y


def _route_ep(xf, eidx, gates, wg, wu, wd, capacity: int, group):
    """Expert parallelism: this rank's ``E / n`` experts (``wg`` (E/n, d,
    f) ...), the tokens' rows exchanged with the experts' owners over
    ``group`` (n ranks) by two all-to-alls."""
    import torch.distributed as dist

    t, k = eidx.shape
    d = xf.shape[-1]
    e_local = wg.shape[0]
    n_dev = dist.get_world_size(group)
    e = e_local * n_dev
    order, keep, dest, token_of = route(eidx, e, capacity)
    buf = _dispatch(xf, keep, dest, token_of, e * capacity)
    # (n_dev, e_local * C, d): block j goes to rank j; what comes back in
    # block j is rank j's rows for MY experts
    buf = _AllToAll.apply(buf.reshape(n_dev, e_local * capacity, d), group)
    bufe = (buf.reshape(n_dev, e_local, capacity, d).transpose(0, 1)
            .reshape(e_local, n_dev * capacity, d))
    out = _experts(bufe, wg, wu, wd)
    out = (out.reshape(e_local, n_dev, capacity, d).transpose(0, 1)
           .reshape(n_dev, e_local * capacity, d))
    out = _AllToAll.apply(out, group).reshape(e * capacity, d)
    return _combine(out, gates, order, keep, dest, t, k)


# ---------------------------------------------------------------------------
# collectives with the backward of the reference's shard_map
# ---------------------------------------------------------------------------


class _AllToAll(torch.autograd.Function):
    """Block ``j`` of dim 0 to rank ``j``; what rank ``j`` sent comes back
    in block ``j``. Its own transpose, so the backward is the same
    exchange."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist
        ctx.group = group
        x = x.contiguous()
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return _AllToAll.apply(g, ctx.group), None


def load_balance_loss(probs, eidx, n_experts: int,
                      count_sum=None) -> torch.Tensor:
    """Switch-style aux loss: E * sum_e f_e * p_e. ``count_sum`` sums the
    expert counts over the batch's shards (the loss is then this shard's
    share: with ``p_e`` the mean over its own rows, the mean over the
    shards is the whole batch's loss)."""
    f = torch.bincount(eidx.reshape(-1), minlength=n_experts).float()
    if count_sum is not None:
        f = count_sum(f)
    f = f / torch.clamp_min(f.sum(), 1.0)
    return n_experts * torch.sum(f * probs.mean(dim=0))


def router(p, x: torch.Tensor, cfg: ModelConfig):
    """float32 router: (probs (B,S,E), gates (B,S,k) renormalized, eidx
    (B,S,k) int64) with the top-k in ``lax.top_k``'s order."""
    logits = x.float() @ p["router"]["w"].float()
    probs = torch.softmax(logits, dim=-1)
    eidx = topk_stable(probs, cfg.moe.top_k)
    gates = torch.gather(probs, -1, eidx)
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    return probs, gates, eidx


def _capacity(tokens: int, m) -> int:
    return max(1, math.ceil(tokens * m.top_k * m.capacity_factor
                            / m.n_experts))


def mesh_branch(cfg: ModelConfig, mesh, seq: int) -> str:
    """The reference's split under ``mesh`` at sequence length ``seq``:
    ``"ep"`` (experts over the ``ep`` axis, token rows exchanged by
    all-to-all) or ``"tp"`` (expert tensor parallelism; with no ``tp``
    axis the experts are whole on every rank)."""
    m = cfg.moe
    tp, epax = tp_axis(mesh), ep_axis(mesh)
    seq_ax = tp if (tp is not None and tp not in dp_axes(mesh)) else None
    n_seq = mesh.shape[seq_ax] if seq_ax is not None else 1
    if m.expert_parallel and epax is not None \
            and m.n_experts % mesh.shape[epax] == 0 and seq % n_seq == 0:
        return "ep"
    if tp is not None and m.d_ff_expert % mesh.shape[tp] != 0:
        raise ValueError(f"expert hidden dim {m.d_ff_expert} does not split "
                         f"over the {mesh.shape[tp]}-way {tp!r} axis")
    return "tp"


def _shared_split(cfg: ModelConfig, mesh):
    """The tensor split of the shared experts' hidden dim under ``mesh``
    (None: whole on every rank)."""
    split = tensor_split(mesh)
    fs = cfg.moe.d_ff_expert * cfg.moe.n_shared_experts
    return split if split is not None and fs % split.n == 0 else None


def compute_specs(cfg: ModelConfig, mesh, seq: int) -> dict:
    """Physical PartitionSpecs of one layer's FFN weights as it takes them
    under ``mesh``: the experts' as the reference's ``shard_map``
    in_specs, the shared experts' column/row split over ``tp`` (or whole),
    the router whole."""
    if mesh_branch(cfg, mesh, seq) == "ep":
        ex = P(ep_axis(mesh), None, None)
        out = {"wg": ex, "wu": ex, "wd": ex}
    else:
        tp = tp_axis(mesh)
        out = {"wg": P(None, None, tp), "wu": P(None, None, tp),
               "wd": P(None, tp, None)}
    out["router"] = {"w": P(None, None)}
    if cfg.moe.n_shared_experts:
        split = _shared_split(cfg, mesh)
        tp = split.axis if split is not None else None
        out["shared"] = {"wg": P(None, tp), "wu": P(None, tp),
                         "wd": P(tp, None)}
    return out


def _sum_over(mesh, axes):
    """A function summing a tensor over the process groups of ``axes``."""
    import torch.distributed as dist

    def f(t):
        t = t.clone()
        for a in axes:
            dist.all_reduce(t, group=mesh.device_mesh.get_group(a))
        return t
    return f


def _moe_on_mesh(p, x, eidx, gates, cfg: ModelConfig, mesh):
    """The expert part of the FFN on this rank's rows ``x`` (b, S, d)
    under a process mesh, through ``local_map`` with the reference's
    in/out specs."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import local_map

    m = cfg.moe
    b, s, d = x.shape
    dm = mesh.device_mesh
    dpx = dp_axes(mesh)
    dp = (dpx if len(dpx) > 1 else dpx[0]) if dpx else None
    tp = tp_axis(mesh)

    def pl(*spec):
        return placements(NamedSharding(mesh, P(*spec)))

    act = pl(dp)
    if mesh_branch(cfg, mesh, s) == "ep":
        epax = ep_axis(mesh)
        seq_ax = tp if (tp is not None and tp not in dpx) else None
        n_seq = mesh.shape[seq_ax] if seq_ax is not None else 1
        cap = _capacity(b * s // n_seq, m)
        group = dm.get_group(epax)

        def body(xl, el, gl, wg, wu, wd):
            tl = xl.shape[0] * xl.shape[1]
            y = _route_ep(xl.reshape(tl, d), el.reshape(tl, -1),
                          gl.reshape(tl, -1).to(xl.dtype), wg, wu, wd, cap,
                          group)
            return y.reshape(xl.shape)
        tok = pl(dp, seq_ax)
    else:
        cap = _capacity(b * s, m)
        split = tensor_split(mesh)

        def body(xl, el, gl, wg, wu, wd):
            tl = xl.shape[0] * xl.shape[1]
            xf = xl.reshape(tl, d)
            if split is not None:
                xf = split.enter(xf)
            y = _route_local(xf, el.reshape(tl, -1),
                             gl.reshape(tl, -1).to(xl.dtype), wg, wu, wd,
                             cap, split.sum if split is not None else None)
            return y.reshape(xl.shape)
        tok = act
    tok = list(tok)         # one output: a list (a tuple means several)
    f = local_map(body, out_placements=tok,
                  in_placements=(tok, tok, tok, None, None, None),
                  redistribute_inputs=True, device_mesh=dm)
    args = [DTensor.from_local(t, dm, act, run_check=False)
            for t in (x, eidx, gates)]
    y = f(*args, p["wg"], p["wu"], p["wd"])
    return y.redistribute(dm, act).to_local()


def _moe_by_shard(p, x, eidx, gates, cfg: ModelConfig, mesh):
    """The expert part under a single-controller mesh: the reference's
    per-shard routing, one shard after another in this process on whole
    weights. Each block of rows (and, for expert parallelism, of the
    sequence) is routed on its own with the capacity of its shard; a batch
    the batch axes do not divide is routed whole, as the reference's."""
    m = cfg.moe
    b, s, d = x.shape
    n_dp = math.prod(mesh.shape[a] for a in dp_axes(mesh))
    if b % n_dp:
        n_dp = n_seq = 1
    elif mesh_branch(cfg, mesh, s) == "ep":
        tp = tp_axis(mesh)
        n_seq = mesh.shape[tp] if (tp is not None
                                   and tp not in dp_axes(mesh)) else 1
    else:
        n_seq = 1
    rb, sb = b // n_dp, s // n_seq
    cap = _capacity(rb * sb, m)
    y = torch.empty_like(x)
    for i in range(0, b, rb):
        for j in range(0, s, sb):
            blk = (slice(i, i + rb), slice(j, j + sb))
            t = rb * sb
            y[blk] = _route_local(
                x[blk].reshape(t, d), eidx[blk].reshape(t, -1),
                gates[blk].reshape(t, -1).to(x.dtype), p["wg"], p["wu"],
                p["wd"], cap).reshape(rb, sb, d)
    return y


def moe_ffn(p, x: torch.Tensor, cfg: ModelConfig, shd: ShardCtx = NO_SHARD
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (y (B, S, d), aux_loss scalar). Under a process mesh
    ``x`` is this rank's rows of the batch and the expert weights are its
    shards (``compute_specs``); under a single-controller mesh the shards
    are routed one after another (``_moe_by_shard``)."""
    m = cfg.moe
    b, s, d = x.shape
    mesh = shd.mesh
    process = getattr(mesh, "device_mesh", None) is not None
    probs, gates, eidx = router(p, x, cfg)
    count_sum = _sum_over(mesh, dp_axes(mesh)) if process else None
    aux = load_balance_loss(probs.reshape(-1, m.n_experts),
                            eidx.reshape(-1, m.top_k), m.n_experts,
                            count_sum)
    if process:
        y = _moe_on_mesh(p, x, eidx, gates, cfg, mesh)
    elif mesh is not None:
        y = _moe_by_shard(p, x, eidx, gates, cfg, mesh)
    else:
        t = b * s
        y = _route_local(x.reshape(t, d), eidx.reshape(t, -1),
                         gates.reshape(t, -1).to(x.dtype), p["wg"], p["wu"],
                         p["wd"], _capacity(t, m)).reshape(b, s, d)
    if "shared" in p:
        sh = p["shared"]
        split = _shared_split(cfg, mesh) if process else None
        xs = split.enter(x) if split is not None else x
        h = torch.nn.functional.silu(xs @ sh["wg"].to(x.dtype)) \
            * (xs @ sh["wu"].to(x.dtype))
        out = h @ sh["wd"].to(x.dtype)
        y = y + (split.sum(out) if split is not None else out)
    return y, aux
