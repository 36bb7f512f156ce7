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

Under a mesh the reference routes inside ``shard_map`` (expert parallelism
by ``all_to_all``, or expert tensor parallelism with a ``psum``); those
need the trainer's layouts and wait for ROADMAP A14b.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.clusterkv import topk_stable
from repro_torch.models import param as pm
from repro_torch.models.sharding import NO_SHARD, ShardCtx


def init_moe(cfg: ModelConfig) -> dict:
    m = cfg.moe
    d, e, f = cfg.d_model, m.n_experts, m.d_ff_expert
    scale_in = 1.0 / math.sqrt(d)
    p = {"router": {"w": pm.normal((d, e), scale_in)},
         "wg": pm.normal((e, d, f), scale_in),
         "wu": pm.normal((e, d, f), scale_in),
         "wd": pm.normal((e, f, d), 1.0 / math.sqrt(f))}
    if m.n_shared_experts:
        fs = f * m.n_shared_experts
        p["shared"] = {"wg": pm.normal((d, fs), scale_in),
                       "wu": pm.normal((d, fs), scale_in),
                       "wd": pm.normal((fs, d), 1.0 / math.sqrt(fs))}
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


def _route_local(xf, eidx, gates, wg, wu, wd, capacity: int):
    """Sort-based dispatch on one device.

    xf (T, d); eidx/gates (T, k); wg/wu (E, d, f); wd (E, f, d)."""
    t, k = eidx.shape
    e, d = wg.shape[0], xf.shape[-1]
    order, keep, dest, token_of = route(eidx, e, capacity)
    spare = e * capacity
    buf = torch.zeros((spare + 1, d), dtype=xf.dtype, device=xf.device)
    buf.index_copy_(0, torch.where(keep, dest, spare), xf[token_of])
    bufe = buf[:spare].reshape(e, capacity, d)
    h = torch.nn.functional.silu(torch.bmm(bufe, wg.to(xf.dtype)))
    h = h * torch.bmm(bufe, wu.to(xf.dtype))
    out = torch.bmm(h, wd.to(xf.dtype)).reshape(-1, d)
    g = (gates.reshape(-1)[order] * keep)[:, None].to(xf.dtype)
    contrib = out[dest] * g                                  # sorted order
    # each token's k entries of the sort, in ascending sort position
    inv = torch.empty_like(order)
    inv[order] = torch.arange(t * k, device=order.device)
    pos = torch.sort(inv.reshape(t, k), dim=-1).values
    y = torch.zeros_like(xf)
    for j in range(k):
        y = y + contrib[pos[:, j]]
    return y


def load_balance_loss(probs, eidx, n_experts: int) -> torch.Tensor:
    """Switch-style aux loss: E * sum_e f_e * p_e."""
    f = torch.bincount(eidx.reshape(-1), minlength=n_experts).float()
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


def moe_ffn(p, x: torch.Tensor, cfg: ModelConfig, shd: ShardCtx = NO_SHARD
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (y (B, S, d), aux_loss scalar)."""
    if shd.mesh is not None:
        raise NotImplementedError(
            "the MoE FFN under a mesh (expert parallelism, expert tensor "
            "parallelism) is not ported to repro_torch yet (port queue item "
            "A14b in ROADMAP.md)")
    m = cfg.moe
    b, s, d = x.shape
    probs, gates, eidx = router(p, x, cfg)
    aux = load_balance_loss(probs.reshape(-1, m.n_experts),
                            eidx.reshape(-1, m.top_k), m.n_experts)
    t = b * s
    cap = max(1, math.ceil(t * m.top_k * m.capacity_factor / m.n_experts))
    y = _route_local(x.reshape(t, d), eidx.reshape(t, -1),
                     gates.reshape(t, -1).to(x.dtype), p["wg"], p["wu"],
                     p["wd"], cap).reshape(b, s, d)
    if "shared" in p:
        sh = p["shared"]
        h = torch.nn.functional.silu(x @ sh["wg"].to(x.dtype)) \
            * (x @ sh["wu"].to(x.dtype))
        y = y + h @ sh["wd"].to(x.dtype)
    return y, aux
