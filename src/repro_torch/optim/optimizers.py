"""Optimizers: AdamW and Adafactor, with global-norm clipping and a
warmup-cosine schedule, as the reference's ``optim/optimizers.py``.

Parameters and gradients are nested dicts of tensors (``models/param.py``).
An optimizer's state is a dict tree with the reference's keys: float32
moments shaped like their parameters (Adafactor's factored ``vr``/``vc``
for every leaf of two or more axes) and ``step``, an int32 scalar tensor.
``update`` writes the new parameters and state into the tensors it is
given, under ``torch.no_grad()``: the counterpart of the reference's
donated buffers. The learning rate and the bias corrections are computed
on the parameters' device from ``step``, so an update makes no host sync.

``state_specs`` gives the state's logical PartitionSpecs from the
parameters' (each moment as its parameter; Adafactor's factored ``vr``
and ``vc`` drop the last or the second-to-last axis). On a mesh the
parameters, gradients and state are DTensors: the global norm is reduced
over the mesh, and both updates run on each rank's shards. Adafactor's
factored statistics and its update RMS span a whole leaf: each rank sums
them over its shard and all-reduces the sums over the mesh axes that split
the leaf, so no rank holds more of a leaf than its shard.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.models.param import aligned_leaves as _aligned
from repro_torch.models.param import (as_tree, sorted_leaves, tree_leaves,
                                      tree_map)
from repro_torch.models.sharding import P


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _local(x: torch.Tensor) -> torch.Tensor:
    """This rank's shard of a DTensor (sharing its storage: writes land in
    the DTensor), or the tensor itself."""
    return x.to_local() if _is_dtensor(x) else x


def _to_placements(g, like):
    """A DTensor gradient reduced to its parameter's placements (once:
    a gradient may arrive ``Partial``)."""
    if _is_dtensor(g) and g.placements != like.placements:
        return g.redistribute(like.device_mesh, like.placements)
    return g


# ---------------------------------------------------------------------------
# schedule
# ---------------------------------------------------------------------------


def warmup_cosine(base_lr: float, warmup: int, total: int,
                  min_frac: float = 0.1
                  ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Linear warmup to ``base_lr``, then a cosine down to ``min_frac`` of
    it at ``total``. The returned function takes the step as a tensor and
    gives a float32 tensor on its device."""
    def lr(step: torch.Tensor) -> torch.Tensor:
        step = torch.as_tensor(step).to(torch.float32)
        warm = base_lr * torch.clamp((step + 1) / max(warmup, 1), max=1.0)
        t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = base_lr * (min_frac + (1 - min_frac) * 0.5
                         * (1 + torch.cos(math.pi * t)))
        return torch.where(step < warmup, warm, cos)
    return lr


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's float32 sum of squares, the leaves
    summed in the reference's order (keys sorted): a restored tree, whose
    dicts keep another order, gives the same bits. DTensor leaves are
    reduced over their mesh; the norm is a plain tensor."""
    sq = torch.stack([x.float().square().sum()
                      for x in sorted_leaves(tree)]).sum()
    if _is_dtensor(sq):
        sq = sq.full_tensor()
    return torch.sqrt(sq)


def clip_by_global_norm(tree, max_norm: float):
    """(the tree scaled so its global norm is at most ``max_norm``, each
    leaf scaled in float32 and cast back to its dtype; the norm before)."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), tree), norm


def _zeros32(p: torch.Tensor, shape=None) -> torch.Tensor:
    return torch.zeros(p.shape if shape is None else shape,
                       dtype=torch.float32, device=p.device)


def _write(p: torch.Tensor, new32: torch.Tensor) -> None:
    """The new float32 value of ``p`` written into it in its dtype."""
    if new32 is not p:
        p.copy_(new32)




# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class AdamW:
    lr: Callable
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip: float = 1.0

    def init(self, params) -> dict:
        step = torch.zeros((), dtype=torch.int32,
                           device=tree_leaves(params)[0].device)
        return {"m": tree_map(_zeros32, params),
                "v": tree_map(_zeros32, params), "step": step}

    def state_specs(self, param_specs):
        return {"m": param_specs, "v": param_specs, "step": P()}

    @torch.no_grad()
    def update(self, grads, state, params):
        """One step: clip, then the AdamW update of every leaf, written in
        place into ``params`` and ``state`` (on a mesh, into each rank's
        shards). Returns (params, state, the gradients' global norm before
        clipping)."""
        pl = tree_leaves(params)
        grads = as_tree(
            params, [_to_placements(g, p)
                     for g, p in zip(_aligned(grads, params), pl)])
        grads, gnorm = clip_by_global_norm(grads, self.clip)
        step = _local(state["step"])
        step.add_(1)
        t = step.to(torch.float32)
        lr = self.lr(step)
        bc1 = 1 - self.b1 ** t
        bc2 = 1 - self.b2 ** t
        ps = [_local(p) for p in pl]
        gs = [_local(g) for g in _aligned(grads, params)]
        ms = [_local(m) for m in _aligned(state["m"], params)]
        vs = [_local(v) for v in _aligned(state["v"], params)]
        g32 = [g.float() for g in gs]
        p32 = [p if p.dtype == torch.float32 else p.float() for p in ps]
        torch._foreach_mul_(ms, self.b1)
        torch._foreach_add_(ms, g32, alpha=1 - self.b1)
        torch._foreach_mul_(vs, self.b2)
        torch._foreach_addcmul_(vs, g32, g32, value=1 - self.b2)
        den = torch._foreach_div(vs, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        u = torch._foreach_div(ms, bc1)
        torch._foreach_div_(u, den)
        del den, g32
        if self.weight_decay:
            torch._foreach_add_(u, p32, alpha=self.weight_decay)
        torch._foreach_mul_(u, lr)
        torch._foreach_sub_(p32, u)
        for p, new in zip(ps, p32):
            _write(p, new)
        return params, state, gnorm


# ---------------------------------------------------------------------------
# Adafactor (factored second moments; memory ~0 extra for matrices)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Adafactor:
    lr: Callable
    decay: float = 0.99
    eps: float = 1e-30
    clip: float = 1.0
    rms_clip: float = 1.0
    weight_decay: float = 0.0

    def _factored(self, p) -> bool:
        return p.ndim >= 2

    def init(self, params) -> dict:
        def zeros(p):
            if self._factored(p):
                return {"vr": _zeros32(p, p.shape[:-1]),
                        "vc": _zeros32(p, p.shape[:-2] + p.shape[-1:])}
            return {"v": _zeros32(p)}
        step = torch.zeros((), dtype=torch.int32,
                           device=tree_leaves(params)[0].device)
        return {"v": tree_map(zeros, params), "step": step}

    def state_specs(self, param_specs):
        def one(s):
            t = tuple(s)
            if len(t) >= 2:
                return {"vr": P(*t[:-1]), "vc": P(*(t[:-2] + (t[-1],)))}
            return {"v": P(*t)}
        return {"v": tree_map(one, param_specs), "step": P()}

    @torch.no_grad()
    def update(self, grads, state, params):
        """One step: clip, then the Adafactor update of every leaf, written
        in place (a DTensor leaf on each rank's shards). Returns (params,
        state, the global norm before clipping)."""
        pl = tree_leaves(params)
        grads = as_tree(
            params, [_to_placements(g, p)
                     for g, p in zip(_aligned(grads, params), pl)])
        grads, gnorm = clip_by_global_norm(grads, self.clip)
        step = _local(state["step"])
        step.add_(1)
        lr = self.lr(step)
        for g, v, p in zip(_aligned(grads, params),
                           _aligned(state["v"], params), pl):
            sums = _mesh_sums(p, v) if _is_dtensor(p) else _no_sums
            self._update_leaf(_local(g), {k: _local(t) for k, t in v.items()},
                              _local(p), lr, p.shape, sums)
        return params, state, gnorm

    def _update_leaf(self, g, v, p, lr, shape, sums) -> None:
        """The update of one leaf of global ``shape`` from this rank's
        shards ``g``, ``v``, ``p``, written into ``v`` and ``p``.
        ``sums(x, dims)`` sums ``x`` over the ranks that split the leaf's
        tensor dims ``dims``."""
        d = self.decay
        n = len(shape)
        g32 = g.float()
        g2 = g32 * g32 + self.eps
        if self._factored(p):
            rows = sums(g2.sum(dim=-1), {n - 1}) / shape[-1]
            cols = sums(g2.sum(dim=-2), {n - 2}) / shape[-2]
            v["vr"].mul_(d).add_(rows, alpha=1 - d)
            v["vc"].mul_(d).add_(cols, alpha=1 - d)
            vr, vc = v["vr"], v["vc"]
            vr_mean = sums(vr.sum(dim=-1), {n - 2}) / shape[-2]
            denom = (vr[..., None] * vc[..., None, :]
                     / torch.clamp(vr_mean[..., None, None], min=self.eps))
            u = g32 * torch.rsqrt(denom + self.eps)
        else:
            v["v"].mul_(d).add_(g2, alpha=1 - d)
            u = g32 * torch.rsqrt(v["v"] + self.eps)
        rms = torch.sqrt(sums((u * u).sum(), set(range(n))) / math.prod(shape)
                         + 1e-30)
        u = u / torch.clamp(rms / self.rms_clip, min=1.0)
        p32 = p if p.dtype == torch.float32 else p.float()
        if self.weight_decay:
            u = u + self.weight_decay * p32
        _write(p, p32.sub_(lr * u))


def _no_sums(x, dims):
    return x


def _mesh_sums(p, v):
    """``sums`` of a DTensor leaf ``p`` (see ``Adafactor._update_leaf``):
    an all-reduce over each mesh axis that splits one of the dims. Its
    factored statistics ``v`` must be split as ``p`` is without the
    reduced dim, as ``state_specs`` gives them."""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard

    n = p.ndim

    def drop(dim):
        return tuple(Replicate() if isinstance(t, Shard) and t.dim == dim
                     else Shard(t.dim - 1) if isinstance(t, Shard)
                     and t.dim > dim else t for t in p.placements)
    want = ({"vr": drop(n - 1), "vc": drop(n - 2)} if n >= 2
            else {"v": p.placements})
    for k, t in v.items():
        if t.placements != want[k]:
            raise ValueError(
                f"Adafactor's {k!r} is split as {t.placements}; its "
                f"parameter's split {p.placements} needs {want[k]}")
    groups = [(t.dim, p.device_mesh.get_group(j))
              for j, t in enumerate(p.placements) if isinstance(t, Shard)]

    def sums(x, dims):
        for dim, group in groups:
            if dim in dims:
                dist.all_reduce(x, group=group)
        return x
    return sums


def make_optimizer(name: str, lr: float = 3e-4, warmup: int = 100,
                   total: int = 10_000):
    sched = warmup_cosine(lr, warmup, total)
    if name == "adamw":
        return AdamW(lr=sched)
    if name == "adafactor":
        return Adafactor(lr=sched)
    raise ValueError(name)
