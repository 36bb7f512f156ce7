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

The reference's ``state_specs`` (the state's PartitionSpecs under a mesh)
waits for the mesh half of training, ROADMAP A14b.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, List

import torch

from repro_torch.models.param import sorted_leaves, tree_leaves, tree_map


def _not_ported() -> NotImplementedError:
    return NotImplementedError(
        "optimizer state_specs (placing the state over a mesh) is not "
        "ported to repro_torch yet (port queue item A14b in ROADMAP.md)")


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
    dicts keep another order, gives the same bits."""
    return torch.sqrt(torch.stack([x.float().square().sum()
                                   for x in sorted_leaves(tree)]).sum())


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


def _aligned(tree, params) -> List:
    """The entries of ``tree`` (gradients, or a state tree whose leaves
    may be dicts of moments) in ``tree_leaves(params)`` order, matched by
    key whatever order ``tree``'s dicts keep."""
    out: List = []

    def walk(t, p, path):
        if isinstance(p, dict):
            if not isinstance(t, dict) or set(t) != set(p):
                raise ValueError(f"tree at {path or '/'} does not match the "
                                 "parameters' keys")
            for k in p:
                walk(t[k], p[k], f"{path}/{k}")
        else:
            out.append(t)
    walk(tree, params, "")
    return out


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
        raise _not_ported()

    @torch.no_grad()
    def update(self, grads, state, params):
        """One step: clip, then the AdamW update of every leaf, written in
        place into ``params`` and ``state``. Returns (params, state, the
        gradients' global norm before clipping)."""
        grads, gnorm = clip_by_global_norm(grads, self.clip)
        state["step"].add_(1)
        t = state["step"].to(torch.float32)
        lr = self.lr(state["step"])
        bc1 = 1 - self.b1 ** t
        bc2 = 1 - self.b2 ** t
        ps = tree_leaves(params)
        gs = _aligned(grads, params)
        ms, vs = _aligned(state["m"], params), _aligned(state["v"], params)
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
        raise _not_ported()

    @torch.no_grad()
    def update(self, grads, state, params):
        """One step: clip, then the Adafactor update of every leaf, written
        in place. Returns (params, state, the global norm before
        clipping)."""
        grads, gnorm = clip_by_global_norm(grads, self.clip)
        state["step"].add_(1)
        lr = self.lr(state["step"])
        d = self.decay
        ps = tree_leaves(params)
        for g, v, p in zip(_aligned(grads, params),
                           _aligned(state["v"], params), ps):
            g32 = g.float()
            g2 = g32 * g32 + self.eps
            if self._factored(p):
                v["vr"].mul_(d).add_(g2.mean(dim=-1), alpha=1 - d)
                v["vc"].mul_(d).add_(g2.mean(dim=-2), alpha=1 - d)
                vr, vc = v["vr"], v["vc"]
                denom = (vr[..., None] * vc[..., None, :]
                         / torch.clamp(vr.mean(dim=-1)[..., None, None],
                                       min=self.eps))
                u = g32 * torch.rsqrt(denom + self.eps)
            else:
                v["v"].mul_(d).add_(g2, alpha=1 - d)
                u = g32 * torch.rsqrt(v["v"] + self.eps)
            rms = torch.sqrt(torch.mean(u * u) + 1e-30)
            u = u / torch.clamp(rms / self.rms_clip, min=1.0)
            p32 = p if p.dtype == torch.float32 else p.float()
            if self.weight_decay:
                u = u + self.weight_decay * p32
            _write(p, p32.sub_(lr * u))
        return params, state, gnorm


def make_optimizer(name: str, lr: float = 3e-4, warmup: int = 100,
                   total: int = 10_000):
    sched = warmup_cosine(lr, warmup, total)
    if name == "adamw":
        return AdamW(lr=sched)
    if name == "adafactor":
        return Adafactor(lr=sched)
    raise ValueError(name)
