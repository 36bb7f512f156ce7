"""Parameter construction: plain nested dicts of tensors in the reference's
layout (``linear`` weights ``(d_in, d_out)``, stacked layers ``(L, ...)``),
so a reference parameter tree crosses over leaf for leaf
(``convert.params_from_reference``). Weights are drawn from an explicit
``torch.Generator``. The reference's parameter sharding specs, which
place parameters over a mesh, wait for the trainer (ROADMAP A14)."""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch


def linear(gen: torch.Generator, d_in: int, d_out: int, *, bias: bool = False,
           device=None, scale: Optional[float] = None) -> dict:
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    p = {"w": torch.randn((d_in, d_out), generator=gen, device=device)
         * scale}
    if bias:
        p["b"] = torch.zeros((d_out,), device=device)
    return p


def apply_linear(p: dict, x: torch.Tensor, compute_dtype=None) -> torch.Tensor:
    """Matmul in the activation dtype: master params (f32) are cast to
    x.dtype (bf16 compute) so layer outputs keep the residual dtype."""
    dtype = compute_dtype or x.dtype
    y = x.to(dtype) @ p["w"].to(dtype)
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


def embedding(gen: torch.Generator, vocab: int, d: int, *, device=None) -> dict:
    return {"table": torch.randn((vocab, d), generator=gen, device=device)
            * d ** -0.5}


def rmsnorm(d: int, *, device=None) -> dict:
    return {"scale": torch.ones((d,), device=device)}


def apply_rmsnorm(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(x.dtype)


def tree_map(fn: Callable, tree):
    """``fn`` over every tensor leaf of a nested dict."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def stacked(init_fn: Callable, n: int) -> dict:
    """Stack ``n`` independent layer inits (``init_fn() -> params``) along
    a new leading axis."""
    layers = [init_fn() for _ in range(n)]
    return _stack(layers)


def _stack(trees: list):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def layer(params: dict, i: int) -> dict:
    """Layer ``i`` of a stacked layer tree (views, no copy)."""
    return tree_map(lambda a: a[i], params)


def cast_tree(params, dtype: torch.dtype):
    return tree_map(lambda x: x.to(dtype) if x.is_floating_point() else x,
                    params)
