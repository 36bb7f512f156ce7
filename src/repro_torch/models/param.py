"""Parameter construction: plain nested dicts of tensors in the reference's
layout (``linear`` weights ``(d_in, d_out)``, stacked layers ``(L, ...)``),
so a reference parameter tree crosses over leaf for leaf
(``convert.params_from_reference``). The reference's parameter sharding
specs, which place parameters over a mesh, wait for the trainer (ROADMAP
A14).

A model's init is built in two steps. The family's init functions return a
tree of :class:`Init` leaves (shape, and how to fill it); :func:`stacked`
gives a layer tree its leading ``(L,)`` axis. :func:`materialize` then
allocates every leaf ONCE, in the parameter dtype, and draws it from an
explicit ``torch.Generator`` in float32 chunks of at most ``CHUNK``
elements, each cast into place. The peak is the model's bytes in its
parameter dtype plus one chunk, so a model whose float32 tree would not fit
on the card (llava-next-34b's is 126 GiB) is drawn in place in bf16.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Callable, Optional

import torch

# float32 elements drawn at a time by materialize: 1 GiB
CHUNK = 1 << 28
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}


@dataclass(frozen=True)
class Init:
    """A parameter leaf not allocated yet: its shape, and either ``scale``
    (standard normal draws times ``scale``) or the constant ``fill``."""
    shape: tuple
    scale: Optional[float] = None
    fill: float = 0.0


def normal(shape: tuple, scale: float) -> Init:
    return Init(tuple(shape), scale=scale)


def linear(d_in: int, d_out: int, *, bias: bool = False,
           scale: Optional[float] = None) -> dict:
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    p = {"w": normal((d_in, d_out), scale)}
    if bias:
        p["b"] = Init((d_out,))
    return p


def embedding(vocab: int, d: int) -> dict:
    return {"table": normal((vocab, d), d ** -0.5)}


def rmsnorm(d: int) -> dict:
    return {"scale": Init((d,), fill=1.0)}


def stacked(tree: dict, n: int) -> dict:
    """``n`` independent copies of a layer tree of :class:`Init` leaves,
    stacked along a new leading axis (each copy drawn on its own)."""
    return tree_map(lambda s: replace(s, shape=(n,) + s.shape), tree)


def materialize(tree, gen: torch.Generator, device: torch.device,
                dtype: torch.dtype = torch.float32):
    """Tensors for a tree of :class:`Init` leaves on ``device``: each leaf
    allocated once in ``dtype`` and drawn from ``gen`` (on ``device``) in
    float32 chunks of at most ``CHUNK`` elements, cast into place. On the
    ``meta`` device nothing is drawn."""
    def make(s: Init) -> torch.Tensor:
        out = torch.empty(s.shape, dtype=dtype, device=device)
        if out.device.type == "meta":
            return out
        if s.scale is None:
            return out.fill_(s.fill)
        flat = out.view(-1)
        for i in range(0, flat.numel(), CHUNK):
            n = min(CHUNK, flat.numel() - i)
            flat[i:i + n].copy_(torch.randn(n, generator=gen,
                                            device=out.device).mul_(s.scale))
        return out
    return tree_map(make, tree)


def apply_linear(p: dict, x: torch.Tensor, compute_dtype=None) -> torch.Tensor:
    """Matmul in the activation dtype: master params (f32) are cast to
    x.dtype (bf16 compute) so layer outputs keep the residual dtype."""
    dtype = compute_dtype or x.dtype
    y = x.to(dtype) @ p["w"].to(dtype)
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


def apply_rmsnorm(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(x.dtype)


def apply_swiglu(p: dict, x: torch.Tensor) -> torch.Tensor:
    """The SwiGLU MLP ``wd(silu(wg x) * wu x)`` of a dense layer."""
    h = (torch.nn.functional.silu(apply_linear(p["wg"], x))
         * apply_linear(p["wu"], x))
    return apply_linear(p["wd"], h)


def apply_lm_head(p: dict, cfg, h_last: torch.Tensor) -> torch.Tensor:
    """float32 logits of the final hidden states: the final RMSNorm, then
    the head (the embedding table's transpose when ``cfg.tie_embeddings``)."""
    w = p["embed"]["table"].T if cfg.tie_embeddings else p["head"]["w"]
    h_last = apply_rmsnorm(p["ln_f"], h_last, cfg.norm_eps)
    return (h_last @ w.to(h_last.dtype)).float()


def tree_map(fn: Callable, tree):
    """``fn`` over every leaf of a nested dict."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def layer(params: dict, i: int) -> dict:
    """Layer ``i`` of a stacked layer tree (views, no copy)."""
    return tree_map(lambda a: a[i], params)
