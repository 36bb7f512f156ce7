"""Parameter construction: plain nested dicts of tensors in the reference's
layout (``linear`` weights ``(d_in, d_out)``, stacked layers ``(L, ...)``),
so a reference parameter tree crosses over leaf for leaf
(``convert.params_from_reference``). The reference's parameter sharding
specs ride on the same declarations: every leaf carries its logical
``spec`` (``models/sharding.py``'s tokens), and :func:`spec_tree` reads
them off without allocating anything.

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

import functools
import math
from dataclasses import dataclass, replace
from typing import Callable, List, Optional

import torch
from torch.utils import checkpoint as _ckpt

# float32 elements drawn at a time by materialize: 1 GiB
CHUNK = 1 << 28
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}


@dataclass(frozen=True)
class Init:
    """A parameter leaf not allocated yet: its shape, and either ``scale``
    (standard normal draws times ``scale``), the constant ``fill``, or
    ``values``: float32 constants along the last axis, the same for every
    index of the leading axes (no draw). ``spec`` is its logical
    PartitionSpec, one token (or ``None``) per axis."""
    shape: tuple
    scale: Optional[float] = None
    fill: float = 0.0
    values: Optional[tuple] = None
    spec: tuple = ()


def normal(shape: tuple, scale: float, spec: tuple = ()) -> Init:
    return Init(tuple(shape), scale=scale, spec=tuple(spec))


def linear(d_in: int, d_out: int, *, spec: tuple = (None, None),
           bias: bool = False, scale: Optional[float] = None) -> dict:
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    p = {"w": normal((d_in, d_out), scale, spec)}
    if bias:
        p["b"] = Init((d_out,), spec=(spec[-1],))
    return p


def constant(shape: tuple, values, spec: tuple = ()) -> Init:
    """A leaf of ``shape`` holding ``values`` (float32 constants, one per
    index of the last axis) at every index of the leading axes."""
    return Init(tuple(shape), values=tuple(float(v) for v in values),
                spec=tuple(spec))


def embedding(vocab: int, d: int, spec: tuple = ("tp", "fsdp")) -> dict:
    return {"table": normal((vocab, d), d ** -0.5, spec)}


def rmsnorm(d: int) -> dict:
    return {"scale": Init((d,), fill=1.0, spec=(None,))}


def stacked(tree: dict, n: int) -> dict:
    """``n`` independent copies of a layer tree of :class:`Init` leaves,
    stacked along a new leading axis (each copy drawn on its own; the
    stacked axis is not sharded)."""
    return tree_map(lambda s: replace(s, shape=(n,) + s.shape,
                                      spec=(None,) + s.spec), tree)


def spec_tree(tree) -> dict:
    """The logical PartitionSpecs (``sharding.P``) of a tree of
    :class:`Init` leaves, in the same structure."""
    from repro_torch.models.sharding import P

    return tree_map(lambda s: P(*s.spec), tree)


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
        if s.values is not None:
            return out.copy_(torch.tensor(s.values, dtype=torch.float32)
                             .expand(s.shape))
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


def apply_embedding(p: dict, cfg, tokens: torch.Tensor) -> torch.Tensor:
    """Token ids -> rows of the embedding table in the compute dtype."""
    return p["embed"]["table"][tokens.long()].to(DTYPES[cfg.dtype])


def apply_lm_head(p: dict, cfg, h_last: torch.Tensor) -> torch.Tensor:
    """float32 logits of the final hidden states: the final RMSNorm, then
    the head (the embedding table's transpose when ``cfg.tie_embeddings``)."""
    w = p["embed"]["table"].T if cfg.tie_embeddings else p["head"]["w"]
    h_last = apply_rmsnorm(p["ln_f"], h_last, cfg.norm_eps)
    return (h_last @ w.to(h_last.dtype)).float()


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over every leaf of a nested dict, with the matching leaves
    of ``rest`` (trees with at least ``tree``'s keys)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def aligned_leaves(tree, params) -> List:
    """The entries of ``tree`` (gradients, specs, or a state tree whose
    leaves may be dicts of moments) in ``tree_leaves(params)`` order,
    matched by key whatever order ``tree``'s dicts keep."""
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


def as_tree(params, leaves: list):
    """``leaves`` (in ``tree_leaves(params)`` order) in ``params``'s
    structure."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), params)


def sorted_leaves(tree) -> list:
    """Leaves in ``jax.tree.leaves``'s order (dict keys sorted), whatever
    order the dicts were built in: for sums over leaves that must not
    depend on it."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in sorted_leaves(tree[k])]
    return [tree]


# the top-level keys of the stacked layer trees, across the families
STACKS = ("layers", "enc", "dec")


def layer(params: dict, i: int) -> dict:
    """Layer ``i`` of a stacked layer tree (views, no copy)."""
    return tree_map(lambda a: a[i], params)


def unstack(params: dict, n: int) -> List[dict]:
    """The ``n`` layers of a stacked layer tree, each leaf unbound once.
    Under autograd one ``UnbindBackward`` stacks the layers' gradients;
    indexing each layer (:func:`layer`) would instead add a zero tensor of
    the whole stack per layer in backward."""
    parts = tree_map(lambda a: a.unbind(0), params)
    return [tree_map(lambda t: t[i], parts) for i in range(n)]


def count_params(params) -> int:
    return sum(x.numel() for x in tree_leaves(params))


def cast_tree(params, dtype: torch.dtype):
    """Every floating leaf cast to ``dtype``; the rest as they are."""
    return tree_map(lambda x: x.to(dtype) if x.is_floating_point() else x,
                    params)


# the matmuls whose outputs ``remat_policy="dots"`` saves: those with no
# batch dimension, as the reference's dots_with_no_batch_dims_saveable
# (a (B, S, d) @ (d, f) product reaches aten as one mm)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (_ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else _ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def maybe_remat(body: Callable, cfg) -> Callable:
    """``body`` under activation checkpointing per ``cfg.remat`` and
    ``cfg.remat_policy``, as the reference's ``jax.checkpoint`` around its
    scan body: in backward the body runs again instead of keeping its
    intermediates (``torch.utils.checkpoint``, non-reentrant); ``"dots"``
    keeps the matmul outputs and recomputes the rest. With grad mode off
    the body just runs."""
    if not cfg.remat:
        return body
    kw = {"use_reentrant": False}
    if getattr(cfg, "remat_policy", "full") == "dots":
        kw["context_fn"] = functools.partial(
            _ckpt.create_selective_checkpoint_contexts, _save_dots)

    def wrapped(*args):
        if not torch.is_grad_enabled():
            return body(*args)
        return _ckpt.checkpoint(body, *args, **kw)
    return wrapped
