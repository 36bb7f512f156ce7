"""Model API: family dispatch for every family of the reference.

A family module exposes ``init_lm(cfg, gen, device, dtype)``, ``forward``,
``loss_fn``, ``init_cache(cfg, batch, max_seq)``, ``prefill`` and
``decode_step``, and the logical PartitionSpecs ``param_specs(cfg)`` and
``cache_specs(cfg, long_context)``: the
decoder-only families (``dense``, ``vlm``, ``moe``: ``models.transformer``),
``ssm`` (``models.ssm_lm``), ``hybrid`` (``models.hybrid``) and ``encdec``
(``models.encdec``). ``input_specs`` and ``cache_shapes`` give a shape
cell's inputs and decode cache as ``meta`` tensors (the counterpart of the
reference's ``ShapeDtypeStruct`` values and ``eval_shape``) beside their
logical specs, which ``models.sharding`` resolves onto a mesh.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.configs.base import SHAPES, ModelConfig
from repro_torch.models import param as pm
from repro_torch.models import encdec, hybrid, ssm_lm, transformer
from repro_torch.models import sharding
from repro_torch.models.sharding import P

_FAMILY = {"dense": transformer, "vlm": transformer, "moe": transformer,
           "ssm": ssm_lm, "hybrid": hybrid, "encdec": encdec}


def module_for(cfg: ModelConfig):
    return _FAMILY[cfg.family]


def init(cfg: ModelConfig, gen: torch.Generator,
         device: DeviceLike = None) -> dict:
    """Parameters of ``cfg`` drawn from ``gen`` on ``device`` (``None`` =
    ``"cuda"``), each leaf allocated once in ``cfg.param_dtype``."""
    return module_for(cfg).init_lm(cfg, gen, device,
                                   pm.DTYPES[cfg.param_dtype])


def param_shapes(cfg: ModelConfig) -> dict:
    """The parameter tree of ``cfg`` on the ``meta`` device: shapes and
    dtypes, no memory."""
    return init(cfg, torch.Generator(), device="meta")


def param_specs(cfg: ModelConfig) -> dict:
    """The logical PartitionSpec of every parameter (no allocation)."""
    return module_for(cfg).param_specs(cfg)


def compute_specs(cfg: ModelConfig, mesh, seq: int) -> dict:
    """Physical PartitionSpec of each parameter as the mesh train step
    computes with it at sequence length ``seq``: the family's split
    (``transformer.compute_specs``: tensor-parallel attention and MLP, the
    MoE FFN's experts), or every parameter gathered whole."""
    mod = module_for(cfg)
    if hasattr(mod, "compute_specs"):
        return mod.compute_specs(cfg, mesh, seq)
    return sharding.whole(param_specs(cfg))


def input_specs(cfg: ModelConfig, shape_name: str
                ) -> Tuple[Dict[str, torch.Tensor], Dict[str, P]]:
    """``meta`` tensors + logical PartitionSpecs for every model input of
    the shape cell ``shape_name`` (no allocation)."""
    seq, batch, kind = SHAPES[shape_name]
    d = cfg.d_model

    def S(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    i32, bf16 = torch.int32, torch.bfloat16
    if kind in ("train", "prefill"):
        if cfg.family == "vlm":
            specs = {"embeddings": S((batch, seq, d), bf16)}
            parts = {"embeddings": P("dp", None, None)}
        elif cfg.family == "encdec":
            specs = {"frames": S((batch, seq, d), bf16),
                     "tokens": S((batch, seq), i32)}
            parts = {"frames": P("dp", None, None), "tokens": P("dp", None)}
        else:
            specs = {"tokens": S((batch, seq), i32)}
            parts = {"tokens": P("dp", None)}
        if kind == "train":
            specs["labels"] = S((batch, seq), i32)
            parts["labels"] = P("dp", None)
        return specs, parts
    # decode: one new token against a seq-long cache
    if cfg.family == "vlm":
        return ({"tokens": S((batch, 1, d), bf16)},
                {"tokens": P("dp", None, None)})
    return {"tokens": S((batch, 1), i32)}, {"tokens": P("dp", None)}


def cache_shapes(cfg: ModelConfig, shape_name: str):
    """The decode cache of a shape cell as ``meta`` tensors, and its
    logical specs (a long-context cell shards the sequence)."""
    seq, batch, kind = SHAPES[shape_name]
    if kind != "decode":
        raise ValueError(f"{shape_name} is a {kind} cell, not a decode cell")
    mod = module_for(cfg)
    shapes = mod.init_cache(cfg, batch, seq, device="meta")
    specs = mod.cache_specs(cfg, long_context=shape_name.startswith("long"))
    return shapes, specs


def make_small_batch(cfg: ModelConfig, gen: torch.Generator, batch: int = 2,
                     seq: int = 64, kind: str = "train",
                     device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Concrete small batch for smoke tests, drawn from ``gen`` on
    ``device``: token ids, bf16 embeddings for a vlm model, bf16 frame
    embeddings and token ids for an encdec model, and labels for
    ``kind="train"``."""
    dev = resolve_device(device)
    out: Dict[str, torch.Tensor] = {}
    if cfg.family in ("vlm", "encdec"):
        key = "embeddings" if cfg.family == "vlm" else "frames"
        out[key] = torch.randn((batch, seq, cfg.d_model), generator=gen,
                               device=dev).to(torch.bfloat16)
    if cfg.family != "vlm":
        out["tokens"] = torch.randint(0, cfg.vocab, (batch, seq),
                                      generator=gen, device=dev)
    if kind == "train":
        out["labels"] = torch.randint(0, cfg.vocab, (batch, seq),
                                      generator=gen, device=dev)
    return out


def backend_for(cfg: ModelConfig, shape_name: str,
                use_clusterkv: bool = False) -> str:
    """Default attention backend per cell (paper-faithful baselines use
    flash; long_500k uses the arch's sub-quadratic path)."""
    if shape_name.startswith("long"):
        if cfg.long_context == "clusterkv":
            return "clusterkv"
        return "flash"      # swa / ssm are natively sub-quadratic
    if use_clusterkv and cfg.clusterkv.enabled:
        return "clusterkv"
    return "flash"


def cache_seq_axes(cfg: ModelConfig, batch: int = 1, seq: int = 8
                   ) -> Dict[str, int]:
    """Which axis of each cache entry is the sequence axis, read off the
    family's own ``init_cache`` at two lengths (on the ``meta`` device: no
    memory is allocated). Entries that do not scale with seq, and entries
    that are not tensors (the hybrid's nested ``"ssm"`` state), are
    absent."""
    mod = module_for(cfg)
    small = mod.init_cache(cfg, batch, seq, device="meta")
    large = mod.init_cache(cfg, batch, 2 * seq, device="meta")
    axes: Dict[str, int] = {}
    for key, sa in small.items():
        sb = large[key]
        if not isinstance(sa, torch.Tensor) or sa.shape == sb.shape:
            continue
        diff = [i for i, (x, y) in enumerate(zip(sa.shape, sb.shape))
                if x != y]
        if len(diff) != 1:
            raise ValueError(
                f"cache entry {key!r} scales with seq on axes {diff}")
        axes[key] = diff[0]
    return axes


def grow_cache(cfg: ModelConfig, cache: Dict[str, Any], new_seq: int,
               axes: Dict[str, int] = None) -> Dict[str, Any]:
    """Zero-pad a (prefilled) cache out to ``new_seq`` along each entry's
    sequence axis; every other entry (the hybrid's ``"ssm"`` dict among
    them) is passed on as it is. An encdec model's cross caches ``xk``/
    ``xv`` scale with the cache length, so they are padded too (C38)."""
    axes = cache_seq_axes(cfg) if axes is None else axes
    out = dict(cache)
    for key, ax in axes.items():
        x = cache[key]
        if x.shape[ax] >= new_seq:
            continue
        pads = [0, 0] * (x.ndim - ax - 1) + [0, new_seq - x.shape[ax]]
        out[key] = torch.nn.functional.pad(x, pads)
    return out
