"""Model API: family dispatch for the ported families.

A family module exposes ``init_lm(cfg, gen, device, dtype)``, ``forward``,
``init_cache(cfg, batch, max_seq)``, ``prefill`` and ``decode_step``. The
decoder-only families (``dense``, ``vlm``, ``moe``: ``models.transformer``)
are ported; ``ssm``, ``hybrid`` and ``encdec`` raise with their ROADMAP
item. The reference's ``input_specs``, ``param_specs`` and
``cache_shapes`` return PartitionSpecs for the trainer's layouts and wait
for ROADMAP A14.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import param as pm
from repro_torch.models import transformer

_FAMILY = {"dense": transformer, "vlm": transformer, "moe": transformer}
_NOT_PORTED = {"ssm": "A13b", "hybrid": "A13b", "encdec": "A13b"}


def module_for(cfg: ModelConfig):
    if cfg.family in _NOT_PORTED:
        raise NotImplementedError(
            f"model family {cfg.family!r} is not ported to repro_torch yet "
            f"(port queue item {_NOT_PORTED[cfg.family]} in ROADMAP.md)")
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


def make_small_batch(cfg: ModelConfig, gen: torch.Generator, batch: int = 2,
                     seq: int = 64, kind: str = "train",
                     device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Concrete small batch for smoke tests, drawn from ``gen`` on
    ``device``: token ids, or bf16 embeddings for a vlm model, and labels
    for ``kind="train"``."""
    dev = resolve_device(device)
    module_for(cfg)                   # ssm, hybrid, encdec raise (A13b)
    out: Dict[str, torch.Tensor] = {}
    if cfg.family == "vlm":
        out["embeddings"] = torch.randn(
            (batch, seq, cfg.d_model), generator=gen,
            device=dev).to(torch.bfloat16)
    else:
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
    memory is allocated). Entries that do not scale with seq are absent."""
    mod = module_for(cfg)
    small = mod.init_cache(cfg, batch, seq, device="meta")
    large = mod.init_cache(cfg, batch, 2 * seq, device="meta")
    axes: Dict[str, int] = {}
    for key, sa in small.items():
        sb = large[key]
        if sa.shape == sb.shape:
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
    sequence axis."""
    axes = cache_seq_axes(cfg) if axes is None else axes
    out = dict(cache)
    for key, ax in axes.items():
        x = cache[key]
        if x.shape[ax] >= new_seq:
            continue
        pads = [0, 0] * (x.ndim - ax - 1) + [0, new_seq - x.shape[ax]]
        out[key] = torch.nn.functional.pad(x, pads)
    return out
