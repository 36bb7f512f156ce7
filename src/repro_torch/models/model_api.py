"""Model API: family dispatch for the ported families.

A family module exposes ``init_lm(cfg, gen, device)``, ``forward``,
``init_cache(cfg, batch, max_seq)``, ``prefill`` and ``decode_step``. Only
the dense family (``models.transformer``) is ported; every other family of
the reference raises with its ROADMAP item.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch._device import DeviceLike
from repro_torch.configs.base import ModelConfig
from repro_torch.models import param as pm
from repro_torch.models import transformer

_FAMILY = {"dense": transformer}
_NOT_PORTED = {"vlm": "A13", "moe": "A13", "ssm": "A13", "hybrid": "A13",
               "encdec": "A13"}


def module_for(cfg: ModelConfig):
    if cfg.family in _NOT_PORTED:
        raise NotImplementedError(
            f"model family {cfg.family!r} is not ported to repro_torch yet "
            f"(port queue item {_NOT_PORTED[cfg.family]} in ROADMAP.md)")
    return _FAMILY[cfg.family]


def init(cfg: ModelConfig, gen: torch.Generator,
         device: DeviceLike = None) -> dict:
    """Parameters of ``cfg`` drawn from ``gen`` on ``device`` (``None`` =
    ``"cuda"``), cast to ``cfg.param_dtype``."""
    p = module_for(cfg).init_lm(cfg, gen, device)
    if cfg.param_dtype != "float32":
        p = pm.cast_tree(p, transformer.DTYPES[cfg.param_dtype])
    return p


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
