"""falcon-mamba-style attention-free LM: a stack of mamba1 blocks, as the
reference's ``models/ssm_lm.py``. Layers are stacked ``(L, ...)`` and
applied by a Python loop (the reference's ``lax.scan``), each under remat
in ``forward``; ``loss_fn`` is the training loss."""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import mamba
from repro_torch.models import param as pm
from repro_torch.models.sharding import NO_SHARD, P, ShardCtx
from repro_torch.models.transformer import ce_loss


def _init_layer(cfg: ModelConfig) -> dict:
    return {"ln": pm.rmsnorm(cfg.d_model), "mixer": mamba.init_mamba1(cfg)}


def declare(cfg: ModelConfig) -> dict:
    """The parameter tree as ``param.Init`` leaves (shapes, draws, specs)."""
    return {"embed": pm.embedding(cfg.vocab, cfg.d_model),
            "layers": pm.stacked(_init_layer(cfg), cfg.n_layers),
            "ln_f": pm.rmsnorm(cfg.d_model),
            "head": pm.linear(cfg.d_model, cfg.vocab, spec=("fsdp", "tp"))}


def init_lm(cfg: ModelConfig, gen: torch.Generator,
            device: DeviceLike = None, dtype: torch.dtype = torch.float32
            ) -> dict:
    """Random parameters drawn from ``gen`` on ``device``, each leaf
    allocated once in ``dtype`` (``param.materialize``)."""
    return pm.materialize(declare(cfg), gen, resolve_device(device), dtype)


def param_specs(cfg: ModelConfig) -> dict:
    """The logical PartitionSpec of every parameter, in ``init_lm``'s
    structure."""
    return pm.spec_tree(declare(cfg))


def forward(p, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            backend: str = "flash", shd: ShardCtx = NO_SHARD
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (final hidden states (B,S,d), a zero aux loss). Each layer
    runs under ``param.maybe_remat`` (``cfg.remat``)."""
    h = pm.apply_embedding(p, cfg, batch["tokens"])

    def body(lp, x):
        lp = shd.layer(lp, "layers")
        y, _, _ = mamba.mamba1_forward(
            lp["mixer"], pm.apply_rmsnorm(lp["ln"], x, cfg.norm_eps), cfg,
            shd)
        return x + y

    body = pm.maybe_remat(body, cfg)
    for lp in pm.unstack(p["layers"], cfg.n_layers):
        h = body(lp, h)
    return (pm.apply_rmsnorm(p["ln_f"], h, cfg.norm_eps),
            torch.zeros((), device=h.device))


def loss_fn(p, cfg: ModelConfig, batch, backend: str = "flash",
            shd: ShardCtx = NO_SHARD) -> torch.Tensor:
    """Chunked cross-entropy of ``batch["labels"]`` through the head."""
    h, _ = forward(p, cfg, batch, backend, shd)
    return ce_loss(h, p["head"]["w"].to(pm.DTYPES[cfg.dtype]),
                   batch["labels"], cfg.loss_chunk)


def cache_specs(cfg: ModelConfig, long_context: bool = False) -> dict:
    """Logical PartitionSpecs of the recurrent state (the same for any
    context length: it does not grow)."""
    return {"h": P(None, "dp", "tp", None),
            "conv": P(None, "dp", None, "tp"),
            "pos": P()}


def init_cache(cfg: ModelConfig, batch_size: int, max_seq: int,
               dtype=torch.float32, device: DeviceLike = None
               ) -> Dict[str, Any]:
    st = mamba.mamba1_state(cfg, batch_size, dtype, device)
    st["pos"] = torch.zeros((), dtype=torch.int32, device=st["h"].device)
    return st


def prefill(p, cfg: ModelConfig, batch, backend: str = "flash",
            shd: ShardCtx = NO_SHARD) -> Tuple[Dict, torch.Tensor]:
    """Forward over the prompt: the per-layer final states and conv
    buffers (float32) and the last position's logits."""
    h = pm.apply_embedding(p, cfg, batch["tokens"])
    s = h.shape[1]
    hs, convs = [], []
    for i in range(cfg.n_layers):
        lp = pm.layer(p["layers"], i)
        y, h_fin, conv_buf = mamba.mamba1_forward(
            lp["mixer"], pm.apply_rmsnorm(lp["ln"], h, cfg.norm_eps), cfg,
            shd)
        h = h + y
        hs.append(h_fin)
        convs.append(conv_buf.float())
    cache = {"h": torch.stack(hs), "conv": torch.stack(convs),
             "pos": torch.tensor(s, dtype=torch.int32, device=h.device)}
    return cache, pm.apply_lm_head(p, cfg, h[:, -1])


def decode_step(p, cfg: ModelConfig, cache, tokens, backend: str = "flash",
                sharded_long: bool = False, shd: ShardCtx = NO_SHARD
                ) -> Tuple[torch.Tensor, Dict]:
    """One decode step. tokens (B, 1). Where the reference returns new
    state arrays, the port writes each layer's new state and conv buffer
    into ``cache["h"]`` and ``cache["conv"]`` in place; the returned cache
    shares them."""
    h = pm.apply_embedding(p, cfg, tokens)
    for i in range(cfg.n_layers):
        lp = pm.layer(p["layers"], i)
        y, hst, conv_buf = mamba.mamba1_step(
            lp["mixer"], pm.apply_rmsnorm(lp["ln"], h, cfg.norm_eps),
            cache["h"][i], cache["conv"][i], cfg)
        cache["h"][i].copy_(hst)
        cache["conv"][i].copy_(conv_buf)
        h = h + y
    logits = pm.apply_lm_head(p, cfg, h[:, 0])
    return logits, {"h": cache["h"], "conv": cache["conv"],
                    "pos": cache["pos"] + 1}
