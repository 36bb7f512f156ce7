"""Zamba2-style hybrid, as the reference's ``models/hybrid.py``: a stack of
mamba2 layers with one SHARED attention block (its parameters reused)
applied every ``shared_attn_every`` layers on ``concat(h, x_embed)``, so
the shared block always sees both the residual stream and the original
embedding.

Structure per group g: shared_attn(concat(h, x0)) -> 2d -> projected to d
and added residually; then ``shared_attn_every`` mamba2 layers. Every group
runs ``shared_attn_every`` layers, so the stack holds ``n_groups *
shared_attn_every`` layers (42 for zamba2-1.2b's 38), as the reference's.

With ``backend="clusterkv"`` and ``cfg.clusterkv.enabled`` the shared block
attends through the ClusterKV paths: the block-sparse prefill kernel (B6)
once a group in ``prefill``, the fused decode kernel (B5) once a group in
``decode_step``. ``loss_fn`` is the training loss; each mamba2 layer of
``forward`` runs under remat, the shared block without, as the
reference's. The cache's PartitionSpecs wait for ROADMAP A14b.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import mamba
from repro_torch.models import param as pm
from repro_torch.models.sharding import NO_SHARD, ShardCtx
from repro_torch.models.transformer import ce_loss


def _n_groups(cfg: ModelConfig) -> int:
    return -(-cfg.n_layers // cfg.shared_attn_every)


def _heads(cfg: ModelConfig) -> Tuple[int, int, int]:
    """(2 d, heads, head dim) of the shared block over the concat stream."""
    d2 = 2 * cfg.d_model
    return d2, cfg.n_heads, d2 // cfg.n_heads


def _init_shared(cfg: ModelConfig) -> dict:
    """Shared transformer block over the 2*d concat stream."""
    d2, hq, dh = _heads(cfg)
    return {"ln1": pm.rmsnorm(d2),
            "wq": pm.linear(d2, hq * dh), "wk": pm.linear(d2, hq * dh),
            "wv": pm.linear(d2, hq * dh), "wo": pm.linear(hq * dh, d2),
            "ln2": pm.rmsnorm(d2),
            "wg": pm.linear(d2, cfg.d_ff), "wu": pm.linear(d2, cfg.d_ff),
            "wd": pm.linear(cfg.d_ff, d2),
            "out": pm.linear(d2, cfg.d_model)}


def init_lm(cfg: ModelConfig, gen: torch.Generator,
            device: DeviceLike = None, dtype: torch.dtype = torch.float32
            ) -> dict:
    """Random parameters drawn from ``gen`` on ``device``, each leaf
    allocated once in ``dtype`` (``param.materialize``)."""
    layer = {"ln": pm.rmsnorm(cfg.d_model), "mixer": mamba.init_mamba2(cfg)}
    p = {"embed": pm.embedding(cfg.vocab, cfg.d_model),
         "shared": _init_shared(cfg),
         "layers": pm.stacked(layer,
                              _n_groups(cfg) * cfg.shared_attn_every),
         "ln_f": pm.rmsnorm(cfg.d_model),
         "head": pm.linear(cfg.d_model, cfg.vocab)}
    return pm.materialize(p, gen, resolve_device(device), dtype)


def _split_heads(t: torch.Tensor, hq: int, dh: int) -> torch.Tensor:
    b, s, _ = t.shape
    return t.reshape(b, s, hq, dh).transpose(1, 2)


def _shared_qkv(sp, h2, cfg: ModelConfig, pos):
    """q, k, v (B, H, S, dh) of the shared block, RoPE at ``pos`` (S,)."""
    _, hq, dh = _heads(cfg)
    hn = pm.apply_rmsnorm(sp["ln1"], h2, cfg.norm_eps)
    q = _split_heads(pm.apply_linear(sp["wq"], hn), hq, dh)
    k = _split_heads(pm.apply_linear(sp["wk"], hn), hq, dh)
    v = _split_heads(pm.apply_linear(sp["wv"], hn), hq, dh)
    q = attn.rope(q, pos[None, None, :], cfg.rope_theta)
    k = attn.rope(k, pos[None, None, :], cfg.rope_theta)
    return q, k, v


def _shared_tail(sp, h2, o, cfg: ModelConfig) -> torch.Tensor:
    """The block after attention: output projection and residual, the
    SwiGLU MLP and residual, and the projection back to d."""
    b, s, _ = h2.shape
    h2 = h2 + pm.apply_linear(sp["wo"], o.transpose(1, 2).reshape(b, s, -1))
    hn = pm.apply_rmsnorm(sp["ln2"], h2, cfg.norm_eps)
    f = F.silu(pm.apply_linear(sp["wg"], hn)) * pm.apply_linear(sp["wu"], hn)
    h2 = h2 + pm.apply_linear(sp["wd"], f)
    return pm.apply_linear(sp["out"], h2)


def _shared_block_kv(sp, h, x0, pos, cfg: ModelConfig, backend: str):
    """The shared block's d-dim residual contribution, and its k and v."""
    h2 = torch.cat([h, x0], dim=-1)
    q, k, v = _shared_qkv(sp, h2, cfg, pos)
    if backend == "clusterkv" and cfg.clusterkv.enabled:
        o = attn.clusterkv_attention(q, k, v, pos, pos, cfg.clusterkv)
    elif backend == "dense":
        o = attn.dense_attention(q, k, v, pos, pos)
    else:
        o = attn.flash_attention(q, k, v, pos, pos)
    return _shared_tail(sp, h2, o, cfg), k, v


def _shared_block(sp, h, x0, pos, cfg: ModelConfig, backend: str,
                  shd: ShardCtx = NO_SHARD) -> torch.Tensor:
    """Returns the d-dim residual contribution of the shared block."""
    return _shared_block_kv(sp, h, x0, pos, cfg, backend)[0]


def _group_params(p, g: int, per: int) -> dict:
    """Group ``g``'s ``per`` stacked layers (views, no copy)."""
    return pm.tree_map(lambda a: a[g * per:(g + 1) * per], p["layers"])


def forward(p, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            backend: str = "flash", shd: ShardCtx = NO_SHARD
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (final hidden states (B,S,d), a zero aux loss)."""
    x0 = pm.apply_embedding(p, cfg, batch["tokens"])
    h = x0
    pos = torch.arange(h.shape[1], dtype=torch.int32, device=h.device)
    per = cfg.shared_attn_every

    def mamba_body(lp, x):
        y, _, _, _ = mamba.mamba2_forward(
            lp["mixer"], pm.apply_rmsnorm(lp["ln"], x, cfg.norm_eps), cfg,
            shd)
        return x + y

    mamba_body = pm.maybe_remat(mamba_body, cfg)
    layers = pm.unstack(p["layers"], _n_groups(cfg) * per)
    for g in range(_n_groups(cfg)):
        h = h + _shared_block(p["shared"], h, x0, pos, cfg, backend, shd)
        for lp in layers[g * per:(g + 1) * per]:
            h = mamba_body(lp, h)
    return (pm.apply_rmsnorm(p["ln_f"], h, cfg.norm_eps),
            torch.zeros((), device=h.device))


def loss_fn(p, cfg: ModelConfig, batch, backend: str = "flash",
            shd: ShardCtx = NO_SHARD) -> torch.Tensor:
    """Chunked cross-entropy of ``batch["labels"]`` through the head."""
    h, _ = forward(p, cfg, batch, backend, shd)
    return ce_loss(h, p["head"]["w"].to(pm.DTYPES[cfg.dtype]),
                   batch["labels"], cfg.loss_chunk)


def init_cache(cfg: ModelConfig, batch_size: int, max_seq: int, dtype=None,
               device: DeviceLike = None) -> Dict[str, Any]:
    dtype = dtype or pm.DTYPES[cfg.dtype]
    dev = resolve_device(device)
    groups = _n_groups(cfg)
    _, hq, dh = _heads(cfg)
    st = mamba.mamba2_state(cfg, groups * cfg.shared_attn_every, batch_size,
                            device=dev)
    shape = (groups, batch_size, hq, max_seq, dh)
    return {"ssm": st,
            "k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev),
            "pos": torch.zeros((), dtype=torch.int32, device=dev)}


def prefill(p, cfg: ModelConfig, batch, backend: str = "flash",
            shd: ShardCtx = NO_SHARD) -> Tuple[Dict, torch.Tensor]:
    """Forward over the prompt: each group's shared-block k/v (in
    ``cfg.dtype``), every mamba2 layer's final state and conv buffers
    (float32), and the last position's logits."""
    x0 = pm.apply_embedding(p, cfg, batch["tokens"])
    h = x0
    s = h.shape[1]
    pos = torch.arange(s, dtype=torch.int32, device=h.device)
    per = cfg.shared_attn_every
    dt = pm.DTYPES[cfg.dtype]
    ks, vs, hs, cxs, cbcs = [], [], [], [], []
    for g in range(_n_groups(cfg)):
        out, k, v = _shared_block_kv(p["shared"], h, x0, pos, cfg, backend)
        ks.append(k.to(dt))
        vs.append(v.to(dt))
        h = h + out
        gp = _group_params(p, g, per)
        for j in range(per):
            lp = pm.layer(gp, j)
            y, h_fin, cx, cbc = mamba.mamba2_forward(
                lp["mixer"], pm.apply_rmsnorm(lp["ln"], h, cfg.norm_eps),
                cfg, shd)
            h = h + y
            hs.append(h_fin)
            cxs.append(cx.float())
            cbcs.append(cbc.float())
    cache = {"ssm": {"h": torch.stack(hs), "conv_x": torch.stack(cxs),
                     "conv_bc": torch.stack(cbcs)},
             "k": torch.stack(ks), "v": torch.stack(vs),
             "pos": torch.tensor(s, dtype=torch.int32, device=h.device)}
    return cache, pm.apply_lm_head(p, cfg, h[:, -1])


def decode_step(p, cfg: ModelConfig, cache, tokens, backend: str = "flash",
                sharded_long: bool = False, shd: ShardCtx = NO_SHARD
                ) -> Tuple[torch.Tensor, Dict]:
    """One decode step at the scalar position ``cache["pos"]``. tokens
    (B, 1).

    Where the reference returns new cache arrays, the port writes the new
    key/value rows into ``cache["k"]``/``cache["v"]`` and each layer's new
    state and conv buffers into ``cache["ssm"]`` in place; the returned
    cache shares them. With ``backend="clusterkv"`` (and the config's
    ClusterKV on) each group's shared block attends through
    ``attention.clusterkv_decode`` (B5), or, with ``sharded_long=True``
    and a mesh in ``shd``, through ``clusterkv_decode_sharded``."""
    x0 = pm.apply_embedding(p, cfg, tokens)
    h = x0
    b = h.shape[0]
    dev = h.device
    qpos = torch.as_tensor(cache["pos"], device=dev)
    qi = qpos.long()
    s_max = cache["k"].shape[3]
    kpos = torch.arange(s_max, dtype=torch.int32, device=dev)
    rope_pos = qpos.reshape(1, 1, 1).to(torch.int32)
    per = cfg.shared_attn_every
    _, hq, dh = _heads(cfg)
    sp = p["shared"]
    ssm = cache["ssm"]
    for g in range(_n_groups(cfg)):
        h2 = torch.cat([h, x0], dim=-1)
        hn = pm.apply_rmsnorm(sp["ln1"], h2, cfg.norm_eps)
        q = _split_heads(pm.apply_linear(sp["wq"], hn), hq, dh)
        k1 = _split_heads(pm.apply_linear(sp["wk"], hn), hq, dh)
        v1 = _split_heads(pm.apply_linear(sp["wv"], hn), hq, dh)
        q = attn.rope(q, rope_pos, cfg.rope_theta)
        k1 = attn.rope(k1, rope_pos, cfg.rope_theta)
        kc, vc = cache["k"][g], cache["v"][g]            # (B,H,S,dh) views
        kc[:, :, qi] = k1[:, :, 0].to(kc.dtype)
        vc[:, :, qi] = v1[:, :, 0].to(vc.dtype)
        q1 = q[:, :, 0]
        if backend == "clusterkv" and cfg.clusterkv.enabled:
            if sharded_long and shd.mesh is not None:
                o = attn.clusterkv_decode_sharded(q1, kc, vc, kpos, qpos,
                                                  cfg.clusterkv, shd.mesh)
            else:
                o = attn.clusterkv_decode(q1, kc, vc, kpos, qpos,
                                          cfg.clusterkv)
        else:
            o = attn.decode_attention(q1, kc, vc, kpos, qpos)
        h = h + _shared_tail(sp, h2, o[:, :, None], cfg)
        gp = _group_params(p, g, per)
        for j in range(per):
            i = g * per + j
            lp = pm.layer(gp, j)
            y, hst, cx, cbc = mamba.mamba2_step(
                lp["mixer"], pm.apply_rmsnorm(lp["ln"], h, cfg.norm_eps),
                ssm["h"][i], ssm["conv_x"][i], ssm["conv_bc"][i], cfg)
            ssm["h"][i].copy_(hst)
            ssm["conv_x"][i].copy_(cx)
            ssm["conv_bc"][i].copy_(cbc)
            h = h + y
    logits = pm.apply_lm_head(p, cfg, h[:, 0])
    return logits, {"ssm": ssm, "k": cache["k"], "v": cache["v"],
                    "pos": cache["pos"] + 1}
