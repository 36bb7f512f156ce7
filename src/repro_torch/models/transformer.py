"""Decoder-only transformer LM, dense family (GQA, optional QKV bias,
optional SWA, optional cluster-sparse attention).

Parameters are plain nested dicts of tensors in the reference's layout
(``models/param.py``); layers are stacked ``(L, ...)`` and applied by a
Python loop (the reference's ``lax.scan``). Everything runs eagerly. The
MoE FFN and MLA attention of the reference's other families wait for
ROADMAP A12; the plan-ordered decode step of the ClusterKV service
(``plan_decode_step``) waits for A7.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import param as pm

AUX_COEF = 0.01
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return DTYPES[cfg.dtype]


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (port queue item {item} "
        "in ROADMAP.md)")


def _check_dense(cfg: ModelConfig) -> None:
    if cfg.moe is not None:
        raise _not_ported("the MoE FFN", "A12")
    if cfg.mla is not None:
        raise _not_ported("MLA attention", "A12")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _init_attn(gen, cfg: ModelConfig, device):
    d, hq, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {"wq": pm.linear(gen, d, hq * dh, bias=cfg.qkv_bias, device=device),
            "wk": pm.linear(gen, d, hkv * dh, bias=cfg.qkv_bias,
                            device=device),
            "wv": pm.linear(gen, d, hkv * dh, bias=cfg.qkv_bias,
                            device=device),
            "wo": pm.linear(gen, hq * dh, d, device=device)}


def _init_mlp(gen, cfg: ModelConfig, device):
    d, f = cfg.d_model, cfg.d_ff
    return {"wg": pm.linear(gen, d, f, device=device),
            "wu": pm.linear(gen, d, f, device=device),
            "wd": pm.linear(gen, f, d, device=device)}


def _init_layer(gen, cfg: ModelConfig, device):
    return {"ln1": pm.rmsnorm(cfg.d_model, device=device),
            "ln2": pm.rmsnorm(cfg.d_model, device=device),
            "attn": _init_attn(gen, cfg, device),
            "ffn": _init_mlp(gen, cfg, device)}


def init_lm(cfg: ModelConfig, gen: torch.Generator,
            device: DeviceLike = None) -> dict:
    """Random float32 parameters drawn from ``gen`` on ``device``."""
    _check_dense(cfg)
    dev = resolve_device(device)
    p = {}
    if not cfg.embedding_inputs:
        p["embed"] = pm.embedding(gen, cfg.vocab, cfg.d_model, device=dev)
    p["layers"] = pm.stacked(lambda: _init_layer(gen, cfg, dev), cfg.n_layers)
    p["ln_f"] = pm.rmsnorm(cfg.d_model, device=dev)
    if not cfg.tie_embeddings:
        p["head"] = pm.linear(gen, cfg.d_model, cfg.vocab, device=dev)
    return p


# ---------------------------------------------------------------------------
# layer application
# ---------------------------------------------------------------------------


def _project_qkv(lp, x, cfg: ModelConfig, pos):
    b, s, _ = x.shape
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = pm.apply_linear(lp["wq"], x).reshape(b, s, hq, dh)
    k = pm.apply_linear(lp["wk"], x).reshape(b, s, hkv, dh)
    v = pm.apply_linear(lp["wv"], x).reshape(b, s, hkv, dh)
    rp = pos if pos.ndim == 3 else pos[None, None, :]   # (B,1,S) or (1,1,S)
    q = attn.rope(q.transpose(1, 2), rp, cfg.rope_theta)
    k = attn.rope(k.transpose(1, 2), rp, cfg.rope_theta)
    return q, k, v.transpose(1, 2)


def _attend(q, k, v, pos, cfg: ModelConfig, backend: str):
    if backend == "clusterkv" and cfg.clusterkv.enabled:
        return attn.clusterkv_attention(q, k, v, pos, pos, cfg.clusterkv,
                                        causal=True)
    if backend == "dense":
        return attn.dense_attention(q, k, v, pos, pos, causal=True,
                                    window=cfg.swa_window)
    return attn.flash_attention(q, k, v, pos, pos, causal=True,
                                window=cfg.swa_window)


def _apply_mlp(lp, x):
    h = (torch.nn.functional.silu(pm.apply_linear(lp["wg"], x))
         * pm.apply_linear(lp["wu"], x))
    return pm.apply_linear(lp["wd"], h)


def _attn_out(lp, o, b, s):
    return pm.apply_linear(lp["attn"]["wo"],
                           o.transpose(1, 2).reshape(b, s, -1))


def _layer(lp, x, pos, cfg: ModelConfig, backend: str):
    b, s, _ = x.shape
    h = pm.apply_rmsnorm(lp["ln1"], x, cfg.norm_eps)
    q, k, v = _project_qkv(lp["attn"], h, cfg, pos)
    x = x + _attn_out(lp, _attend(q, k, v, pos, cfg, backend), b, s)
    h = pm.apply_rmsnorm(lp["ln2"], x, cfg.norm_eps)
    return x + _apply_mlp(lp["ffn"], h), (k, v)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def embed_tokens(p, cfg: ModelConfig, batch: Dict[str, torch.Tensor]):
    dt = compute_dtype(cfg)
    if cfg.embedding_inputs:
        return batch["embeddings"].to(dt)
    return p["embed"]["table"][batch["tokens"].long()].to(dt)


def forward(p, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            backend: str = "flash") -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (final hidden states (B,S,d), aux loss)."""
    _check_dense(cfg)
    h = embed_tokens(p, cfg, batch)
    pos = torch.arange(h.shape[1], dtype=torch.int32, device=h.device)
    for i in range(cfg.n_layers):
        h, _ = _layer(pm.layer(p["layers"], i), h, pos, cfg, backend)
    aux = torch.zeros((), device=h.device)
    return pm.apply_rmsnorm(p["ln_f"], h, cfg.norm_eps), aux


def lm_head_weight(p, cfg: ModelConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        return p["embed"]["table"].T
    return p["head"]["w"]


def _logits(p, cfg: ModelConfig, h_last: torch.Tensor) -> torch.Tensor:
    h_last = pm.apply_rmsnorm(p["ln_f"], h_last, cfg.norm_eps)
    return (h_last @ lm_head_weight(p, cfg).to(h_last.dtype)).float()


# ---------------------------------------------------------------------------
# prefill / decode
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch_size: int, max_seq: int, dtype=None,
               device: DeviceLike = None) -> Dict[str, Any]:
    _check_dense(cfg)
    dev = resolve_device(device)
    dtype = dtype or compute_dtype(cfg)
    shape = (cfg.n_layers, batch_size, cfg.n_kv_heads, max_seq, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev),
            "pos": torch.zeros((), dtype=torch.int32, device=dev)}


def prefill(p, cfg: ModelConfig, batch, backend: str = "flash"
            ) -> Tuple[Dict, torch.Tensor]:
    """Forward over the prompt, returning a filled cache + last logits."""
    _check_dense(cfg)
    h = embed_tokens(p, cfg, batch)
    b, s, _ = h.shape
    pos = torch.arange(s, dtype=torch.int32, device=h.device)
    dt = compute_dtype(cfg)
    ks, vs = [], []
    for i in range(cfg.n_layers):
        h, (k, v) = _layer(pm.layer(p["layers"], i), h, pos, cfg, backend)
        ks.append(k.to(dt))
        vs.append(v.to(dt))
    cache = {"k": torch.stack(ks), "v": torch.stack(vs),
             "pos": torch.tensor(s, dtype=torch.int32, device=h.device)}
    return cache, _logits(p, cfg, h[:, -1])


def decode_step(p, cfg: ModelConfig, cache, tokens, backend: str = "flash",
                sharded_long: bool = False) -> Tuple[torch.Tensor, Dict]:
    """One decode step. tokens (B, 1); cache from init_cache/prefill.

    cache["pos"] may be a scalar (uniform decode) or a (B,) vector of
    per-sequence positions (continuous batching: every slot writes and
    masks at its own position). Where the reference returns new cache
    arrays, the port writes the new key/value rows into ``cache["k"]`` and
    ``cache["v"]`` in place (no copy of the cache per token); the returned
    cache shares them."""
    _check_dense(cfg)
    if sharded_long:
        raise _not_ported("decode_step(sharded_long=True)", "A11")
    dt = compute_dtype(cfg)
    h = p["embed"]["table"][tokens.long()].to(dt)
    b = h.shape[0]
    dev = h.device
    qpos = torch.as_tensor(cache["pos"], device=dev)
    per_slot = qpos.ndim == 1
    s_max = cache["k"].shape[3]
    kpos = torch.arange(s_max, dtype=torch.int32, device=dev)
    rope_pos = (qpos[:, None, None] if per_slot else qpos[None]
                ).to(torch.int32)
    mask_qpos = qpos[:, None, None, None] if per_slot else qpos
    bi = torch.arange(b, device=dev)
    qi = qpos.long()
    for i in range(cfg.n_layers):
        lp = pm.layer(p["layers"], i)
        kc, vc = cache["k"][i], cache["v"][i]          # (B,Hkv,S,dh) views
        hn = pm.apply_rmsnorm(lp["ln1"], h, cfg.norm_eps)
        q, k, v = _project_qkv(lp["attn"], hn, cfg, rope_pos)
        if per_slot:
            kc[bi, :, qi] = k[:, :, 0].to(kc.dtype)
            vc[bi, :, qi] = v[:, :, 0].to(vc.dtype)
        else:
            kc[:, :, qi] = k[:, :, 0].to(kc.dtype)
            vc[:, :, qi] = v[:, :, 0].to(vc.dtype)
        q1 = q[:, :, 0]                                 # (B,Hq,dh)
        if backend == "clusterkv" and cfg.clusterkv.enabled:
            if per_slot:
                # continuous batching: per-call ordering over every slot's
                # cache region (the baseline the plan service amortizes)
                o = attn.clusterkv_percall_decode(q1, kc, vc, kpos, qpos,
                                                  cfg.clusterkv)
            else:
                o = attn.clusterkv_decode(q1, kc, vc, kpos, qpos,
                                          cfg.clusterkv)
        else:
            o = attn.decode_attention(q1, kc, vc, kpos, mask_qpos,
                                      window=cfg.swa_window)
        h = h + pm.apply_linear(lp["attn"]["wo"], o.reshape(b, 1, -1))
        hn = pm.apply_rmsnorm(lp["ln2"], h, cfg.norm_eps)
        h = h + _apply_mlp(lp["ffn"], hn)
    logits = _logits(p, cfg, h[:, 0])
    new_cache = {"k": cache["k"], "v": cache["v"], "pos": cache["pos"] + 1}
    return logits, new_cache


def plan_prefill(p, cfg: ModelConfig, batch, perms) -> torch.Tensor:
    """Prefill THROUGH per-layer key plans: ``perms`` (L, B, Hkv, S) are
    cluster orderings (e.g. ``plan_batch_perm`` of one ``kv_plan_batch``
    per layer), driving the ``plan_batch`` path of
    :func:`~repro_torch.models.attention.clusterkv_attention`. Returns
    last-position logits only."""
    _check_dense(cfg)
    if cfg.embedding_inputs:
        raise NotImplementedError(
            "plan prefill serves token decoder-only models")
    h = embed_tokens(p, cfg, batch)
    b, s, _ = h.shape
    pos = torch.arange(s, dtype=torch.int32, device=h.device)
    for i in range(cfg.n_layers):
        lp = pm.layer(p["layers"], i)
        hn = pm.apply_rmsnorm(lp["ln1"], h, cfg.norm_eps)
        q, k, v = _project_qkv(lp["attn"], hn, cfg, pos)
        o = attn.clusterkv_attention(q, k, v, pos, pos, cfg.clusterkv,
                                     causal=True, plan_batch=perms[i])
        h = h + _attn_out(lp, o, b, s)
        hn = pm.apply_rmsnorm(lp["ln2"], h, cfg.norm_eps)
        h = h + _apply_mlp(lp["ffn"], hn)
    return _logits(p, cfg, h[:, -1])
