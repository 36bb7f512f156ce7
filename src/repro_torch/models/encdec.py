"""Whisper-style encoder-decoder, as the reference's ``models/encdec.py``.
The conv/mel frontend is a stub: the encoder consumes precomputed frame
embeddings (``batch["frames"]``). Positional encoding is RoPE in both
stacks, as in the reference. The MLP's GELU is the tanh approximation
(``jax.nn.gelu``'s default, not PyTorch's).

Cross attention in ``decode_step`` attends every position of the cached
encoder keys, ``xk``/``xv``, as the reference's does: after
``model_api.grow_cache`` has zero-padded them to the cache length, the
padded positions take part (ROADMAP C38). ``loss_fn`` is the training
loss; each layer of ``encode`` and ``forward`` runs under remat. Under a
process mesh with a tensor axis every attention splits its heads
head-aligned, every MLP its hidden columns, and the vocab is split
(``sharding.VocabSplit``), as the reference's specs say.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import param as pm
from repro_torch.models import sharding
from repro_torch.models.sharding import NO_SHARD, P, ShardCtx
from repro_torch.models.transformer import ce_loss, vocab_specs


def _init_attn(cfg: ModelConfig, d_kv_src: int = 0) -> dict:
    d = cfg.d_model
    hq, dh = cfg.n_heads, cfg.head_dim
    dkv = d_kv_src or d
    col = ("fsdp", "tp")
    return {"wq": pm.linear(d, hq * dh, spec=col),
            "wk": pm.linear(dkv, hq * dh, spec=col),
            "wv": pm.linear(dkv, hq * dh, spec=col),
            "wo": pm.linear(hq * dh, d, spec=("tp", "fsdp"))}


def _init_mlp(cfg: ModelConfig) -> dict:
    return {"w1": pm.linear(cfg.d_model, cfg.d_ff, spec=("fsdp", "tp")),
            "w2": pm.linear(cfg.d_ff, cfg.d_model, spec=("tp", "fsdp"))}


def _init_enc_layer(cfg: ModelConfig) -> dict:
    return {"ln1": pm.rmsnorm(cfg.d_model), "attn": _init_attn(cfg),
            "ln2": pm.rmsnorm(cfg.d_model), "mlp": _init_mlp(cfg)}


def _init_dec_layer(cfg: ModelConfig) -> dict:
    return {"ln1": pm.rmsnorm(cfg.d_model), "self": _init_attn(cfg),
            "ln_x": pm.rmsnorm(cfg.d_model), "cross": _init_attn(cfg),
            "ln2": pm.rmsnorm(cfg.d_model), "mlp": _init_mlp(cfg)}


def declare(cfg: ModelConfig) -> dict:
    """The parameter tree as ``param.Init`` leaves (shapes, draws, specs)."""
    return {"embed": pm.embedding(cfg.vocab, cfg.d_model),
            "enc": pm.stacked(_init_enc_layer(cfg), cfg.n_enc_layers),
            "dec": pm.stacked(_init_dec_layer(cfg), cfg.n_layers),
            "ln_enc": pm.rmsnorm(cfg.d_model),
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


def _heads(x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """(B, S, H*dh) -> (B, H, S, dh) (H: the heads ``x`` holds)."""
    b, s, w = x.shape
    return x.reshape(b, s, w // cfg.head_dim, cfg.head_dim).transpose(1, 2)


def _splits(cfg: ModelConfig, mesh):
    """``(heads, MLP, vocab)``: the tensor splits under a process
    ``mesh`` (all None without a tensor axis): every attention's heads
    head-aligned (``sharding.head_split``, its own kv groups), the MLP's
    hidden columns, and the vocab."""
    split = sharding.tensor_split(mesh)
    if split is None:
        return None, None, None
    return (sharding.head_split(split, cfg.n_heads, cfg.n_heads), split,
            sharding.vocab_split(mesh, cfg.vocab))


def compute_specs(cfg: ModelConfig, mesh, seq: int) -> dict:
    """Physical PartitionSpecs of the parameters in the mesh train step:
    every attention's q/k/v columns and output rows by head, the MLP's
    columns and rows over ``tp``, the embedding's and head's vocab; the
    norms whole."""
    specs = sharding.whole(param_specs(cfg))
    heads, mlp, vocab = _splits(cfg, mesh)
    if heads is None:
        return specs
    for stack, blocks in (("enc", ("attn",)), ("dec", ("self", "cross"))):
        layer = specs[stack]
        for blk in blocks:
            layer[blk]["wq"]["w"] = heads.q_spec(3, 2, cfg.head_dim)
            for k in ("wk", "wv"):
                layer[blk][k]["w"] = heads.kv_spec(3, 2, cfg.head_dim)
            layer[blk]["wo"]["w"] = heads.q_spec(3, 1, cfg.head_dim)
        layer["mlp"]["w1"]["w"] = mlp.spec(3, 2, cfg.d_ff)
        layer["mlp"]["w2"]["w"] = mlp.spec(3, 1, cfg.d_ff)
    vocab_specs(specs, vocab)
    return specs


def _mha(lp, xq, xkv, cfg: ModelConfig, qpos, kpos, shd: ShardCtx = NO_SHARD,
         *, causal: bool, backend: str = "flash") -> torch.Tensor:
    b, sq, _ = xq.shape
    split = _splits(cfg, shd.mesh)[0]
    if split is not None:               # this rank's heads
        xq = split.enter(xq)
        xkv = xq if xkv is None else split.enter(xkv)
    elif xkv is None:
        xkv = xq
    q = attn.rope(_heads(pm.apply_linear(lp["wq"], xq), cfg),
                  qpos[None, None, :], cfg.rope_theta)
    k = attn.rope(_heads(pm.apply_linear(lp["wk"], xkv), cfg),
                  kpos[None, None, :], cfg.rope_theta)
    v = _heads(pm.apply_linear(lp["wv"], xkv), cfg)
    if q.shape[1] == 0:
        o = attn.no_query_heads(q, k, v)
    elif backend == "dense":
        o = attn.dense_attention(q, k, v, qpos, kpos, causal=causal)
    else:
        o = attn.flash_attention(q, k, v, qpos, kpos, causal=causal)
    o = pm.apply_linear(lp["wo"], o.transpose(1, 2).reshape(
        b, sq, o.shape[1] * o.shape[3]))
    return o if split is None else split.sum(o)


def _mlp_apply(lp, x: torch.Tensor, cfg: ModelConfig = None,
               shd: ShardCtx = NO_SHARD) -> torch.Tensor:
    """The GELU MLP; ``cfg`` is read only under a process mesh."""
    split = _splits(cfg, shd.mesh)[1]
    if split is not None:
        x = split.enter(x)
    y = pm.apply_linear(lp["w2"], F.gelu(pm.apply_linear(lp["w1"], x),
                                         approximate="tanh"))
    return y if split is None else split.sum(y)


def encode(p, cfg: ModelConfig, frames: torch.Tensor,
           backend: str = "flash", shd: ShardCtx = NO_SHARD) -> torch.Tensor:
    """The encoder over frame embeddings (B, S, d) -> (B, S, d)."""
    h = frames.to(pm.DTYPES[cfg.dtype])
    pos = torch.arange(h.shape[1], dtype=torch.int32, device=h.device)

    def body(lp, x):
        lp = shd.layer(lp, "enc")
        hn = pm.apply_rmsnorm(lp["ln1"], x, cfg.norm_eps)
        x = x + _mha(lp["attn"], hn, None, cfg, pos, pos, shd, causal=False,
                     backend=backend)
        return x + _mlp_apply(lp["mlp"],
                              pm.apply_rmsnorm(lp["ln2"], x, cfg.norm_eps),
                              cfg, shd)

    body = pm.maybe_remat(body, cfg)
    for lp in pm.unstack(p["enc"], cfg.n_enc_layers):
        h = body(lp, h)
    return pm.apply_rmsnorm(p["ln_enc"], h, cfg.norm_eps)


def _dec_layer(lp, x, enc_out, pos, epos, cfg: ModelConfig, shd: ShardCtx,
               backend: str) -> torch.Tensor:
    hn = pm.apply_rmsnorm(lp["ln1"], x, cfg.norm_eps)
    x = x + _mha(lp["self"], hn, None, cfg, pos, pos, shd, causal=True,
                 backend=backend)
    x = x + _mha(lp["cross"], pm.apply_rmsnorm(lp["ln_x"], x, cfg.norm_eps),
                 enc_out, cfg, pos, epos, shd, causal=False, backend=backend)
    return x + _mlp_apply(lp["mlp"],
                          pm.apply_rmsnorm(lp["ln2"], x, cfg.norm_eps),
                          cfg, shd)


def forward(p, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            backend: str = "flash", shd: ShardCtx = NO_SHARD
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (final decoder hidden states (B,S,d), a zero aux loss)."""
    enc_out = encode(p, cfg, batch["frames"], backend, shd)
    h = pm.apply_embedding(p, cfg, batch["tokens"],
                           _splits(cfg, shd.mesh)[2])
    pos = torch.arange(h.shape[1], dtype=torch.int32, device=h.device)
    epos = torch.arange(enc_out.shape[1], dtype=torch.int32, device=h.device)

    def body(lp, x, enc):
        return _dec_layer(shd.layer(lp, "dec"), x, enc, pos, epos, cfg, shd,
                          backend)

    body = pm.maybe_remat(body, cfg)
    for lp in pm.unstack(p["dec"], cfg.n_layers):
        h = body(lp, h, enc_out)
    return (pm.apply_rmsnorm(p["ln_f"], h, cfg.norm_eps),
            torch.zeros((), device=h.device))


def loss_fn(p, cfg: ModelConfig, batch, backend: str = "flash",
            shd: ShardCtx = NO_SHARD) -> torch.Tensor:
    """Chunked cross-entropy of ``batch["labels"]`` through the head."""
    h, _ = forward(p, cfg, batch, backend, shd)
    return ce_loss(h, p["head"]["w"].to(pm.DTYPES[cfg.dtype]),
                   batch["labels"], cfg.loss_chunk,
                   _splits(cfg, shd.mesh)[2])


def cache_specs(cfg: ModelConfig, long_context: bool = False) -> dict:
    """Logical PartitionSpecs of the self and cross caches (heads over
    the tensor axis, whatever the context length, as the reference's)."""
    kv = P(None, "dp", "tp", None, None)
    return {"k": kv, "v": kv, "xk": kv, "xv": kv, "pos": P()}


def init_cache(cfg: ModelConfig, batch_size: int, max_seq: int, dtype=None,
               device: DeviceLike = None) -> Dict[str, Any]:
    dtype = dtype or pm.DTYPES[cfg.dtype]
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch_size, cfg.n_heads, max_seq, cfg.head_dim)
    cache = {key: torch.zeros(shape, dtype=dtype, device=dev)
             for key in ("k", "v", "xk", "xv")}
    cache["pos"] = torch.zeros((), dtype=torch.int32, device=dev)
    return cache


def prefill(p, cfg: ModelConfig, batch, backend: str = "flash",
            shd: ShardCtx = NO_SHARD) -> Tuple[Dict, torch.Tensor]:
    """Encoder pass + decoder prompt pass; caches the self k/v and the
    cross k/v of the encoder output (in ``cfg.dtype``), and returns the
    last position's logits. Under a process mesh each rank caches its
    heads (every head, gathered over ``tp``, where they do not split
    evenly) and returns its vocab columns."""
    heads, _, vocab = _splits(cfg, shd.mesh)
    enc_out = encode(p, cfg, batch["frames"], backend, shd)
    h = pm.apply_embedding(p, cfg, batch["tokens"], vocab)
    s = h.shape[1]
    dt = pm.DTYPES[cfg.dtype]
    pos = torch.arange(s, dtype=torch.int32, device=h.device)
    epos = torch.arange(enc_out.shape[1], dtype=torch.int32, device=h.device)
    ks, vs, xks, xvs = [], [], [], []
    for i in range(cfg.n_layers):
        lp = shd.layer(pm.layer(p["dec"], i), "dec")
        hn = pm.apply_rmsnorm(lp["ln1"], h, cfg.norm_eps)
        ks.append(attn.rope(_heads(pm.apply_linear(lp["self"]["wk"], hn),
                                   cfg), pos[None, None, :],
                            cfg.rope_theta).to(dt))
        vs.append(_heads(pm.apply_linear(lp["self"]["wv"], hn), cfg).to(dt))
        xks.append(attn.rope(_heads(pm.apply_linear(lp["cross"]["wk"],
                                                    enc_out), cfg),
                             epos[None, None, :], cfg.rope_theta).to(dt))
        xvs.append(_heads(pm.apply_linear(lp["cross"]["wv"], enc_out),
                          cfg).to(dt))
        h = _dec_layer(lp, h, enc_out, pos, epos, cfg, shd, backend)
    cache = {"k": torch.stack(ks), "v": torch.stack(vs),
             "xk": torch.stack(xks), "xv": torch.stack(xvs)}
    if heads is not None and not heads.even:
        cache = {k: heads.gather_kv(c, 2) for k, c in cache.items()}
    cache["pos"] = torch.tensor(s, dtype=torch.int32, device=h.device)
    return cache, pm.apply_lm_head(p, cfg, h[:, -1], vocab)


def decode_step(p, cfg: ModelConfig, cache, tokens, backend: str = "flash",
                sharded_long: bool = False, shd: ShardCtx = NO_SHARD
                ) -> Tuple[torch.Tensor, Dict]:
    """One decode step at the scalar position ``cache["pos"]``. tokens
    (B, 1). Where the reference returns new cache arrays, the port writes
    the new self key/value rows into ``cache["k"]``/``cache["v"]`` in
    place; the returned cache shares them. Cross attention attends every
    position of ``xk``/``xv`` (C38). Under a process mesh each rank
    decodes with its heads and MLP columns (``_splits``), its caches its
    heads' (every head where they do not split evenly: it attends its own
    and writes every head's new row, gathered over ``tp``), and returns
    its vocab columns of the logits."""
    split, _, vocab = _splits(cfg, shd.mesh)
    h = pm.apply_embedding(p, cfg, tokens, vocab)
    b = h.shape[0]
    dev = h.device
    qpos = torch.as_tensor(cache["pos"], device=dev)
    qi = qpos.long()
    rope_pos = qpos.reshape(1, 1, 1).to(torch.int32)
    kpos = torch.arange(cache["k"].shape[3], dtype=torch.int32, device=dev)
    xpos = torch.arange(cache["xk"].shape[3], dtype=torch.int32, device=dev)
    every_head = split is not None and not split.even
    heads = slice(*split.kv) if every_head else slice(None)

    def tp_sum(a):
        return a if split is None else split.sum(a)

    def attend(q1, kc, vc, kp, qp):
        if q1.shape[1] == 0:
            return q1.new_zeros(q1.shape[:2] + vc.shape[3:])
        return attn.decode_attention(q1, kc[:, heads], vc[:, heads], kp, qp)

    for i in range(cfg.n_layers):
        lp = shd.layer(pm.layer(p["dec"], i), "dec")
        hn = pm.apply_rmsnorm(lp["ln1"], h, cfg.norm_eps)
        q = attn.rope(_heads(pm.apply_linear(lp["self"]["wq"], hn), cfg),
                      rope_pos, cfg.rope_theta)
        k1 = attn.rope(_heads(pm.apply_linear(lp["self"]["wk"], hn), cfg),
                       rope_pos, cfg.rope_theta)
        v1 = _heads(pm.apply_linear(lp["self"]["wv"], hn), cfg)
        k1, v1 = k1[:, :, 0], v1[:, :, 0]
        if every_head:
            k1, v1 = split.gather_kv(k1, 1), split.gather_kv(v1, 1)
        kc, vc = cache["k"][i], cache["v"][i]            # (B,H,S,dh) views
        attn.write_position(kc, k1, qi)
        attn.write_position(vc, v1, qi)
        o = attend(q[:, :, 0], kc, vc, kpos, qpos)
        h = h + tp_sum(pm.apply_linear(lp["self"]["wo"], o.reshape(
            b, 1, o.shape[1] * o.shape[2])))
        # cross attention over the cached encoder k/v, every position
        hn = pm.apply_rmsnorm(lp["ln_x"], h, cfg.norm_eps)
        qx = attn.rope(_heads(pm.apply_linear(lp["cross"]["wq"], hn), cfg),
                       rope_pos, cfg.rope_theta)
        ox = attend(qx[:, :, 0], cache["xk"][i], cache["xv"][i], xpos,
                    attn.INT32_MAX - 1)
        h = h + tp_sum(pm.apply_linear(lp["cross"]["wo"], ox.reshape(
            b, 1, ox.shape[1] * ox.shape[2])))
        h = h + _mlp_apply(lp["mlp"],
                           pm.apply_rmsnorm(lp["ln2"], h, cfg.norm_eps),
                           cfg, shd)
    logits = pm.apply_lm_head(p, cfg, h[:, 0], vocab)
    return logits, dict(cache, pos=cache["pos"] + 1)
