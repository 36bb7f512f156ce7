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
reference's. ``param_specs`` and ``cache_specs`` give the parameters'
and the cache's logical PartitionSpecs (the nested ``"ssm"`` state
included). Under a process mesh with a tensor axis the shared block's
heads split head-aligned and its MLP and ``out`` columns over ``tp``, the
mamba2 layers their heads (``mamba.inner_split``), and the vocab
(``sharding.VocabSplit``), as the reference's specs say.
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
from repro_torch.models import sharding
from repro_torch.models.sharding import NO_SHARD, P, ShardCtx
from repro_torch.models.transformer import ce_loss, vocab_specs


def _n_groups(cfg: ModelConfig) -> int:
    return -(-cfg.n_layers // cfg.shared_attn_every)


def _heads(cfg: ModelConfig) -> Tuple[int, int, int]:
    """(2 d, heads, head dim) of the shared block over the concat stream."""
    d2 = 2 * cfg.d_model
    return d2, cfg.n_heads, d2 // cfg.n_heads


def _init_shared(cfg: ModelConfig) -> dict:
    """Shared transformer block over the 2*d concat stream."""
    d2, hq, dh = _heads(cfg)
    col, row = ("fsdp", "tp"), ("tp", "fsdp")
    return {"ln1": pm.rmsnorm(d2),
            "wq": pm.linear(d2, hq * dh, spec=col),
            "wk": pm.linear(d2, hq * dh, spec=col),
            "wv": pm.linear(d2, hq * dh, spec=col),
            "wo": pm.linear(hq * dh, d2, spec=row),
            "ln2": pm.rmsnorm(d2),
            "wg": pm.linear(d2, cfg.d_ff, spec=col),
            "wu": pm.linear(d2, cfg.d_ff, spec=col),
            "wd": pm.linear(cfg.d_ff, d2, spec=row),
            "out": pm.linear(d2, cfg.d_model, spec=col)}


def declare(cfg: ModelConfig) -> dict:
    """The parameter tree as ``param.Init`` leaves (shapes, draws, specs)."""
    layer = {"ln": pm.rmsnorm(cfg.d_model), "mixer": mamba.init_mamba2(cfg)}
    return {"embed": pm.embedding(cfg.vocab, cfg.d_model),
            "shared": _init_shared(cfg),
            "layers": pm.stacked(layer,
                                 _n_groups(cfg) * cfg.shared_attn_every),
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


def _split_heads(t: torch.Tensor, hq: int, dh: int) -> torch.Tensor:
    b, s, _ = t.shape
    return t.reshape(b, s, hq, dh).transpose(1, 2)


def _splits(cfg: ModelConfig, mesh):
    """``(heads, MLP, mamba2, vocab)``: the tensor splits under a process
    ``mesh`` (all None without a tensor axis): the shared block's heads
    head-aligned (``sharding.head_split``, its own kv groups), its MLP's
    and ``out``'s columns, the mamba2 layers' heads
    (``mamba.inner_split``) and the vocab."""
    split = sharding.tensor_split(mesh)
    if split is None:
        return None, None, None, None
    return (sharding.head_split(split, cfg.n_heads, cfg.n_heads,
                                "the shared block"), split,
            mamba.inner_split(cfg, split),
            sharding.vocab_split(mesh, cfg.vocab))


def compute_specs(cfg: ModelConfig, mesh, seq: int) -> dict:
    """Physical PartitionSpecs of the parameters in the mesh train step:
    the shared block's q/k/v columns and ``wo`` rows by head, its gate/up
    and ``out`` columns and down rows over ``tp``, the mamba2 layers'
    heads (``mamba.compute_specs``), the embedding's and head's vocab; the
    norms whole."""
    specs = sharding.whole(param_specs(cfg))
    heads, mlp, inner, vocab = _splits(cfg, mesh)
    if heads is None:
        return specs
    sh = specs["shared"]
    dh = _heads(cfg)[2]
    sh["wq"]["w"] = heads.q_spec(2, 1, dh)
    sh["wk"]["w"] = sh["wv"]["w"] = heads.kv_spec(2, 1, dh)
    sh["wo"]["w"] = heads.q_spec(2, 0, dh)
    sh["wg"]["w"] = sh["wu"]["w"] = mlp.spec(2, 1, cfg.d_ff)
    sh["wd"]["w"] = mlp.spec(2, 0, cfg.d_ff)
    sh["out"]["w"] = mlp.spec(2, 1, cfg.d_model)
    specs["layers"]["mixer"].update(mamba.compute_specs(cfg, inner))
    vocab_specs(specs, vocab)
    return specs


def _shared_qkv(sp, h2, cfg: ModelConfig, pos, split=None):
    """q, k, v (B, H, S, dh) of the shared block, RoPE at ``pos`` (S,);
    under a ``sharding.HeadSplit`` this rank's heads."""
    _, hq, dh = _heads(cfg)
    hkv = hq
    hn = pm.apply_rmsnorm(sp["ln1"], h2, cfg.norm_eps)
    if split is not None:
        hn, hq, hkv = split.enter(hn), split.n_q_local, split.n_kv_local
    q = _split_heads(pm.apply_linear(sp["wq"], hn), hq, dh)
    k = _split_heads(pm.apply_linear(sp["wk"], hn), hkv, dh)
    v = _split_heads(pm.apply_linear(sp["wv"], hn), hkv, dh)
    q = attn.rope(q, pos[None, None, :], cfg.rope_theta)
    k = attn.rope(k, pos[None, None, :], cfg.rope_theta)
    return q, k, v


def _shared_tail(sp, h2, o, cfg: ModelConfig,
                 splits=(None, None)) -> torch.Tensor:
    """The block after attention: output projection and residual, the
    SwiGLU MLP and residual, and the projection back to d; under tensor
    ``splits`` (the first two of ``_splits``) the heads' and columns'
    partial sums are summed over ``tp``, and each rank projects its
    columns of ``out``, concatenated over ``tp``."""
    b, s, _ = h2.shape
    split_attn, split_mlp = splits[:2]
    a = pm.apply_linear(sp["wo"], o.transpose(1, 2).reshape(
        b, s, o.shape[1] * o.shape[3]))
    h2 = h2 + (a if split_attn is None else split_attn.sum(a))
    hn = pm.apply_rmsnorm(sp["ln2"], h2, cfg.norm_eps)
    if split_mlp is not None:
        hn = split_mlp.enter(hn)
    f = F.silu(pm.apply_linear(sp["wg"], hn)) * pm.apply_linear(sp["wu"], hn)
    m = pm.apply_linear(sp["wd"], f)
    if split_mlp is None:
        return pm.apply_linear(sp["out"], h2 + m)
    h2 = split_mlp.enter(h2 + split_mlp.sum(m))
    return split_mlp.cat(pm.apply_linear(sp["out"], h2), 2, cfg.d_model)


def _shared_block_kv(sp, h, x0, pos, cfg: ModelConfig, backend: str,
                     splits=(None, None)):
    """The shared block's d-dim residual contribution, and its k and v."""
    h2 = torch.cat([h, x0], dim=-1)
    q, k, v = _shared_qkv(sp, h2, cfg, pos, splits[0])
    if q.shape[1] == 0:
        o = attn.no_query_heads(q, k, v)
    elif backend == "clusterkv" and cfg.clusterkv.enabled:
        o = attn.clusterkv_attention(q, k, v, pos, pos, cfg.clusterkv)
    elif backend == "dense":
        o = attn.dense_attention(q, k, v, pos, pos)
    else:
        o = attn.flash_attention(q, k, v, pos, pos)
    return _shared_tail(sp, h2, o, cfg, splits), k, v


def _shared_block(sp, h, x0, pos, cfg: ModelConfig, backend: str,
                  shd: ShardCtx = NO_SHARD) -> torch.Tensor:
    """Returns the d-dim residual contribution of the shared block."""
    return _shared_block_kv(sp, h, x0, pos, cfg, backend,
                            _splits(cfg, shd.mesh))[0]


def _group_params(p, g: int, per: int) -> dict:
    """Group ``g``'s ``per`` stacked layers (views, no copy)."""
    return pm.tree_map(lambda a: a[g * per:(g + 1) * per], p["layers"])


def forward(p, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            backend: str = "flash", shd: ShardCtx = NO_SHARD
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (final hidden states (B,S,d), a zero aux loss)."""
    _, _, inner, vocab = _splits(cfg, shd.mesh)
    x0 = pm.apply_embedding(p, cfg, batch["tokens"], vocab)
    h = x0
    pos = torch.arange(h.shape[1], dtype=torch.int32, device=h.device)
    per = cfg.shared_attn_every

    def mamba_body(lp, x):
        lp = shd.layer(lp, "layers")
        y, _, _, _ = mamba.mamba2_forward(
            lp["mixer"], pm.apply_rmsnorm(lp["ln"], x, cfg.norm_eps), cfg,
            shd, inner)
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
                   batch["labels"], cfg.loss_chunk,
                   _splits(cfg, shd.mesh)[3])


def cache_specs(cfg: ModelConfig, long_context: bool = False) -> dict:
    """Logical PartitionSpecs of ``init_cache``'s entries, the nested
    ``"ssm"`` state included."""
    kv = (P(None, "dp", None, "seq", None) if long_context
          else P(None, "dp", "tp", None, None))
    return {"ssm": {"h": P(None, "dp", "tp", None, None),
                    "conv_x": P(None, "dp", None, "tp"),
                    "conv_bc": P(None, "dp", None, None)},
            "k": kv, "v": kv, "pos": P()}


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
    (float32), and the last position's logits. Under a process mesh the
    shared block computes this rank's heads (``_splits``; its k/v are
    theirs where the heads split evenly, else every head, gathered over
    ``tp``), the mamba2 layers, gathered one at a time, this rank's heads
    (their states and conv_x buffers too), and the logits its vocab
    columns."""
    splits = _splits(cfg, shd.mesh)
    heads, _, inner, vocab = splits
    x0 = pm.apply_embedding(p, cfg, batch["tokens"], vocab)
    h = x0
    s = h.shape[1]
    pos = torch.arange(s, dtype=torch.int32, device=h.device)
    per = cfg.shared_attn_every
    dt = pm.DTYPES[cfg.dtype]
    ks, vs, hs, cxs, cbcs = [], [], [], [], []
    for g in range(_n_groups(cfg)):
        out, k, v = _shared_block_kv(p["shared"], h, x0, pos, cfg, backend,
                                     splits)
        if heads is not None and not heads.even:
            k, v = heads.gather_kv(k, 1), heads.gather_kv(v, 1)
        ks.append(k.to(dt))
        vs.append(v.to(dt))
        h = h + out
        gp = _group_params(p, g, per)
        for j in range(per):
            lp = shd.layer(pm.layer(gp, j), "layers")
            y, h_fin, cx, cbc = mamba.mamba2_forward(
                lp["mixer"], pm.apply_rmsnorm(lp["ln"], h, cfg.norm_eps),
                cfg, shd, inner)
            h = h + y
            hs.append(h_fin)
            cxs.append(cx.float())
            cbcs.append(cbc.float())
    cache = {"ssm": {"h": torch.stack(hs), "conv_x": torch.stack(cxs),
                     "conv_bc": torch.stack(cbcs)},
             "k": torch.stack(ks), "v": torch.stack(vs),
             "pos": torch.tensor(s, dtype=torch.int32, device=h.device)}
    return cache, pm.apply_lm_head(p, cfg, h[:, -1], vocab)


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
    and a single-controller mesh in ``shd``, through
    ``clusterkv_decode_sharded``. Under a process mesh the shared block
    computes this rank's heads; with ``shd.seq`` the k/v cache is this
    rank's slice of the sequence (every head, the new row gathered over
    ``tp``), attended through ``attention.decode_seq_split``; where the
    heads do not split evenly the cache holds every head, its new row
    gathered over ``tp`` likewise. The mamba2 layers step their heads'
    states, and the logits are this rank's vocab columns."""
    splits = _splits(cfg, shd.mesh)
    split, _, inner, vocab = splits
    x0 = pm.apply_embedding(p, cfg, tokens, vocab)
    h = x0
    dev = h.device
    qpos = torch.as_tensor(cache["pos"], device=dev)
    qi = qpos.long()
    s_max = cache["k"].shape[3]
    kpos = torch.arange(s_max, dtype=torch.int32, device=dev)
    rope_pos = qpos.reshape(1).to(torch.int32)
    per = cfg.shared_attn_every
    sp = p["shared"]
    ssm = cache["ssm"]
    seq = shd.seq
    # the cache holds every head: a long context's (this rank's slice of
    # the sequence), or one whose heads do not split evenly
    every_head = split is not None and (seq is not None or not split.even)
    heads = slice(*split.kv) if every_head else slice(None)
    if seq is not None:
        kpos = torch.arange(seq.start, seq.start + seq.size,
                            dtype=torch.int32, device=dev)
    for g in range(_n_groups(cfg)):
        h2 = torch.cat([h, x0], dim=-1)
        q, k1, v1 = _shared_qkv(sp, h2, cfg, rope_pos, split)
        kc, vc = cache["k"][g], cache["v"][g]            # (B,H,S,dh) views
        q1 = q[:, :, 0]
        k1, v1 = k1[:, :, 0], v1[:, :, 0]
        if every_head:
            k1, v1 = split.gather_kv(k1, 1), split.gather_kv(v1, 1)
        ckv_on = backend == "clusterkv" and cfg.clusterkv.enabled
        if q1.shape[1] == 0:
            attn.write_position(kc, k1, qi, seq)
            attn.write_position(vc, v1, qi, seq)
            o = q1.new_zeros(q1.shape[:2] + vc.shape[3:])
        elif seq is not None:
            attn.write_position(kc, k1, qi, seq)
            attn.write_position(vc, v1, qi, seq)
            if ckv_on and not sharded_long:
                raise ValueError("a cache whose sequence is split over a "
                                 "process mesh decodes ClusterKV with "
                                 "sharded_long=True")
            o = attn.decode_seq_split(q1, kc[:, heads], vc[:, heads], kpos,
                                      qpos, seq,
                                      cfg=cfg.clusterkv if ckv_on else None)
        else:
            attn.write_position(kc, k1, qi)
            attn.write_position(vc, v1, qi)
            kc, vc = kc[:, heads], vc[:, heads]
            if ckv_on and sharded_long and shd.mesh is not None:
                o = attn.clusterkv_decode_sharded(q1, kc, vc, kpos, qpos,
                                                  cfg.clusterkv, shd.mesh)
            elif ckv_on:
                o = attn.clusterkv_decode(q1, kc, vc, kpos, qpos,
                                          cfg.clusterkv)
            else:
                o = attn.decode_attention(q1, kc, vc, kpos, qpos)
        h = h + _shared_tail(sp, h2, o[:, :, None], cfg, splits)
        gp = _group_params(p, g, per)
        for j in range(per):
            i = g * per + j
            lp = shd.layer(pm.layer(gp, j), "layers")
            y, hst, cx, cbc = mamba.mamba2_step(
                lp["mixer"], pm.apply_rmsnorm(lp["ln"], h, cfg.norm_eps),
                ssm["h"][i], ssm["conv_x"][i], ssm["conv_bc"][i], cfg, inner)
            ssm["h"][i].copy_(hst)
            ssm["conv_x"][i].copy_(cx)
            ssm["conv_bc"][i].copy_(cbc)
            h = h + y
    logits = pm.apply_lm_head(p, cfg, h[:, 0], vocab)
    return logits, {"ssm": ssm, "k": cache["k"], "v": cache["v"],
                    "pos": cache["pos"] + 1}
