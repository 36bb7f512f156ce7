"""Decoder-only transformer LM covering the dense / vlm / moe families
(GQA, optional QKV bias, optional SWA, optional MLA via ``models.mla``,
optional MoE FFN via ``models.moe``, optional cluster-sparse attention).

Parameters are plain nested dicts of tensors in the reference's layout
(``models/param.py``); layers are stacked ``(L, ...)`` and applied by a
Python loop (the reference's ``lax.scan``), each under remat in
``forward``. Everything runs eagerly.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import mla as mla_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import param as pm
from repro_torch.models import sharding
from repro_torch.models.sharding import NO_SHARD, P, ShardCtx

AUX_COEF = 0.01
DTYPES = pm.DTYPES


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return DTYPES[cfg.dtype]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _init_attn(cfg: ModelConfig) -> dict:
    d, hq, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    col, row = ("fsdp", "tp"), ("tp", "fsdp")
    return {"wq": pm.linear(d, hq * dh, spec=col, bias=cfg.qkv_bias),
            "wk": pm.linear(d, hkv * dh, spec=col, bias=cfg.qkv_bias),
            "wv": pm.linear(d, hkv * dh, spec=col, bias=cfg.qkv_bias),
            "wo": pm.linear(hq * dh, d, spec=row)}


def _init_mlp(cfg: ModelConfig) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    return {"wg": pm.linear(d, f, spec=("fsdp", "tp")),
            "wu": pm.linear(d, f, spec=("fsdp", "tp")),
            "wd": pm.linear(f, d, spec=("tp", "fsdp"))}


def _init_layer(cfg: ModelConfig) -> dict:
    return {"ln1": pm.rmsnorm(cfg.d_model),
            "ln2": pm.rmsnorm(cfg.d_model),
            "attn": (mla_mod.init_mla(cfg) if cfg.mla is not None
                     else _init_attn(cfg)),
            "ffn": (moe_mod.init_moe(cfg) if cfg.moe is not None
                    else _init_mlp(cfg))}


def declare(cfg: ModelConfig) -> dict:
    """The parameter tree as ``param.Init`` leaves (shapes, draws, specs)."""
    p = {}
    if not cfg.embedding_inputs:
        p["embed"] = pm.embedding(cfg.vocab, cfg.d_model)
    p["layers"] = pm.stacked(_init_layer(cfg), cfg.n_layers)
    p["ln_f"] = pm.rmsnorm(cfg.d_model)
    if not cfg.tie_embeddings:
        p["head"] = pm.linear(cfg.d_model, cfg.vocab, spec=("fsdp", "tp"))
    return p


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
    if q.shape[1] == 0:
        return attn.no_query_heads(q, k, v)
    if backend == "clusterkv" and cfg.clusterkv.enabled:
        return attn.clusterkv_attention(q, k, v, pos, pos, cfg.clusterkv,
                                        causal=True)
    if backend == "dense":
        return attn.dense_attention(q, k, v, pos, pos, causal=True,
                                    window=cfg.swa_window)
    return attn.flash_attention(q, k, v, pos, pos, causal=True,
                                window=cfg.swa_window)


def _ffn(lp, x, cfg: ModelConfig, shd: ShardCtx):
    """The layer's FFN: (output, aux loss) — the MoE's, or the dense MLP's
    with a zero aux loss."""
    if cfg.moe is not None:
        return moe_mod.moe_ffn(lp, x, cfg, shd)
    return pm.apply_swiglu(lp, x), torch.zeros((), device=x.device)


def _attn_out(lp, o, b, s):
    return pm.apply_linear(lp["attn"]["wo"], o.transpose(1, 2).reshape(
        b, s, o.shape[1] * o.shape[3]))


def _splits(cfg: ModelConfig, mesh):
    """``(attention, MLP, vocab)``: the tensor splits under a process
    ``mesh`` (Megatron-style), each None without a tensor axis. The
    attention's heads split head-aligned (``sharding.head_split``: with
    fewer kv heads than ranks each kv head is held by several ranks, and
    its group's query heads are split over them, unevenly where they do
    not divide; MLA's heads are their own groups), the dense MLP's hidden
    columns over ``tp`` (``None`` for a MoE FFN, which ``models.moe``
    splits), and the vocab of the embedding, LM head and cross-entropy
    (``sharding.vocab_split``). A count the split cannot take raises."""
    split = sharding.tensor_split(mesh)
    if split is None:
        return None, None, None
    if cfg.mla is not None:
        if cfg.n_heads < split.n:
            raise ValueError(f"MLA's {cfg.n_heads} heads do not split over "
                             f"the {split.n}-way {split.axis!r} axis")
        attn = sharding.head_split(split, cfg.n_heads, cfg.n_heads, "MLA")
    else:
        attn = sharding.head_split(split, cfg.n_heads, cfg.n_kv_heads)
    mlp = split if cfg.moe is None else None
    return attn, mlp, sharding.vocab_split(mesh, cfg.vocab)


def local_cfg(cfg: ModelConfig, heads) -> ModelConfig:
    """``cfg`` with this rank's heads of a ``sharding.HeadSplit``."""
    return cfg.with_(n_heads=heads.n_q_local, n_kv_heads=heads.n_kv_local,
                     d_head=cfg.head_dim)


def _layer(lp, x, pos, cfg: ModelConfig, backend: str,
           shd: ShardCtx = NO_SHARD):
    """One layer: (x, aux loss, (k, v)); MLA layers return no k/v (their
    cache is the latent, see ``mla.prefill``). Under a process mesh with a
    tensor axis the attention heads and the dense MLP's columns are this
    rank's share (``compute_specs``), and the layer's k/v are its heads'."""
    b, s, _ = x.shape
    split_attn, split_mlp, _ = _splits(cfg, shd.mesh)
    h = pm.apply_rmsnorm(lp["ln1"], x, cfg.norm_eps)
    if cfg.mla is not None:
        x = x + mla_mod.mla_attention(lp["attn"], h, pos, cfg, shd,
                                      backend, split_attn)
        kv = None
    elif split_attn is not None:
        lcfg = local_cfg(cfg, split_attn)
        q, k, v = _project_qkv(lp["attn"], split_attn.enter(h), lcfg, pos)
        o = _attn_out(lp, _attend(q, k, v, pos, lcfg, backend), b, s)
        x = x + split_attn.sum(o)
        kv = (k, v)
    else:
        q, k, v = _project_qkv(lp["attn"], h, cfg, pos)
        x = x + _attn_out(lp, _attend(q, k, v, pos, cfg, backend), b, s)
        kv = (k, v)
    h = pm.apply_rmsnorm(lp["ln2"], x, cfg.norm_eps)
    if split_mlp is not None:
        f = split_mlp.sum(pm.apply_swiglu(lp["ffn"], split_mlp.enter(h)))
        aux = torch.zeros((), device=x.device)
    else:
        f, aux = _ffn(lp["ffn"], h, cfg, shd)
    return x + f, aux, kv


def compute_specs(cfg: ModelConfig, mesh, seq: int) -> dict:
    """Physical PartitionSpecs of the parameters as the mesh train step
    computes with them (``model_api.compute_specs``), from ``_splits``:
    the attention's q/k/v (or MLA's ``q_b``/``kv_b``) columns and output
    rows by head (a ``sharding.Part`` where the head-aligned split is not
    DTensor's even chunk), the dense MLP's columns and rows, the MoE FFN's
    as ``moe.compute_specs``, the embedding's rows and the head's columns
    by vocab; the norms whole."""
    specs = sharding.whole(param_specs(cfg))
    layer = specs["layers"]
    attn, mlp, vocab = _splits(cfg, mesh)
    if attn is not None and cfg.mla is not None:
        layer["attn"].update(mla_mod.compute_specs(cfg, attn))
    elif attn is not None:
        dh = cfg.head_dim
        for k in ("wq", "wk", "wv"):
            spec = attn.q_spec if k == "wq" else attn.kv_spec
            layer["attn"][k]["w"] = spec(3, 2, dh)
            if "b" in layer["attn"][k]:
                layer["attn"][k]["b"] = spec(2, 1, dh)
        layer["attn"]["wo"]["w"] = attn.q_spec(3, 1, dh)
    if mlp is not None:
        layer["ffn"]["wg"]["w"] = mlp.spec(3, 2, cfg.d_ff)
        layer["ffn"]["wu"]["w"] = mlp.spec(3, 2, cfg.d_ff)
        layer["ffn"]["wd"]["w"] = mlp.spec(3, 1, cfg.d_ff)
    if cfg.moe is not None:
        layer["ffn"] = pm.tree_map(sharding.stacked_spec,
                                   moe_mod.compute_specs(cfg, mesh, seq))
    if vocab is not None:
        vocab_specs(specs, vocab)
    return specs


def vocab_specs(specs: dict, vocab) -> None:
    """Set the compute specs of a family's embedding rows and LM head
    columns (where it has them) to ``vocab``'s split, in place."""
    if "embed" in specs:
        specs["embed"]["table"] = vocab.spec(2, 0)
    if "head" in specs:
        specs["head"]["w"] = vocab.spec(2, 1)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def embed_tokens(p, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
                 vocab=None):
    """The input embeddings: a vlm's own, or the tokens' rows (under a
    ``vocab`` split, ``param.apply_embedding``'s)."""
    if cfg.embedding_inputs:
        return batch["embeddings"].to(compute_dtype(cfg))
    return pm.apply_embedding(p, cfg, batch["tokens"], vocab)


def forward(p, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            backend: str = "flash", shd: ShardCtx = NO_SHARD
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (final hidden states (B,S,d), aux loss summed over layers).
    Each layer runs under ``param.maybe_remat`` (``cfg.remat``)."""
    h = embed_tokens(p, cfg, batch, _splits(cfg, shd.mesh)[2])
    pos = torch.arange(h.shape[1], dtype=torch.int32, device=h.device)

    def body(lp, x):
        x, a, _ = _layer(shd.layer(lp, "layers"), x, pos, cfg, backend, shd)
        return x, a

    body = pm.maybe_remat(body, cfg)
    aux = torch.zeros((), device=h.device)
    for lp in pm.unstack(p["layers"], cfg.n_layers):
        h, a = body(lp, h)
        aux = aux + a
    return pm.apply_rmsnorm(p["ln_f"], h, cfg.norm_eps), aux


def lm_head_weight(p, cfg: ModelConfig) -> torch.Tensor:
    """The (d, vocab) head: the embedding table's transpose when tied."""
    if cfg.tie_embeddings:
        return p["embed"]["table"].T
    return p["head"]["w"]


def _ce_sum(h: torch.Tensor, w: torch.Tensor, labels: torch.Tensor
            ) -> torch.Tensor:
    """Sum over rows of ``logsumexp(logits) - logits[label]``, the logits
    ``h @ w`` taken in float32."""
    logits = (h @ w).float()
    gold = logits.gather(-1, labels[:, None].long())[:, 0]
    return (torch.logsumexp(logits, dim=-1) - gold).sum()


def ce_loss(h: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
            chunk: int = 0, vocab=None) -> torch.Tensor:
    """Mean cross-entropy of ``h`` (B,S,d) through the head ``w`` (d,V)
    against ``labels`` (B,S). Where ``chunk`` divides the token count, the
    logits are formed one chunk of tokens at a time, each chunk under a
    checkpoint, so neither pass keeps the (tokens x vocab) array: backward
    forms one chunk's logits again at a time. Otherwise one pass over
    every token, as the reference's. Under a ``vocab`` split
    (``sharding.VocabSplit``) ``w`` is this rank's columns and each chunk
    is ``vocab.ce_sum``."""
    b, s, d = h.shape
    t = b * s
    hf, lf = h.reshape(t, d), labels.reshape(t)
    ce_sum = _ce_sum
    if vocab is not None:
        hf, ce_sum = vocab.split.enter(hf), vocab.ce_sum
    if chunk and chunk < t and t % chunk == 0:
        ce = ce_sum
        if torch.is_grad_enabled():
            def ce(hc, wc, lc):
                return checkpoint(ce_sum, hc, wc, lc, use_reentrant=False)
        parts = [ce(hf[i:i + chunk], w, lf[i:i + chunk])
                 for i in range(0, t, chunk)]
        return torch.stack(parts).sum() / t
    return ce_sum(hf, w, lf) / t


def loss_fn(p, cfg: ModelConfig, batch, backend: str = "flash",
            shd: ShardCtx = NO_SHARD) -> torch.Tensor:
    """The training loss: chunked cross-entropy of the next tokens
    ``batch["labels"]`` plus ``AUX_COEF`` x the MoE's aux loss."""
    h, aux = forward(p, cfg, batch, backend, shd)
    w = lm_head_weight(p, cfg).to(compute_dtype(cfg))
    return ce_loss(h, w, batch["labels"], cfg.loss_chunk,
                   _splits(cfg, shd.mesh)[2]) + AUX_COEF * aux


# ---------------------------------------------------------------------------
# prefill / decode
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch_size: int, max_seq: int, dtype=None,
               device: DeviceLike = None) -> Dict[str, Any]:
    dtype = dtype or compute_dtype(cfg)
    if cfg.mla is not None:
        return mla_mod.init_cache(cfg, batch_size, max_seq, dtype, device)
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch_size, cfg.n_kv_heads, max_seq, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev),
            "pos": torch.zeros((), dtype=torch.int32, device=dev)}


def cache_specs(cfg: ModelConfig, long_context: bool = False) -> dict:
    """Logical PartitionSpecs of ``init_cache``'s entries: heads over the
    tensor axis, or for a long context the sequence over ``seq``."""
    if cfg.mla is not None:
        return mla_mod.cache_specs(cfg, long_context)
    kv = (P(None, "dp", None, "seq", None) if long_context
          else P(None, "dp", "tp", None, None))
    return {"k": kv, "v": kv, "pos": P()}


def prefill(p, cfg: ModelConfig, batch, backend: str = "flash",
            shd: ShardCtx = NO_SHARD) -> Tuple[Dict, torch.Tensor]:
    """Forward over the prompt, returning a filled cache + last logits.
    Under a process mesh (``shd.mesh``) each rank computes its rows with
    its heads (``_splits``): its k/v are its heads' cache where the heads
    split evenly, else every kv head (gathered over ``tp``: the cache
    spec leaves the heads whole there); the logits are its vocab
    columns."""
    splits = _splits(cfg, shd.mesh)
    if cfg.mla is not None:
        return mla_mod.prefill(p, cfg, batch, backend, shd, splits)
    split_attn, _, vocab = splits
    h = embed_tokens(p, cfg, batch, vocab)
    b, s, _ = h.shape
    pos = torch.arange(s, dtype=torch.int32, device=h.device)
    dt = compute_dtype(cfg)
    ks, vs = [], []
    for i in range(cfg.n_layers):
        h, _, (k, v) = _layer(shd.layer(pm.layer(p["layers"], i), "layers"),
                              h, pos, cfg, backend, shd)
        if split_attn is not None and not split_attn.even:
            k, v = split_attn.gather_kv(k, 1), split_attn.gather_kv(v, 1)
        ks.append(k.to(dt))
        vs.append(v.to(dt))
    cache = {"k": torch.stack(ks), "v": torch.stack(vs),
             "pos": torch.tensor(s, dtype=torch.int32, device=h.device)}
    return cache, pm.apply_lm_head(p, cfg, h[:, -1], vocab)


def decode_step(p, cfg: ModelConfig, cache, tokens, backend: str = "flash",
                sharded_long: bool = False, shd: ShardCtx = NO_SHARD
                ) -> Tuple[torch.Tensor, Dict]:
    """One decode step. tokens (B, 1); cache from init_cache/prefill.

    cache["pos"] may be a scalar (uniform decode) or a (B,) vector of
    per-sequence positions (continuous batching: every slot writes and
    masks at its own position). Where the reference returns new cache
    arrays, the port writes the new key/value rows into ``cache["k"]`` and
    ``cache["v"]`` in place (no copy of the cache per token); the returned
    cache shares them. ``sharded_long=True`` with a single-controller mesh
    in ``shd`` (and the ``clusterkv`` backend at a scalar position) splits
    each layer's cache sequence over the mesh's ``data`` axis
    (``attention.clusterkv_decode_sharded``). Under a process mesh each
    rank decodes its rows with its heads (``_splits``); when its cache is
    a slice of the sequence (``shd.seq``, every kv head), it writes the
    new row where it holds it (the heads gathered over ``tp``) and attends
    its slice, the partials combined over the split
    (``attention.decode_seq_split``). Where the heads do not split evenly
    (``sharding.HeadSplit.even``) the cache holds every kv head on every
    rank: each rank attends its own, and writes every head's new row,
    gathered over ``tp``. The logits are this rank's vocab columns. A vlm
    model (embedding inputs) continues from token embeddings ``tokens``
    (B, 1, d)."""
    splits = _splits(cfg, shd.mesh)
    if cfg.mla is not None:
        return mla_mod.decode_step(p, cfg, cache, tokens, backend,
                                   sharded_long, shd, splits)
    split_attn, split_mlp, vocab = splits
    dt = compute_dtype(cfg)
    if tokens.ndim == 3:
        h = tokens.to(dt)
    else:
        h = pm.apply_embedding(p, cfg, tokens, vocab)
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
    if per_slot:
        # a slot at position S (a prompt whose bucket filled the cache)
        # writes nothing, as the reference's out-of-range scatter drops it:
        # it writes back what row S - 1 holds
        fits = (qi < s_max)[:, None, None]
        qi = qi.clamp(max=s_max - 1)
    lcfg = cfg if split_attn is None else local_cfg(cfg, split_attn)
    seq = shd.seq
    # the cache holds every kv head: a long context's (this rank's slice
    # of the sequence), or one whose heads do not split evenly
    every_head = split_attn is not None and (seq is not None
                                             or not split_attn.even)
    heads = slice(*split_attn.kv) if every_head else slice(None)
    if seq is not None:
        kpos = torch.arange(seq.start, seq.start + seq.size,
                            dtype=torch.int32, device=dev)
    for i in range(cfg.n_layers):
        lp = shd.layer(pm.layer(p["layers"], i), "layers")
        kc, vc = cache["k"][i], cache["v"][i]          # (B,Hkv,S,dh) views
        hn = pm.apply_rmsnorm(lp["ln1"], h, cfg.norm_eps)
        if split_attn is not None:
            hn = split_attn.enter(hn)
        q, k, v = _project_qkv(lp["attn"], hn, lcfg, rope_pos)
        q1 = q[:, :, 0]                                 # (B,Hq,dh)
        k1, v1 = k[:, :, 0], v[:, :, 0]
        if every_head:
            k1, v1 = split_attn.gather_kv(k1, 1), split_attn.gather_kv(v1, 1)
        if seq is not None:
            attn.write_position(kc, k1, qi, seq)
            attn.write_position(vc, v1, qi, seq)
            ckv_cfg = None
            if backend == "clusterkv" and cfg.clusterkv.enabled:
                if not sharded_long:
                    raise ValueError("a cache whose sequence is split over "
                                     "a process mesh decodes ClusterKV "
                                     "with sharded_long=True")
                ckv_cfg = cfg.clusterkv
            o = q1.new_zeros(q1.shape[:2] + vc.shape[3:]) \
                if q1.shape[1] == 0 else attn.decode_seq_split(
                    q1, kc[:, heads], vc[:, heads], kpos, qpos, seq,
                    window=cfg.swa_window, cfg=ckv_cfg)
        else:
            if per_slot:
                kc[bi, :, qi] = torch.where(fits, k1.to(kc.dtype),
                                            kc[bi, :, qi])
                vc[bi, :, qi] = torch.where(fits, v1.to(vc.dtype),
                                            vc[bi, :, qi])
            else:
                attn.write_position(kc, k1, qi)
                attn.write_position(vc, v1, qi)
            o = q1.new_zeros(q1.shape[:2] + vc.shape[3:]) \
                if q1.shape[1] == 0 else _decode_attend(
                    q1, kc[:, heads], vc[:, heads], kpos, qpos, mask_qpos,
                    per_slot, cfg, backend, sharded_long, shd)
        a = pm.apply_linear(lp["attn"]["wo"],
                            o.reshape(b, 1, o.shape[1] * o.shape[2]))
        h = h + (a if split_attn is None else split_attn.sum(a))
        hn = pm.apply_rmsnorm(lp["ln2"], h, cfg.norm_eps)
        if split_mlp is not None:
            h = h + split_mlp.sum(pm.apply_swiglu(lp["ffn"],
                                                  split_mlp.enter(hn)))
        else:
            h = h + _ffn(lp["ffn"], hn, cfg, shd)[0]
    logits = pm.apply_lm_head(p, cfg, h[:, 0], vocab)
    new_cache = {"k": cache["k"], "v": cache["v"], "pos": cache["pos"] + 1}
    return logits, new_cache


def _decode_attend(q1, kc, vc, kpos, qpos, mask_qpos, per_slot: bool,
                   cfg: ModelConfig, backend: str, sharded_long: bool,
                   shd: ShardCtx):
    """One layer's single-token attention over a whole-sequence cache."""
    if backend == "clusterkv" and cfg.clusterkv.enabled:
        if per_slot:
            # continuous batching: per-call ordering over every slot's
            # cache region (the baseline the plan service amortizes)
            return attn.clusterkv_percall_decode(q1, kc, vc, kpos, qpos,
                                                 cfg.clusterkv)
        if sharded_long and shd.mesh is not None:
            return attn.clusterkv_decode_sharded(q1, kc, vc, kpos, qpos,
                                                 cfg.clusterkv, shd.mesh)
        return attn.clusterkv_decode(q1, kc, vc, kpos, qpos, cfg.clusterkv)
    return attn.decode_attention(q1, kc, vc, kpos, mask_qpos,
                                 window=cfg.swa_window)


def plan_prefill(p, cfg: ModelConfig, batch, perms) -> torch.Tensor:
    """Prefill THROUGH per-layer key plans: ``perms`` (L, B, Hkv, S) are
    cluster orderings (e.g. ``plan_batch_perm`` of one ``kv_plan_batch``
    per layer), driving the ``plan_batch`` path of
    :func:`~repro_torch.models.attention.clusterkv_attention`. Returns
    last-position logits only."""
    if cfg.mla is not None or cfg.embedding_inputs:
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
        h = h + _ffn(lp["ffn"], hn, cfg, NO_SHARD)[0]
    return pm.apply_lm_head(p, cfg, h[:, -1])


def plan_decode_step(p, cfg: ModelConfig, pstate, pend, tokens, slot_pos
                     ) -> Tuple[torch.Tensor, Dict, torch.Tensor,
                                torch.Tensor]:
    """One decode tick over PLAN-ORDERED caches (the ClusterKV service).

    Instead of the time-ordered cache of :func:`decode_step`, the serving
    state keeps each layer's keys/values in their session plan's cluster
    order plus the bookkeeping the sparse decode needs:

      pstate = {"ks","vs": (L,B,Hkv,S,dh) plan-ordered caches,
                "ps": (L,B,Hkv,S) int32 time position per plan slot
                      (INT32_MAX marks capacity holes),
                "cent": (L,B,Hkv,S/bk,dh) float32 per-tile centroids}
      pend   = {"k","v": (L,B,Hkv,dh) LAST tick's key/value,
                "slot": (L,B,Hkv) int plan slot the host-side inserter
                        claimed for it (sentinel S = nothing pending),
                "pos": (B,) int its time position}

    The step lands the pending k/v rows at their claimed slots, refreshes
    the one centroid tile each landing touched, and attends through
    :func:`~repro_torch.models.attention.clusterkv_plan_decode` with the
    current token's own k/v carried as an extra column (so self-attention
    never waits on the landing). tokens (B,1); slot_pos (B,). Returns
    ``(logits, pstate, k_new, v_new)`` where k_new/v_new (L,B,Hkv,dh) are
    THIS tick's rows for the host to claim slots for.

    Where the reference returns a new ``pstate``, the port writes the
    landing and the centroid refresh into ``pstate``'s tensors in place
    and returns the same dict. The reference scatters with the
    out-of-bounds sentinel dropped; PyTorch has no drop mode (and an
    out-of-range index is a device-side assert on CUDA), so every lane
    writes at its slot clamped into range and a lane with nothing pending
    writes back what its slot held: its ``ks/vs/ps/cent`` stay bit-equal
    (the reference recomputes the clamped tile's centroid there, equal up
    to rounding).
    """
    if cfg.mla is not None or cfg.embedding_inputs:
        raise NotImplementedError(
            "plan decode serves token decoder-only models")
    ckv_cfg = cfg.clusterkv
    dt = compute_dtype(cfg)
    h = p["embed"]["table"][tokens.long()].to(dt)
    b = h.shape[0]
    dev = h.device
    ks, vs, ps, cent = pstate["ks"], pstate["vs"], pstate["ps"], \
        pstate["cent"]
    nl, _, hkv, s_cap, _ = ks.shape
    bk = min(ckv_cfg.block_k, s_cap)
    qpos = torch.as_tensor(slot_pos, device=dev).to(torch.int32)
    rope_pos = qpos[:, None, None]
    li = torch.arange(nl, device=dev)[:, None, None]
    bi = torch.arange(b, device=dev)[None, :, None]
    hi = torch.arange(hkv, device=dev)[None, None, :]

    # land last tick's pending token at its claimed plan slot, one scatter
    # across all layers before the layer loop
    pslot = torch.as_tensor(pend["slot"], device=dev).long()
    live = pslot < s_cap                                    # (L,B,Hkv)
    slot = pslot.clamp(max=s_cap - 1)
    ppos = torch.as_tensor(pend["pos"], device=dev).to(ps.dtype)
    ppos = ppos[None, :, None].expand(nl, b, hkv)
    ks[li, bi, hi, slot] = torch.where(live[..., None],
                                       pend["k"].to(ks.dtype),
                                       ks[li, bi, hi, slot])
    vs[li, bi, hi, slot] = torch.where(live[..., None],
                                       pend["v"].to(vs.dtype),
                                       vs[li, bi, hi, slot])
    ps[li, bi, hi, slot] = torch.where(live, ppos, ps[li, bi, hi, slot])
    # refresh the ONE centroid tile each landing touched: gather the tile
    # first, then widen (never cast the whole cache)
    tile = slot // bk                                       # (L,B,Hkv)
    seg = ks[li[..., None], bi[..., None], hi[..., None],
             tile[..., None] * bk + torch.arange(bk, device=dev)]
    cent[li, bi, hi, tile] = torch.where(live[..., None],
                                         seg.float().mean(3),
                                         cent[li, bi, hi, tile])

    nks, nvs = [], []
    for i in range(nl):
        lp = pm.layer(p["layers"], i)
        hn = pm.apply_rmsnorm(lp["ln1"], h, cfg.norm_eps)
        q, k, v = _project_qkv(lp["attn"], hn, cfg, rope_pos)
        q1, k1, v1 = q[:, :, 0], k[:, :, 0], v[:, :, 0]
        o = attn.clusterkv_plan_decode(q1, ks[i], vs[i], ps[i], cent[i],
                                       qpos, ckv_cfg, k_self=k1, v_self=v1)
        h = h + pm.apply_linear(lp["attn"]["wo"], o.reshape(b, 1, -1))
        hn = pm.apply_rmsnorm(lp["ln2"], h, cfg.norm_eps)
        h = h + _ffn(lp["ffn"], hn, cfg, NO_SHARD)[0]
        nks.append(k1)
        nvs.append(v1)
    return (pm.apply_lm_head(p, cfg, h[:, 0]), pstate, torch.stack(nks),
            torch.stack(nvs))
