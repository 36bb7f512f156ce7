"""Analytic FLOP / byte models per (arch x shape) cell, as the
reference's ``launch/analytic.py``.

The closed forms count every matmul in the model (the models are ours, so
this is exact for the matmul work); MODEL_FLOPS (the 6ND numerator) falls
out of the same accounting restricted to "useful" weight matmuls. FLOPs
and bytes do not depend on the hardware and equal the reference's for
every cell; only the rates they are priced at differ: ``PEAK_FLOPS``,
``HBM_BW`` and ``LINK_BW`` come from the port's
``core.costmodel.get_hardware()`` (the H100 knobs: bf16 on the tensor
cores, the probed HBM rate, NVLink one way).

Conventions:
  - MAC = 2 flops; all numbers are GLOBAL per step (divide by chips).
  - Backward = 2x forward; full remat adds ~1x forward recompute.
  - Attention flops use the backend actually lowered for the cell
    (dense/flash = full causal, clusterkv = top-B blocks, swa = window).
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.configs.base import SHAPES, ModelConfig, get_config
from repro_torch.core.costmodel import get_hardware
from repro_torch.models import model_api
from repro_torch.models.param import count_params

# per-card rates from the knob-based hardware config (the H100 defaults;
# override with REPRO_TORCH_HW_CONFIG / costmodel.set_hardware before
# import)
_HW = get_hardware()
PEAK_FLOPS = _HW.bf16_flops   # bf16, tensor cores
HBM_BW = _HW.hbm_bw           # bytes/s
LINK_BW = _HW.nvlink_bw       # bytes/s, NVLink one way


def _attn_flops_per_layer(cfg: ModelConfig, s: int, backend: str,
                          causal: bool = True) -> float:
    """Score+AV flops for one layer, one sequence (no projections)."""
    if cfg.family in ("ssm", "hybrid"):
        return 0.0   # scan flops live in the proj term; shared attn separate
    hq = cfg.n_heads
    if cfg.mla is not None:
        dqk = cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim
        dv = cfg.mla.v_head_dim
    else:
        dqk = dv = cfg.head_dim
    if backend == "clusterkv":
        ck = cfg.clusterkv
        kv_per_q = min(ck.blocks_per_query * ck.block_k, s)
        pairs = s * kv_per_q
        # selection: centroid scores (nqb x nkb x dh) — counted too
        nqb = max(s // ck.block_q, 1)
        nkb = max(s // ck.block_k, 1)
        sel = nqb * nkb * dqk
        return 2.0 * hq * (pairs * (dqk + dv)) + 2.0 * hq * sel
    if cfg.swa_window and s > cfg.swa_window:
        pairs = s * cfg.swa_window
    else:
        pairs = s * s / 2 if causal else s * s
    return 2.0 * hq * pairs * (dqk + dv)


def _proj_flops_per_layer_token(cfg: ModelConfig) -> float:
    """Weight-matmul flops per token per layer (the 6N/L numerator piece)."""
    d = cfg.d_model
    if cfg.mla is not None:
        m = cfg.mla
        h = cfg.n_heads
        f = (d * m.q_lora_rank + m.q_lora_rank * h * (m.qk_nope_head_dim
                                                      + m.qk_rope_head_dim)
             + d * (m.kv_lora_rank + m.qk_rope_head_dim)
             + m.kv_lora_rank * h * (m.qk_nope_head_dim + m.v_head_dim)
             + h * m.v_head_dim * d)
    elif cfg.family == "ssm":
        ssm = cfg.ssm
        di = ssm.expand * d
        dtr = ssm.dt_rank or -(-d // 16)
        n = ssm.d_state
        f = (d * 2 * di                    # in_proj
             + di * (dtr + 2 * n)          # x_proj
             + dtr * di                    # dt_proj
             + di * d                      # out_proj
             + 5 * di * n)                 # scan update + C readout
    elif cfg.family == "hybrid":
        ssm = cfg.ssm
        di = ssm.expand * d
        n = ssm.d_state
        nh = di // ssm.head_dim
        l_chunk = ssm.chunk
        f = (d * 2 * di + d * 2 * n + d * nh + di * d
             + nh * (l_chunk * (n + ssm.head_dim))   # SSD intra-chunk per tok
             + 2 * nh * ssm.head_dim * n)            # states in/out
    else:
        dh = cfg.head_dim
        f = d * (cfg.n_heads + 2 * cfg.n_kv_heads) * dh \
            + cfg.n_heads * dh * d
        if cfg.moe is not None:
            m = cfg.moe
            f += d * m.n_experts                     # router
            f += 3 * d * m.d_ff_expert * m.top_k
            f += 3 * d * m.d_ff_expert * m.n_shared_experts
        else:
            f += 3 * d * cfg.d_ff
    return 2.0 * f  # MAC -> flops


def _shared_block_flops_token(cfg: ModelConfig) -> float:
    d2 = 2 * cfg.d_model
    return 2.0 * (4 * d2 * d2 + 3 * d2 * cfg.d_ff + d2 * cfg.d_model)


def _head_flops_token(cfg: ModelConfig) -> float:
    return 2.0 * cfg.d_model * cfg.vocab


def n_params(cfg: ModelConfig) -> int:
    return count_params(model_api.param_shapes(cfg))


def n_active_params(cfg: ModelConfig) -> float:
    """Active params per token (MoE: routed top-k + shared only)."""
    total = n_params(cfg)
    if cfg.moe is None:
        return float(total)
    m = cfg.moe
    per_layer_all = 3 * cfg.d_model * m.d_ff_expert * m.n_experts
    per_layer_act = 3 * cfg.d_model * m.d_ff_expert * (m.top_k
                                                       + m.n_shared_experts
                                                       - m.n_shared_experts)
    per_layer_act = 3 * cfg.d_model * m.d_ff_expert * m.top_k
    return float(total - cfg.n_layers * (per_layer_all - per_layer_act))


@dataclass
class CellModel:
    flops: float              # global flops per step (all work lowered)
    model_flops: float        # "useful" 6ND-style numerator
    hbm_bytes: float          # global HBM traffic per step (first-order)


def cell_model(arch: str, shape_name: str, backend: str | None = None,
               microbatch: int = 1, layout: str = "2d", chips: int = 256,
               param_dtype: str | None = None, remat: str | None = None,
               ep: bool = False) -> CellModel:
    cfg = get_config(arch)
    if remat == "none":
        cfg = cfg.with_(remat=False)
    elif remat in ("dots", "full"):
        cfg = cfg.with_(remat=True, remat_policy=remat)
    seq, batch, kind = SHAPES[shape_name]
    backend = backend or model_api.backend_for(cfg, shape_name)
    tokens = batch * seq
    p_total = n_params(cfg)
    p_active = n_active_params(cfg)
    pbytes = 2 if (param_dtype or cfg.param_dtype) == "bfloat16" else 4
    # per-device weight HBM reads: TP-resident shards for serve_tp, EP
    # experts resident /16, the full (ZeRO-gathered) set otherwise
    w_dev = p_total * pbytes / (16 if layout == "serve_tp" else 1)
    if ep and cfg.moe is not None:
        m = cfg.moe
        p_exp = 3 * cfg.d_model * m.d_ff_expert * m.n_experts * cfg.n_layers
        w_dev = (p_total - p_exp) * pbytes + p_exp * pbytes / 16

    if kind == "train":
        fwd = tokens * (_proj_flops_per_layer_token(cfg) * cfg.n_layers
                        + _head_flops_token(cfg))
        fwd += batch * _attn_flops_per_layer(cfg, seq, backend) * cfg.n_layers
        if cfg.family == "encdec":
            # encoder stack + cross attention
            fwd += tokens * _proj_flops_per_layer_token(cfg) * cfg.n_enc_layers
            fwd += batch * _attn_flops_per_layer(cfg, seq, backend, False) \
                * cfg.n_enc_layers
            fwd += 2.0 * cfg.n_layers * batch * seq * seq \
                * cfg.n_heads * 2 * cfg.head_dim
        if cfg.family == "hybrid":
            n_shared = -(-cfg.n_layers // cfg.shared_attn_every)
            fwd += tokens * _shared_block_flops_token(cfg) * n_shared
            fwd += batch * n_shared * 2.0 * cfg.n_heads \
                * (seq * seq / 2) * 2 * (2 * cfg.d_model // cfg.n_heads)
        if not cfg.remat:
            mult = 3.0
        elif cfg.remat_policy == "dots":
            mult = 3.3          # matmul outputs saved; elementwise recomputed
        else:
            mult = 4.0
        flops = fwd * mult
        model_flops = 6.0 * p_active * tokens
        # HBM: gathered-weight reads on every device (fwd+bwd+remat) + opt
        # state passes (sharded) + activations
        act = cfg.n_layers * tokens * cfg.d_model * 2 * 8
        hbm = chips * w_dev * (3 if cfg.remat else 2) \
            + p_total * 12 + act
        return CellModel(flops, model_flops, hbm)

    if kind == "prefill":
        fwd = tokens * (_proj_flops_per_layer_token(cfg) * cfg.n_layers
                        + _head_flops_token(cfg) * (1.0 / seq))
        fwd += batch * _attn_flops_per_layer(cfg, seq, backend) * cfg.n_layers
        if cfg.family == "encdec":
            fwd += tokens * _proj_flops_per_layer_token(cfg) * cfg.n_enc_layers
            fwd += batch * _attn_flops_per_layer(cfg, seq, backend, False) \
                * cfg.n_enc_layers
            fwd += 2.0 * cfg.n_layers * batch * seq * seq \
                * cfg.n_heads * 2 * cfg.head_dim
        if cfg.family == "hybrid":
            n_shared = -(-cfg.n_layers // cfg.shared_attn_every)
            fwd += tokens * _shared_block_flops_token(cfg) * n_shared
            fwd += batch * n_shared * 2.0 * cfg.n_heads \
                * (seq * seq / 2) * 2 * (2 * cfg.d_model // cfg.n_heads)
        hbm = chips * w_dev + cache_bytes(cfg, batch, seq) \
            + cfg.n_layers * tokens * cfg.d_model * 2 * 4
        # head runs once per sequence in prefill -> exclude from "useful"
        p_useful = p_active - cfg.d_model * cfg.vocab
        return CellModel(fwd, 2.0 * p_useful * tokens, hbm)

    # decode: one token per sequence
    fwd = batch * (_proj_flops_per_layer_token(cfg) * cfg.n_layers
                   + _head_flops_token(cfg))
    if cfg.family == "hybrid":
        n_shared = -(-cfg.n_layers // cfg.shared_attn_every)
        fwd += batch * _shared_block_flops_token(cfg) * n_shared
    # attention over the cache
    fwd += batch * _decode_attn_flops(cfg, seq, backend)
    model_flops = 2.0 * p_active * batch
    hbm = chips * w_dev + decode_cache_read_bytes(cfg, batch, seq, backend)
    return CellModel(fwd, model_flops, hbm)


def _decode_attn_flops(cfg: ModelConfig, s: int, backend: str) -> float:
    if cfg.family == "ssm":
        ssm = cfg.ssm
        di = ssm.expand * cfg.d_model
        return 2.0 * cfg.n_layers * 3 * di * ssm.d_state
    layers = cfg.n_layers
    if cfg.family == "hybrid":
        layers = -(-cfg.n_layers // cfg.shared_attn_every)
        hq = cfg.n_heads
        dh = 2 * cfg.d_model // hq
        ssm = cfg.ssm
        di = ssm.expand * cfg.d_model
        ssm_f = 2.0 * cfg.n_layers * 3 * di * ssm.d_state
    else:
        hq = cfg.n_heads
        if cfg.mla is not None:
            dh = cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim
        else:
            dh = 2 * cfg.head_dim
        ssm_f = 0.0
    if backend == "clusterkv":
        ck = cfg.clusterkv
        kv = min(ck.decode_clusters * ck.block_k, s)
        sel = s // ck.block_k * (dh // 2)
        per_layer = 2.0 * hq * (kv * dh + sel)
    elif cfg.swa_window and s > cfg.swa_window:
        per_layer = 2.0 * hq * cfg.swa_window * dh
    else:
        per_layer = 2.0 * hq * s * dh
    return layers * per_layer + ssm_f


def cache_bytes(cfg: ModelConfig, batch: int, s: int) -> float:
    if cfg.family == "ssm":
        ssm = cfg.ssm
        di = ssm.expand * cfg.d_model
        return 4.0 * cfg.n_layers * batch * di * ssm.d_state
    if cfg.mla is not None:
        per_tok = cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim
        return 2.0 * cfg.n_layers * batch * s * per_tok
    if cfg.family == "hybrid":
        n_sh = -(-cfg.n_layers // cfg.shared_attn_every)
        ssm = cfg.ssm
        di = ssm.expand * cfg.d_model
        return (2.0 * n_sh * batch * s * 2 * 2 * cfg.d_model
                + 4.0 * cfg.n_layers * batch
                * (di // ssm.head_dim) * ssm.head_dim * ssm.d_state)
    mult = 2 if cfg.family != "encdec" else 4   # enc-dec caches cross KV too
    return 2.0 * mult * cfg.n_layers * batch * s * cfg.n_kv_heads \
        * cfg.head_dim


def analytic_collectives(arch: str, shape_name: str, multi_pod: bool = False,
                         backend: str | None = None, layout: str = "2d",
                         ep: bool = False) -> dict:
    """First-order per-DEVICE collective traffic model (ring factors:
    all-gather/reduce-scatter ~ 1x payload, all-reduce ~ 2x).

    Components: ZeRO-3 param all-gathers (fwd + bwd), gradient
    reduce-scatter, Megatron-style TP all-reduces (2/layer fwd, 2/layer bwd),
    MoE expert-TP psum of the dispatch buffer, cross-pod DP gradient
    reduction (DCN) on multi-pod.
    """
    cfg = get_config(arch)
    seq, batch, kind = SHAPES[shape_name]
    backend = backend or model_api.backend_for(cfg, shape_name)
    chips = 512 if multi_pod else 256
    pbytes = 2 if cfg.param_dtype == "bfloat16" else 4
    gbytes = pbytes                       # grads in param dtype
    p_total = n_params(cfg)
    if layout == "dp_all":
        dp, tp = chips, 1
        # full ZeRO over all chips: gathers move the whole param set
        p_dev_bytes = p_total * pbytes
        g_dev_bytes = p_total * gbytes
    elif layout == "moe_dp" and cfg.moe is not None:
        # experts resident over 'model' (EP); everything else pure DP/ZeRO
        dp, tp = chips, 1
        m = cfg.moe
        p_exp = 3 * cfg.d_model * m.d_ff_expert * m.n_experts * cfg.n_layers
        p_dev_bytes = max(p_total - p_exp, 0) * pbytes
        g_dev_bytes = (max(p_total - p_exp, 0) + p_exp / 16) * gbytes
        ep = True
    elif layout == "serve_tp":
        dp, tp = chips // 16, 16
        p_dev_bytes = 0.0                 # weights resident (TP-only)
        g_dev_bytes = 0.0                 # serving: no grads
    else:
        dp, tp = (32 if multi_pod else 16), 16
        # params are 2D-sharded (fsdp x tp): the ZeRO gather per device
        # only moves that device's TP shard of every param
        p_dev_bytes = p_total * pbytes / tp
        g_dev_bytes = p_total * gbytes / tp
    ep = ep or (cfg.moe is not None and cfg.moe.expert_parallel)
    if ep and layout == "2d":
        # EP: expert weights are stationary (sharded over 'model'), only
        # non-expert params move through ZeRO gathers
        m = cfg.moe
        p_exp = 3 * cfg.d_model * m.d_ff_expert * m.n_experts * cfg.n_layers
        p_dev_bytes = max(p_total - p_exp, 0) * pbytes / tp  # experts resident
        g_dev_bytes = (max(p_total - p_exp, 0) / tp + p_exp / tp) * gbytes
    d = cfg.d_model
    layers = cfg.n_layers + (cfg.n_enc_layers if cfg.family == "encdec" else 0)

    out = {}
    tp_work = tp > 1
    if kind == "train":
        tokens_loc = batch * seq / dp
        out["param_allgather"] = 2.0 * p_dev_bytes               # fwd + bwd
        out["grad_reduce"] = 1.0 * g_dev_bytes                   # reduce-scatter
        out["tp_allreduce"] = (2.0 * 4 * layers * tokens_loc * d * 2
                               if tp_work else 0.0)
        if cfg.family == "hybrid" and tp_work:
            n_sh = -(-cfg.n_layers // cfg.shared_attn_every)
            out["tp_allreduce"] += 2.0 * 4 * n_sh * tokens_loc * (2 * d) * 2
        if cfg.moe is not None:
            m = cfg.moe
            if ep:
                out["moe_alltoall"] = 4.0 * cfg.n_layers * tokens_loc \
                    * m.top_k * 1.25 * d * 2
            elif tp_work:
                out["moe_psum"] = 2.0 * 2 * cfg.n_layers * tokens_loc \
                    * m.top_k * 1.25 * d * 4
    else:
        tokens_loc = (batch * seq if kind == "prefill" else batch) / dp
        out["param_allgather"] = 1.0 * p_dev_bytes
        out["tp_allreduce"] = (2.0 * 2 * layers * tokens_loc * d * 2
                               if tp_work else 0.0)
        if cfg.moe is not None:
            m = cfg.moe
            if ep:
                out["moe_alltoall"] = 2.0 * cfg.n_layers * tokens_loc \
                    * m.top_k * 1.25 * d * 2
            elif tp_work:
                out["moe_psum"] = 2.0 * cfg.n_layers * tokens_loc \
                    * m.top_k * 1.25 * d * 4
        if kind == "decode" and shape_name.startswith("long"):
            # sharded flash-decode partial combine: tiny psum per layer
            out["decode_psum"] = 2.0 * layers * batch * cfg.n_heads * 3 * 4
    out["total"] = sum(out.values())
    return out


def decode_cache_read_bytes(cfg: ModelConfig, batch: int, s: int,
                            backend: str) -> float:
    total = cache_bytes(cfg, batch, s)
    if cfg.family == "ssm":
        return total
    if backend == "clusterkv":
        ck = cfg.clusterkv
        frac = min(ck.decode_clusters * ck.block_k / s, 1.0)
        # centroids are always read: 1/block_k of the cache
        return total * (frac + 1.0 / ck.block_k)
    if cfg.swa_window and s > cfg.swa_window:
        return total * (cfg.swa_window / s)
    return total
