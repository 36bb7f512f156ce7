"""Multi-head Latent Attention (MiniCPM3 / DeepSeek-V2 style).

Prefill expands the latent into full per-head K/V and reuses the shared
attention backends: q/k carry ``qk_nope_head_dim + qk_rope_head_dim``
features and v ``v_head_dim`` (96 and 64 at MiniCPM3), so the ClusterKV
prefill reaches the B6 kernel with ``dh != dv``. Decode runs the ABSORBED
form: the cache holds only the normalized latent ``c`` (rank) and the
shared RoPE key ``kr`` (dr) per token, the query-side projection is
absorbed into the latent space, and attention is a dense einsum over the
latent cache (no kernel, as in the reference). ``sharded_long`` with a
mesh runs ClusterKV on the latent cache with its sequence split over the
mesh's ``data`` axis (:func:`_latent_decode_sharded`).

Where the reference returns new cache arrays, the port writes the new
latent rows into ``cache["c"]`` and ``cache["kr"]`` in place.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.clusterkv import topk_stable
from repro_torch.models import attention as attn
from repro_torch.models import param as pm
from repro_torch.models.sharding import NO_SHARD, P, ShardCtx

NEG_INF = -1e30


def _dims(cfg: ModelConfig):
    m = cfg.mla
    return (m.q_lora_rank, m.kv_lora_rank, m.qk_nope_head_dim,
            m.qk_rope_head_dim, m.v_head_dim)


def init_mla(cfg: ModelConfig) -> dict:
    d, h = cfg.d_model, cfg.n_heads
    qr, kr, dn, dr, dv = _dims(cfg)
    return {"q_a": pm.linear(d, qr, spec=("fsdp", None)),
            "q_ln": pm.rmsnorm(qr),
            "q_b": pm.linear(qr, h * (dn + dr), spec=(None, "tp")),
            "kv_a": pm.linear(d, kr + dr, spec=("fsdp", None)),
            "kv_ln": pm.rmsnorm(kr),
            "kv_b": pm.linear(kr, h * (dn + dv), spec=(None, "tp")),
            "wo": pm.linear(h * dv, d, spec=("tp", "fsdp"))}


def compute_specs(cfg: ModelConfig, heads) -> dict:
    """Compute specs of a stacked MLA layer's head-split weights under a
    ``sharding.HeadSplit`` of its heads: ``q_b``'s and ``kv_b``'s columns
    and ``wo``'s rows by head; ``q_a``/``kv_a`` and the norms stay whole,
    as the reference's specs leave them."""
    _, _, dn, dr, dv = _dims(cfg)
    return {"q_b": {"w": heads.q_spec(3, 2, dn + dr)},
            "kv_b": {"w": heads.q_spec(3, 2, dn + dv)},
            "wo": {"w": heads.q_spec(3, 1, dv)}}


def _q_proj(lp, x, cfg: ModelConfig, pos, split=None):
    """x (B,S,d) -> q_nope (B,H,S,dn), q_rope (B,H,S,dr) (roped). Under a
    tensor ``split`` ``q_b`` holds this rank's heads."""
    b, s, _ = x.shape
    _, _, dn, dr, _ = _dims(cfg)
    q_lat = pm.apply_rmsnorm(lp["q_ln"], pm.apply_linear(lp["q_a"], x))
    if split is not None:
        q_lat = split.enter(q_lat)
    q = pm.apply_linear(lp["q_b"], q_lat)
    q = q.reshape(b, s, -1, dn + dr).transpose(1, 2)
    qrope = attn.rope(q[..., dn:], pos[None, None, :], cfg.rope_theta)
    return q[..., :dn], qrope


def _kv_latent(lp, x, cfg: ModelConfig, pos):
    """x (B,S,d) -> cn (B,S,rank) normalized latent, krope (B,S,dr) roped."""
    kr = cfg.mla.kv_lora_rank
    kv = pm.apply_linear(lp["kv_a"], x)
    cn = pm.apply_rmsnorm(lp["kv_ln"], kv[..., :kr])
    return cn, attn.rope(kv[..., kr:], pos[None, :], cfg.rope_theta)


def _expand_kv(lp, cn, cfg: ModelConfig):
    """cn (B,S,rank) -> k_nope (B,H,S,dn), v (B,H,S,dv)."""
    b, s, _ = cn.shape
    _, _, dn, _, dv = _dims(cfg)
    kv = pm.apply_linear(lp["kv_b"], cn).reshape(b, s, -1, dn + dv)
    kv = kv.transpose(1, 2)
    return kv[..., :dn], kv[..., dn:]


def _attend_latent(lp, x, pos, cfg: ModelConfig, backend: str,
                   split=None):
    """Prefill attention through the expanded latent: the (B,S,d) output
    incl. wo, and the latent (cn, krope) the cache keeps. Under a tensor
    ``split`` (a process mesh's ``tp``) ``q_b``/``kv_b`` hold this rank's
    heads' columns and ``wo`` their rows; the latents are whole."""
    b, s, _ = x.shape
    qn, qrope = _q_proj(lp, x, cfg, pos, split)
    cn, krope = _kv_latent(lp, x, cfg, pos)
    cl, kl = (cn, krope) if split is None else (split.enter(cn),
                                                split.enter(krope))
    kn, v = _expand_kv(lp, cl, cfg)
    q = torch.cat([qn, qrope], dim=-1)
    k = torch.cat([kn, kl[:, None].expand(*kn.shape[:-1],
                                          kl.shape[-1])], dim=-1)
    if backend == "clusterkv" and cfg.clusterkv.enabled:
        o = attn.clusterkv_attention(q, k, v, pos, pos, cfg.clusterkv,
                                     causal=True)
    elif backend == "dense":
        o = attn.dense_attention(q, k, v, pos, pos, causal=True)
    else:
        o = attn.flash_attention(q, k, v, pos, pos, causal=True)
    o = pm.apply_linear(lp["wo"], o.transpose(1, 2).reshape(b, s, -1))
    return (o if split is None else split.sum(o)), cn, krope


def mla_attention(lp, x, pos, cfg: ModelConfig, shd: ShardCtx = NO_SHARD,
                  backend: str = "flash", split=None) -> torch.Tensor:
    """Full (train/prefill) MLA attention, returns (B,S,d) incl. wo;
    ``split`` as ``_attend_latent``'s."""
    return _attend_latent(lp, x, pos, cfg, backend, split)[0]


# ---------------------------------------------------------------------------
# cache / prefill / absorbed decode
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch_size: int, max_seq: int, dtype=None,
               device: DeviceLike = None) -> Dict[str, Any]:
    dev = resolve_device(device)
    dtype = dtype or pm.DTYPES[cfg.dtype]
    _, kr, _, dr, _ = _dims(cfg)
    return {"c": torch.zeros((cfg.n_layers, batch_size, max_seq, kr),
                             dtype=dtype, device=dev),
            "kr": torch.zeros((cfg.n_layers, batch_size, max_seq, dr),
                              dtype=dtype, device=dev),
            "pos": torch.zeros((), dtype=torch.int32, device=dev)}


def cache_specs(cfg: ModelConfig, long_context: bool = False) -> dict:
    """Logical PartitionSpecs of the latent cache (sequence over ``seq``
    for a long context)."""
    c = P(None, "dp", "seq", None) if long_context else P(None, "dp", None,
                                                          None)
    return {"c": c, "kr": c, "pos": P()}


def _mlp(lp, hn, split):
    """The layer's SwiGLU MLP; under a tensor ``split`` this rank's
    columns, summed over ``tp``."""
    if split is None:
        return pm.apply_swiglu(lp["ffn"], hn)
    return split.sum(pm.apply_swiglu(lp["ffn"], split.enter(hn)))


def prefill(p, cfg: ModelConfig, batch, backend: str = "flash",
            shd: ShardCtx = NO_SHARD, splits=(None, None, None)):
    """Forward over the prompt: the latent cache (``c``, ``kr``) and the
    last logits. Under a process mesh the layers are gathered one at a
    time (``shd.layer``) and ``splits`` (the transformer's ``_splits``)
    give this rank's heads, MLP columns and vocab; the latents are
    whole."""
    dt = pm.DTYPES[cfg.dtype]
    h = pm.apply_embedding(p, cfg, batch["tokens"], splits[2])
    b, s, _ = h.shape
    pos = torch.arange(s, dtype=torch.int32, device=h.device)
    cs, krs = [], []
    for i in range(cfg.n_layers):
        lp = shd.layer(pm.layer(p["layers"], i), "layers")
        hn = pm.apply_rmsnorm(lp["ln1"], h, cfg.norm_eps)
        a, cn, krope = _attend_latent(lp["attn"], hn, pos, cfg, backend,
                                      splits[0])
        h = h + a
        hn = pm.apply_rmsnorm(lp["ln2"], h, cfg.norm_eps)
        h = h + _mlp(lp, hn, splits[1])
        cs.append(cn.to(dt))
        krs.append(krope.to(dt))
    cache = {"c": torch.stack(cs), "kr": torch.stack(krs),
             "pos": torch.tensor(s, dtype=torch.int32, device=h.device)}
    return cache, pm.apply_lm_head(p, cfg, h[:, -1], splits[2])


def _absorbed_scores_attend(lp, qn, qrope, cc, krc, kpos, qpos,
                            cfg: ModelConfig, shd: ShardCtx, backend: str,
                            sharded_long: bool, split=None):
    """Absorbed-form attention over the latent cache.

    qn (B,H,dn), qrope (B,H,dr) (H: this rank's heads under a tensor
    ``split``, whose ``kv_b`` holds their columns); cc (B,S,rank); krc
    (B,S,dr), or this rank's slice of the sequence (``shd.seq``).
    Returns o_lat (B,H,rank) float32."""
    _, kr, dn, dr, dv = _dims(cfg)
    wk = lp["kv_b"]["w"].reshape(kr, -1, dn + dv)[..., :dn]
    q_lat = torch.einsum("bhd,rhd->bhr", qn.float(), wk.float())
    scale = 1.0 / math.sqrt(dn + dr)
    ckv_on = backend == "clusterkv" and cfg.clusterkv.enabled
    if shd.seq is not None:
        if ckv_on and not sharded_long:
            raise ValueError("a cache whose sequence is split over a "
                             "process mesh decodes ClusterKV with "
                             "sharded_long=True")
        return _latent_decode_seq(q_lat, qrope, cc, krc, kpos, qpos, cfg,
                                  shd.seq, scale, split, ckv_on)
    if ckv_on and shd.mesh is not None and sharded_long:
        return _latent_decode_sharded(q_lat, qrope, cc, krc, kpos, qpos,
                                      cfg, shd, scale)
    logits = (torch.einsum("bhr,bsr->bhs", q_lat, cc.float())
              + torch.einsum("bhd,bsd->bhs", qrope.float(), krc.float())
              ) * scale
    logits = torch.where(kpos[None, None, :] <= qpos, logits, NEG_INF)
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("bhs,bsr->bhr", w, cc.float())


def _latent_partials(q_lat, qrope, cc, krc, kpos, qpos, cfg: ModelConfig,
                     scale, head_mean=None):
    """The partial softmax ``(m, l, o)`` of the absorbed decode over one
    slice of the latent cache (cc (B,S_slice,rank), krc (B,S_slice,dr),
    kpos (S_slice,)): with ``head_mean`` (the mean over every head of a
    (B,H,tiles) score) the top-c latent tiles by it only, as the ClusterKV
    decode selects per slice; without, every position."""
    b, s_l, rank = cc.shape
    qr = qrope.float()
    cs, ks, ps = cc.float(), krc.float(), kpos.expand(b, s_l)
    if head_mean is not None:
        bk = min(cfg.clusterkv.block_k, s_l)
        nkb = s_l // bk
        n_sel = min(cfg.clusterkv.decode_clusters, nkb)
        cb = cc.reshape(b, nkb, bk, rank)
        krb = krc.reshape(b, nkb, bk, -1)
        sc = (torch.einsum("bhr,bkr->bhk", q_lat, cb.mean(dim=2).float())
              + torch.einsum("bhd,bkd->bhk", qr, krb.mean(dim=2).float()))
        idx = topk_stable(head_mean(sc), n_sel)            # (b, n_sel)
        bi = torch.arange(b, device=cc.device)[:, None]
        cs = cb[bi, idx].reshape(b, -1, rank).float()
        ks = krb[bi, idx].reshape(b, n_sel * bk, -1).float()
        ps = kpos.reshape(nkb, bk)[idx].reshape(b, -1)
    lg = (q_lat @ cs.mT + qr @ ks.mT) * scale               # (b, H, t)
    lg = torch.where(ps[:, None, :] <= qpos, lg, NEG_INF)
    m = lg.amax(dim=-1)
    pexp = torch.exp(lg - m[..., None])
    return m, pexp.sum(-1), pexp @ cs


def _latent_decode_sharded(q_lat, qrope, cc, krc, kpos, qpos,
                           cfg: ModelConfig, shd: ShardCtx, scale):
    """ClusterKV decode on the latent cache, its sequence split over the
    mesh's ``data`` axis: per shard, latent-block centroids, top-c tiles by
    the head-mean score, a partial softmax over the gathered tiles; the
    partials combine by max and sum on ``q_lat``'s device (the reference's
    ``pmax``/``psum``). Each shard's slice goes to its own device."""
    devices = shd.mesh.devices_along("data")
    s_local = cc.shape[1] // len(devices)
    home = q_lat.device
    qp = torch.as_tensor(qpos, device=home)
    ms, ls, os_ = [], [], []
    for d, dev in enumerate(devices):
        part = slice(d * s_local, (d + 1) * s_local)
        m, l, o = _latent_partials(
            q_lat.to(dev), qrope.to(dev), cc[:, part].to(dev),
            krc[:, part].to(dev), kpos[part].to(dev), qp.to(dev), cfg, scale,
            lambda sc: sc.mean(dim=1))
        ms.append(m.to(home))
        ls.append(l.to(home))
        os_.append(o.to(home))
    mm = torch.stack(ms).amax(dim=0)
    alpha = [torch.exp(m - mm) for m in ms]
    ll = sum(l * a for l, a in zip(ls, alpha))
    oo = sum(o * a[..., None] for o, a in zip(os_, alpha))
    return oo / torch.clamp_min(ll, 1e-30)[..., None]


def _latent_decode_seq(q_lat, qrope, cc, krc, kpos, qpos, cfg: ModelConfig,
                       seq, scale, split, clusterkv: bool):
    """Decode on this rank's slice of a latent cache whose sequence is
    split over a process mesh axis (``seq``): ``_latent_partials`` of the
    slice (with ``clusterkv`` the head mean over every head: under a
    tensor ``split`` this rank's heads' sum, summed over ``tp``), combined
    over the split (``seq.combine``)."""
    import torch.distributed as dist

    def head_mean(sc):
        if split is None:
            return sc.mean(dim=1)
        sc = sc.sum(dim=1)
        dist.all_reduce(sc, group=split.group)
        return sc / cfg.n_heads

    return seq.combine(*_latent_partials(q_lat, qrope, cc, krc, kpos, qpos,
                                         cfg, scale,
                                         head_mean if clusterkv else None))


def decode_step(p, cfg: ModelConfig, cache, tokens,
                backend: str = "flash", sharded_long: bool = False,
                shd: ShardCtx = NO_SHARD, splits=(None, None, None)
                ) -> Tuple[torch.Tensor, Dict]:
    """One absorbed decode step at the cache's scalar position (the
    reference's ``dynamic_update_slice`` takes no per-slot vector). Under
    a process mesh ``splits`` (the transformer's ``_splits``) give this
    rank's heads, MLP columns and vocab, and with ``shd.seq`` the cache is
    this rank's slice of the sequence."""
    qpos = torch.as_tensor(cache["pos"], device=cache["c"].device)
    if qpos.ndim:
        raise ValueError("MLA decode takes a scalar cache position; per-slot "
                         "positions (continuous batching) are not served")
    dt = pm.DTYPES[cfg.dtype]
    split_attn, split_mlp, vocab = splits
    h = pm.apply_embedding(p, cfg, tokens, vocab)
    b = h.shape[0]
    _, kr, dn, _, dv = _dims(cfg)
    seq = shd.seq
    if seq is None:
        kpos = torch.arange(cache["c"].shape[2], dtype=torch.int32,
                            device=h.device)
    else:
        kpos = torch.arange(seq.start, seq.start + seq.size,
                            dtype=torch.int32, device=h.device)
    rope_pos = qpos[None].to(torch.int32)
    qi = qpos.long()
    for i in range(cfg.n_layers):
        lp = shd.layer(pm.layer(p["layers"], i), "layers")
        cc, krc = cache["c"][i], cache["kr"][i]        # (B,S,rank) views
        hn = pm.apply_rmsnorm(lp["ln1"], h, cfg.norm_eps)
        qn, qrope = _q_proj(lp["attn"], hn, cfg, rope_pos, split_attn)
        cn1, kr1 = _kv_latent(lp["attn"], hn, cfg, rope_pos)
        attn.write_position(cc, cn1[:, 0], qi, seq, dim=1)
        attn.write_position(krc, kr1[:, 0], qi, seq, dim=1)
        o_lat = _absorbed_scores_attend(
            lp["attn"], qn[:, :, 0], qrope[:, :, 0], cc, krc, kpos, qpos,
            cfg, shd, backend, sharded_long, split_attn)
        wv = lp["attn"]["kv_b"]["w"].reshape(kr, -1, dn + dv)[..., dn:]
        o = torch.einsum("bhr,rhd->bhd", o_lat, wv.float())
        a = pm.apply_linear(lp["attn"]["wo"], o.reshape(b, 1, -1).to(dt))
        h = h + (a if split_attn is None else split_attn.sum(a))
        hn = pm.apply_rmsnorm(lp["ln2"], h, cfg.norm_eps)
        h = h + _mlp(lp, hn, split_mlp)
    logits = pm.apply_lm_head(p, cfg, h[:, 0], vocab)
    return logits, {"c": cache["c"], "kr": cache["kr"],
                    "pos": cache["pos"] + 1}
