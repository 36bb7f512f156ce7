"""Attention backends.

Layout convention: q/k/v are (B, H, S, dh); positions are int32.

  dense_attention   naive full logits — tiny tests only
  flash_attention   loop over key tiles with online softmax (GQA-aware,
                    causal and sliding-window masks) in plain PyTorch — the
                    reference's own blockwise scan, the full-attention path
                    of train/prefill
  decode_attention  single-token attention over the whole cache
  clusterkv_*       the paper's technique (core/clusterkv): cluster-sorted
                    keys, top-B dense tiles per query tile; the tiles run
                    through the hand-written CUDA kernels
                    (kernels/block_attention.py, kernels/decode_attend.py)

  clusterkv_decode_sharded
                    long-context decode with the cache's sequence split
                    over a mesh axis: per-shard cluster selection and
                    partial softmax, combined as flash-decode partials
"""
from __future__ import annotations

import torch

from repro_torch import trace
from repro_torch.configs.base import ClusterKVConfig
from repro_torch.core import clusterkv as ckv
from repro_torch.core import costmodel
from repro_torch.core.registry import get_decode_backend, register_decode_backend
from repro_torch.kernels import ops as kops

NEG_INF = -1e30
INT32_MAX = 2 ** 31 - 1


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float = 1e4) -> torch.Tensor:
    """Rotary embedding. x (..., S, dh), pos (..., S) broadcastable."""
    dh = x.shape[-1]
    half = dh // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = pos[..., None].to(torch.float32) * freqs      # (..., S, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# full-attention paths
# ---------------------------------------------------------------------------


def _mask(logit, qpos, kpos, causal: bool, window: int):
    ok = torch.ones(logit.shape[-2:], dtype=torch.bool, device=logit.device)
    if causal:
        ok = kpos[None, :] <= qpos[:, None]
    if window:
        ok = ok & (kpos[None, :] > qpos[:, None] - window)
    return torch.where(ok, logit, NEG_INF)


def dense_attention(q, k, v, qpos, kpos, *, causal=True, window=0):
    b, hq, s, dh = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    qg = q.reshape(b, hkv, g, s, dh)
    logit = torch.einsum("bhgsd,bhtd->bhgst", qg.float(),
                         k.float()) / float(dh) ** 0.5
    logit = _mask(logit, qpos, kpos, causal, window)
    w = torch.softmax(logit, dim=-1)
    o = torch.einsum("bhgst,bhtd->bhgsd", w, v.float())
    return o.reshape(b, hq, s, v.shape[-1]).to(q.dtype)


def no_query_heads(q, k, v):
    """The attention output (B, 0, S, dv) of a rank of a head-aligned
    split that holds no query head (``sharding.head_split``): zeros, tied
    to ``q``, ``k`` and ``v`` so that backward reaches their projections
    on this rank as on the others (their weights' gradients are summed
    over the split, and every rank must take part)."""
    tie = q.sum() + k.sum() + v.sum()
    return q.new_zeros(q.shape[:3] + v.shape[3:]) + 0 * tie


def flash_attention(q, k, v, qpos, kpos, *, causal=True, window=0,
                    block: int = 512):
    """Blockwise online-softmax attention, a loop over key tiles."""
    b, hq, s, dh = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    g = hq // hkv
    scale = 1.0 / float(dh) ** 0.5
    nb = -(-skv // block)
    pad = nb * block - skv
    pad_pos = INT32_MAX
    kp = torch.nn.functional.pad(k, (0, 0, 0, pad))
    vp = torch.nn.functional.pad(v, (0, 0, 0, pad))
    posp = torch.nn.functional.pad(kpos.to(torch.int64), (0, pad),
                                   value=pad_pos)
    qg = q.reshape(b, hkv, g, s, dh).float()
    qp = qpos.to(torch.int64)

    m = torch.full((b, hkv, g, s), NEG_INF, device=q.device)
    l = torch.zeros((b, hkv, g, s), device=q.device)
    acc = torch.zeros((b, hkv, g, s, dv), device=q.device)
    for i in range(nb):
        kt = kp[:, :, i * block:(i + 1) * block].float()
        vt = vp[:, :, i * block:(i + 1) * block].float()
        pt = posp[i * block:(i + 1) * block]
        logit = torch.einsum("bhgsd,bhtd->bhgst", qg, kt) * scale
        ok = (pt[None, :] != pad_pos).expand(s, block)
        if causal:
            ok = ok & (pt[None, :] <= qp[:, None])
        if window:
            ok = ok & (pt[None, :] > qp[:, None] - window)
        logit = torch.where(ok, logit, NEG_INF)
        m_new = torch.maximum(m, logit.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(logit - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhgst,bhtd->bhgsd", p,
                                                    vt)
        m = m_new
    o = acc / torch.clamp_min(l, 1e-30)[..., None]
    return o.reshape(b, hq, s, dv).to(q.dtype)


def decode_attention(q, k, v, kpos, qpos, *, window=0):
    """q (B,Hq,dh) one token; cache k/v (B,Hkv,S,dh); kpos (B,S) or (S,);
    qpos a scalar or broadcastable to (B,1,1,1).

    Entries with kpos > qpos are masked (unfilled cache slots / future)."""
    b, hq, dh = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    if kpos.ndim == 1:
        kpos = kpos.expand(b, kpos.shape[0])
    qg = q.reshape(b, hkv, g, dh).float()
    logit = torch.einsum("bhgd,bhtd->bhgt", qg, k.float()) / float(dh) ** 0.5
    qpos = torch.as_tensor(qpos, device=q.device)
    ok = kpos[:, None, None, :] <= qpos
    if window:
        ok = ok & (kpos[:, None, None, :] > qpos - window)
    logit = torch.where(ok, logit, NEG_INF)
    w = torch.softmax(logit, dim=-1)
    o = torch.einsum("bhgt,bhtd->bhgd", w, v.float())
    return o.reshape(b, hq, dh).to(q.dtype)


# ---------------------------------------------------------------------------
# cluster-sparse backend (the paper's technique)
# ---------------------------------------------------------------------------


def clusterkv_attention(q, k, v, qpos, kpos, cfg: ClusterKVConfig, *,
                        causal=True, plan_batch=None):
    """Block-sparse attention over cluster-sorted keys (train/prefill).

    Keys are always cluster-sorted; for non-causal attention queries are
    cluster-sorted too — per kv-head group — so query tiles are
    cluster-coherent, and outputs are scattered back to original order
    (the paper's pi_t and pi_s). For causal LM attention queries stay in
    time order (the local-window boost supplies recency).

    ``plan_batch`` (an ``api.PlanBatch`` from ``ckv.kv_plan_batch(k)``, or
    the stacked (B, Hkv, Skv) ordering tensor taken from one) supplies the
    per-head key ordering instead of the per-call Morton sort. Key entries
    with ``kpos == INT32_MAX`` are holes and never attended.
    """
    with trace.span("ckv.attention"):
        b, hq, s, dh = q.shape
        hkv = k.shape[1]
        g = hq // hkv
        bq = min(cfg.block_q, s)
        bk = min(cfg.block_k, s)
        nqb, nkb = s // bq, k.shape[2] // bk
        n_sel = min(cfg.blocks_per_query, nkb)

        if kpos.ndim == 1:
            kposb = kpos.expand(b, hkv, kpos.shape[0])
        else:
            kposb = kpos
        if plan_batch is None:
            perm = ckv.cluster_perm(k, d=cfg.embed_dim)
        elif isinstance(plan_batch, torch.Tensor) \
                or not hasattr(plan_batch, "data"):
            perm = torch.as_tensor(plan_batch, device=k.device).long()
        else:
            perm = ckv.plan_batch_perm(plan_batch, (b, hkv)).to(k.device)
        k_s, v_s, pos_s = ckv.permute_kv(k, v, kposb, perm)

        if not causal:
            # pi_t: query cluster sort per kv-head group (positions
            # irrelevant)
            q_grp = q.reshape(b, hkv, g, s, dh).mean(dim=2)   # (B,Hkv,S,dh)
            qperm = ckv.cluster_perm(q_grp, d=cfg.embed_dim)  # (B,Hkv,S)
            qperm_h = qperm.repeat_interleave(g, dim=1)       # (B,Hq,S)
            q = torch.gather(q, -2, qperm_h[..., None].expand(b, hq, s, dh))
        with trace.span("ckv.select"):
            cent = ckv.block_centroids(k_s, bk)
            posb = pos_s.reshape(b, hkv, nkb, bk)
            kpmin = posb.amin(-1)
            # hole slots carry the INT32_MAX sentinel: they must not
            # inflate the tile's max position (every holey tile would look
            # "recent")
            kpmax = torch.where(posb == INT32_MAX, -1, posb).amax(-1)
            qc = q.reshape(b, hkv, g, nqb, bq, dh).mean(dim=(2, 4)).float()
            if causal:
                qpmin = qpos.reshape(nqb, bq).amin(-1)
                qpmax = qpos.reshape(nqb, bq).amax(-1)
                idx = ckv.select_blocks(
                    qc, cent.float(), kpmin, kpmax, qpmin, qpmax, n_sel, bq,
                    causal=True, local_window=cfg.local_window_blocks * bk)
            else:
                qpmax = None
                zero = torch.zeros((nqb,), dtype=kpmin.dtype,
                                   device=q.device)
                idx = ckv.select_blocks(qc, cent.float(), kpmin, kpmax, zero,
                                        zero, n_sel, bq, causal=False)
            trace.count("b6.pairs_selected", idx.numel() * g)
            trace.count_device("b6.pairs_live", ckv.live_pairs, idx, kpmin,
                               qpmax, g)
        out = _tile_attention(q, k_s, v_s, pos_s, qpos, idx, bq, bk, causal,
                              cfg)
        if causal:
            return out
        inv = torch.argsort(qperm_h, dim=-1)
        return torch.gather(out, -2, inv[..., None].expand(tuple(out.shape)))


def _check_kernel_setting(cfg: ClusterKVConfig, x: torch.Tensor) -> None:
    """The device picks the path: the kernel wrappers launch the CUDA
    kernel for a CUDA tensor and take the plain version for a CPU tensor.
    ``use_kernel=False`` therefore only holds on the CPU."""
    if cfg.use_kernel is False and x.device.type == "cuda":
        raise ValueError("use_kernel=False asks for the plain version, which "
                         "runs on CPU tensors only; on a CUDA tensor the "
                         "port launches its CUDA kernels (use 'auto')")


def _tile_attention(q, k_s, v_s, pos_s, qpos, idx, bq, bk, causal,
                    cfg: ClusterKVConfig):
    """Dense-tile interaction through ``ops.block_attention``: the CUDA
    kernel for a CUDA tensor, the plain online softmax for a CPU tensor;
    under grad B6's differentiable op, whose backward is the hand-written
    ``csrc/block_attention_bwd.cu`` on the card and the plain backward on
    the CPU."""
    _check_kernel_setting(cfg, q)
    return kops.block_attention(q, k_s, v_s, pos_s, qpos, idx, bq=bq, bk=bk,
                                causal=causal)


def clusterkv_decode(q, k, v, kpos, qpos, cfg: ClusterKVConfig):
    """Single-token decode: top-c tiles by centroid score, gathered attend.

    The select+gather+attend chain runs through ``ops.decode_attend_fused``:
    the fused CUDA kernel (``kernels/decode_attend.py``) for a CUDA tensor,
    ``decode_select`` + ``decode_attend`` for a CPU tensor. A cache length
    that is not tile-aligned falls back to dense decode, as the reference
    does."""
    b, hq, dh = q.shape
    hkv, s = k.shape[1], k.shape[2]
    bk = min(cfg.block_k, s)
    if s % bk:
        kp = kpos if kpos.ndim == 1 else kpos[0, 0]
        return decode_attention(q, k, v, kp, qpos)
    nkb = s // bk
    n_sel = min(cfg.decode_clusters, nkb)
    if kpos.ndim == 1:
        kpos = kpos.expand(b, hkv, kpos.shape[0])
    cent = ckv.block_centroids(k, bk)
    _check_kernel_setting(cfg, q)
    return kops.decode_attend_fused(q, k, v, kpos, cent, qpos, n_sel=n_sel,
                                    bk=bk)


def resolve_decode_backend(cfg: ClusterKVConfig, q: torch.Tensor,
                           ks: torch.Tensor | None = None,
                           vs: torch.Tensor | None = None) -> str:
    """``cfg.decode_backend`` with ``"auto"`` resolved: ``cuda`` on a CUDA
    tensor (the only decode backend that runs on card tensors), and on a
    CPU tensor the analytic cost model's winner
    (``core.costmodel.choose_decode_backend``, memoized per shape) at the
    shape of ``q`` (B,Hq,dh) over plan-ordered caches ``ks``/``vs``
    (B,Hkv,S,dh|dv). There ``cuda`` runs its plain version and is not
    ranked, so the winner is ``"plain"`` (no caches needed)."""
    name = cfg.decode_backend
    if name != "auto":
        return name
    if q.device.type == "cuda":
        return "cuda"
    if ks is None:
        return "plain"
    b, hq, dh = q.shape
    hkv, s = ks.shape[1], ks.shape[2]
    bk = min(cfg.block_k, s)
    feat = costmodel.DecodeFeatures(
        batch=b, hq=hq, hkv=hkv, s=s, dh=dh, dv=vs.shape[-1], bk=bk,
        n_sel=min(cfg.decode_clusters, s // bk))
    return costmodel.choose_decode_backend(feat, on_cpu=True)


def clusterkv_plan_decode(q, ks, vs, ps, cent, qpos, cfg: ClusterKVConfig, *,
                          k_self=None, v_self=None):
    """Single-token decode over PLAN-ordered caches (the decode service).

    q (B,Hq,dh); ks/vs (B,Hkv,S,dh) keys/values already in plan (cluster)
    order; ps (B,Hkv,S) int32 original time position of each plan slot,
    with ``INT32_MAX`` marking capacity holes; cent (B,Hkv,S/bk,dh)
    per-tile centroids; qpos (B,) per-slot decode positions.
    ``k_self``/``v_self`` (B,Hkv,dh) optionally carry the CURRENT token's
    key/value as an always-visible extra column.

    Dispatches through the decode-backend registry: ``cfg.decode_backend``
    names ``"cuda"`` (the fused kernel; its plain version on a CPU tensor)
    or ``"plain"`` (CPU tensors only); ``"auto"`` is ``"cuda"`` on a CUDA
    tensor and on a CPU tensor asks the analytic cost model
    (``core.costmodel.choose_decode_backend``), which prices B5's three
    launches and once-only tile reads against the plain path's launches
    and gather round trip (and does not rank ``cuda`` there).
    """
    name = resolve_decode_backend(cfg, q, ks, vs)
    return get_decode_backend(name)(q, ks, vs, ps, cent, qpos, cfg,
                                    k_self=k_self, v_self=v_self)


@register_decode_backend("plain")
def _plan_decode_plain(q, ks, vs, ps, cent, qpos, cfg: ClusterKVConfig, *,
                       k_self=None, v_self=None):
    """The plain reference decode backend (the reference's ``xla``), for
    CPU tensors: on the card the ``cuda`` backend launches the kernel."""
    if q.device.type == "cuda":
        raise ValueError("decode backend 'plain' runs on CPU tensors only; "
                         "on a CUDA tensor use 'cuda' or 'auto'")
    s = ks.shape[2]
    bk = min(cfg.block_k, s)
    return ckv.plan_decode_plain(q, ks, vs, ps, cent, qpos,
                                 n_sel=min(cfg.decode_clusters, s // bk),
                                 bk=bk, window=cfg.local_window_blocks * bk,
                                 k_self=k_self, v_self=v_self)


def clusterkv_percall_decode(q, k, v, kpos, qpos, cfg: ClusterKVConfig):
    """Per-call clusterkv decode for per-slot position vectors (qpos (B,)).

    Re-derives the Morton ordering and ALL tile centroids of the whole
    cache on every generated token — the baseline cost the plan-cached
    service amortizes away — then attends through
    :func:`clusterkv_plan_decode`."""
    b, hq, dh = q.shape
    hkv, s = k.shape[1], k.shape[2]
    bk = min(cfg.block_k, s)
    if kpos.ndim == 1:
        kpos = kpos.expand(b, hkv, s)
    if s % bk:
        return decode_attention(q, k, v, kpos[:, 0],
                                qpos[:, None, None, None])
    perm = ckv.cluster_perm(k, d=cfg.embed_dim)       # per call — the cost
    ks, vs, ps = ckv.permute_kv(k, v, kpos, perm)
    cent = ckv.block_centroids(ks.float(), bk)
    return clusterkv_plan_decode(q, ks, vs, ps, cent, qpos, cfg)


def write_position(c, row, qi, seq=None, dim: int = 2) -> None:
    """Write ``row`` (``c`` without axis ``dim``) at sequence position
    ``qi`` (a 0-d integer tensor) of the cache ``c``, in place, with no
    read of ``qi``'s value on the host. With ``seq`` (a
    ``models.sharding.SeqSplit``) ``c`` is this rank's slice of the
    sequence and only the rank that holds ``qi`` changes it; the others
    write back what they hold."""
    row = row.unsqueeze(dim).to(c.dtype)
    if seq is None:
        c.index_copy_(dim, qi.reshape(1), row)
        return
    inside = (qi >= seq.start) & (qi < seq.start + seq.size)
    at = (qi - seq.start).clamp(0, seq.size - 1).reshape(1)
    c.index_copy_(dim, at, torch.where(inside, row, c.index_select(dim, at)))


def _slice_partials(q, k, v, kp, qpos, *, window: int = 0,
                    cfg: ClusterKVConfig | None = None):
    """The partial softmax ``(m, l, o)`` of a single-token decode over one
    slice of a cache's sequence: q (B,Hq,dh); k/v (B,Hkv,S_slice,dh|dv);
    kp (B,Hkv,S_slice) the slice's positions. With ``cfg`` the top-c
    tiles of the slice by its own centroids (``decode_select``) only;
    without, every position, masked outside ``window``."""
    b, hq, dh = q.shape
    hkv, s_l = k.shape[1], k.shape[2]
    if cfg is not None:
        bk = min(cfg.block_k, s_l)
        n_sel = min(cfg.decode_clusters, s_l // bk)
        cent = ckv.block_centroids(k, bk)
        idx = ckv.decode_select(q.float(), cent.float(), n_sel)
        k, v = ckv.gather_tiles(k, idx, bk), ckv.gather_tiles(v, idx, bk)
        kp = ckv.gather_tiles(kp, idx, bk)
    qg = q.reshape(b, hkv, hq // hkv, dh).float()
    logit = torch.einsum("bhgd,bhtd->bhgt", qg, k.float()) / float(dh) ** 0.5
    ok = kp[:, :, None, :] <= qpos
    if window:
        ok = ok & (kp[:, :, None, :] > qpos - window)
    logit = torch.where(ok, logit, NEG_INF)
    m = logit.amax(dim=-1)
    p = torch.exp(logit - m[..., None])
    return m, p.sum(-1), torch.einsum("bhgt,bhtd->bhgd", p, v.float())


def decode_seq_split(q, k, v, kpos, qpos, seq, *, window: int = 0,
                     cfg: ClusterKVConfig | None = None):
    """Single-token decode over this rank's slice of a cache whose sequence
    is split over a process mesh axis (``seq``, a
    ``models.sharding.SeqSplit``): a partial softmax ``(m, l, o)`` over the
    slice, combined over the axis by max and sum (the reference's
    ``pmax``/``psum``). q (B,Hq,dh); k/v (B,Hkv,S_local,dh|dv), the slice;
    kpos (S_local,) its positions; qpos a scalar. With ``cfg`` every rank
    first selects the top-c tiles of its own slice, as
    ``clusterkv_decode_sharded`` does per shard; without, it attends every
    position (masked beyond ``qpos`` and outside ``window``). No rank
    reads another's slice."""
    b, hq, _ = q.shape
    m, l, o = _slice_partials(q, k, v, kpos.expand(b, *k.shape[1:3]), qpos,
                              window=window, cfg=cfg)
    return seq.combine(m, l, o).reshape(b, hq, -1).to(q.dtype)


def clusterkv_decode_sharded(q, k, v, kpos, qpos, cfg: ClusterKVConfig,
                             mesh, axis: str = "data"):
    """Long-context decode with the cache sequence sharded over ``axis``
    of ``mesh`` (a :class:`~repro_torch.launch.mesh.Mesh`).

    Every shard takes its contiguous slice of the cache to its device,
    builds its local tile centroids, selects its local top-c tiles
    (``decode_select``) and computes a partial softmax ``(m, l, o)``; the
    partials combine by max and sum (the reference's ``pmax``/``psum``)
    on ``q``'s device — flash-decode with the paper's cluster selection
    inside each shard. No cross-shard gather ever touches the cache. The
    reference's local step is XLA, so this is plain PyTorch.
    """
    b, hq, dh = q.shape
    hkv, s = k.shape[1], k.shape[2]
    devices = mesh.devices_along(axis)
    s_local = s // len(devices)
    if kpos.ndim == 1:
        kpos = kpos.expand(b, hkv, s)
    home = q.device
    qp = torch.as_tensor(qpos, device=home)
    ms, ls, os_ = [], [], []
    for d, dev in enumerate(devices):
        part = slice(d * s_local, (d + 1) * s_local)
        m, l, o = _slice_partials(q.to(dev), k[:, :, part].to(dev),
                                  v[:, :, part].to(dev),
                                  kpos[:, :, part].to(dev), qp.to(dev),
                                  cfg=cfg)
        ms.append(m.to(home))
        ls.append(l.to(home))
        os_.append(o.to(home))
    mm = torch.stack(ms).amax(dim=0)
    alpha = [torch.exp(m - mm) for m in ms]
    ll = sum(l * a for l, a in zip(ls, alpha))
    oo = sum(o * a[..., None] for o, a in zip(os_, alpha))
    out = oo / torch.clamp(ll, min=1e-30)[..., None]
    return out.reshape(b, hq, dh).to(q.dtype)
