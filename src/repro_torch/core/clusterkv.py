"""Cluster-sparse attention — the paper's pipeline as an LM attention backend.

Attention's score matrix *is* a near-neighbor interaction matrix (queries =
targets, keys = sources). The paper's reordering pipeline is applied per
(batch, kv head):

  1. low-dimensional embedding of the keys onto their top-d principal axes
     (``core.embedding.pca_project_det``, paper §2.4 step 1);
  2. hierarchical clustering by Morton order in the embedding space
     (``core.hierarchy.morton_codes``, step 2) -> keys permuted into
     cluster order (on a card steps 1 and 2 are one kernel,
     ``kernels.ops.cluster_codes``);
  3. the interaction is computed *block-sparse with dense blocks*: for each
     query tile only the top-B key tiles (by centroid score) are kept, and
     each kept (q-tile, k-tile) pair is a dense block (steps 3-4).

Causality is preserved exactly *within* the computed blocks via gathered key
positions; block selection always boosts blocks containing the local causal
window. These are the plain PyTorch versions; the hand-written CUDA kernels
(``kernels/block_attention.py``, ``kernels/decode_attend.py``) compute the
same contracts.

Selections follow the reference's ``lax.top_k``: descending, ties to the
LOWEST index (every masked tile scores ``NEG_INF``, so ties are common).
``torch.topk`` promises no order among ties, so :func:`topk_stable` takes a
stable descending sort instead. Morton codes repeat, so orderings use
``torch.argsort(..., stable=True)`` as ``jnp.argsort`` does.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch import trace
from repro_torch._device import DeviceLike, device_of

NEG_INF = -1e30
INT32_MAX = 2 ** 31 - 1


def topk_stable(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the ``k`` largest entries along the last axis, in
    descending order with ties to the lowest index (``lax.top_k``'s
    order), as int64."""
    return torch.sort(scores, dim=-1, descending=True, stable=True
                      ).indices[..., :k]


def masked_softmax(logit: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Softmax over the last axis with a guarded normalizer.

    Equal to a plain softmax whenever at least one column of ``mask`` is
    live (masked entries carry ``NEG_INF`` logits whose ``exp`` underflows
    to exactly 0), but returns exact zeros instead of a uniform row when
    EVERY column is masked (an early-position decode whose selected tiles
    are all holes/future)."""
    logit = torch.where(mask, logit, NEG_INF)
    m = logit.amax(dim=-1, keepdim=True).detach()
    e = torch.where(mask, torch.exp(logit - m), 0.0)
    return e / torch.clamp_min(e.sum(dim=-1, keepdim=True), 1e-30)


def decode_logits(qh: torch.Tensor, ksel: torch.Tensor) -> torch.Tensor:
    """Scaled q·k logits: qh (..., g, dh) float32, ksel (..., c, dh)
    float32 -> (..., g, c). (The reference pads a single query row to two
    for XLA:CPU bit stability; that has no counterpart here.)"""
    scale = torch.sqrt(torch.tensor(float(qh.shape[-1])))
    return (qh @ ksel.mT) / scale


def decode_combine(w: torch.Tensor, vsel: torch.Tensor) -> torch.Tensor:
    """Weighted value combine w (..., g, c) @ vsel (..., c, dv) float32."""
    return w @ vsel


# ---------------------------------------------------------------------------
# per-head orderings as a PlanBatch (the plan API as the ordering asset)
# ---------------------------------------------------------------------------


def kv_plan_batch(k, *, d: int = 3, bits: int = 10, leaf_size: int = 64,
                  knn: int = 8, with_bsr: bool = False, capacity: int = None,
                  device: DeviceLike = None):
    """One ``InteractionPlan`` per (batch, kv head) over the keys ``k``
    (..., S, dh), stacked as an ``api.PlanBatch`` — the per-head ordering
    :func:`select_blocks` consumes (see :func:`plan_batch_perm`).

    Built on ``device`` (a tensor's own device when ``None``).
    ``with_bsr=True`` additionally dresses each head's kNN pattern into
    storage, so the same batch serves batched near-neighbor matvecs over
    the key sets. ``capacity`` over-allocates every member to the given
    slot count with Morton-spread holes, so generated tokens stream in
    through ``api.update_plan``'s insert tier instead of re-sorting.
    """
    from repro_torch import api

    dev = device_of(k, device)
    kt = torch.as_tensor(k).to(device=dev, dtype=torch.float32)
    s, dh = kt.shape[-2:]
    flat = kt.reshape((-1, s, dh))
    return api.build_plan_batch(list(flat), k=min(knn, s - 1),
                                d=min(d, dh), bits=bits,
                                leaf_size=leaf_size, with_bsr=with_bsr,
                                backend="bsr", capacity=capacity, device=dev)


def plan_batch_perm(pb, lead: Tuple[int, ...]) -> torch.Tensor:
    """Stacked cluster ordering of a :func:`kv_plan_batch` result, shaped
    ``lead + (S,)`` (e.g. ``(B, Hkv, S)``), int64 — a drop-in for the
    permutation :func:`cluster_perm` derives per call."""
    pi = pb.data.pi
    want = 1
    for x in lead:
        want *= int(x)
    if pi.shape[0] != want:
        raise ValueError(
            f"PlanBatch has {pi.shape[0]} members, lead shape {lead} "
            f"needs {want} (one plan per (batch, kv-head))")
    return pi.reshape(tuple(lead) + (pi.shape[-1],)).long()


# ---------------------------------------------------------------------------
# steps 1+2: embed + cluster order
# ---------------------------------------------------------------------------


def cluster_perm(k: torch.Tensor, d: int = 3, bits: int = 10) -> torch.Tensor:
    """Cluster ordering of keys ``k`` (..., S, dh) -> perm (..., S) int64.

    perm[i] = index (into original order) of the i-th key in cluster order.
    Every (..., S, dh) set is embedded onto its own top-``d`` axes (one
    batched subspace iteration), Morton coded (``ops.cluster_codes``: one
    kernel launch on a card) and stably sorted by its codes.
    """
    # kernels.ops imports this module (B5/B6 take its plain versions)
    from repro_torch.kernels import ops

    with trace.span("ckv.cluster_perm"):
        with trace.span("ckv.pca"):
            codes = ops.cluster_codes(k, d, bits)
        with trace.span("ckv.morton_sort"):
            return torch.argsort(codes, dim=-1, stable=True)


def permute_kv(k: torch.Tensor, v: torch.Tensor, pos: torch.Tensor,
               perm: torch.Tensor):
    """Apply cluster order along the S axis of k, v (B, H, S, dh), pos (B, H, S)."""
    def take(a):
        return torch.gather(a, -2, perm[..., None].expand(
            tuple(perm.shape) + (a.shape[-1],)))

    with trace.span("ckv.permute_kv"):
        perm = perm.long()
        return take(k), take(v), torch.gather(pos, -1, perm)


# ---------------------------------------------------------------------------
# step 3: block centroids + top-B causal selection
# ---------------------------------------------------------------------------


def block_centroids(k_sorted: torch.Tensor, bk: int) -> torch.Tensor:
    """(B, H, S, dh) -> (B, H, S/bk, dh) mean key per cluster tile."""
    b, h, s, dh = k_sorted.shape
    return k_sorted.reshape(b, h, s // bk, bk, dh).mean(dim=3)


def select_blocks(q_cent: torch.Tensor, k_cent: torch.Tensor,
                  kpos_min: torch.Tensor, kpos_max: torch.Tensor,
                  qpos_min: torch.Tensor, qpos_max: torch.Tensor,
                  n_sel: int, bq: int, causal: bool = True,
                  local_window: int = 128) -> torch.Tensor:
    """Top-``n_sel`` key tiles per query tile.

    q_cent (B,H,nqb,dh), k_cent (B,H,nkb,dh); kpos_min/max (B,H,nkb) are the
    min/max original positions inside each (cluster-sorted) key tile;
    qpos_min/max (nqb,). Returns idx (B,H,nqb,n_sel) int32.
    """
    scores = torch.einsum("bhqd,bhkd->bhqk", q_cent, k_cent)
    if causal:
        # key tile fully in the future of the whole query tile -> never valid
        invalid = kpos_min[:, :, None, :] > qpos_max[None, None, :, None]
        scores = torch.where(invalid, NEG_INF, scores)
        # boost tiles holding the local causal window (recent tokens)
        recent = (kpos_max[:, :, None, :]
                  >= (qpos_min[None, None, :, None] - local_window))
        near = recent & ~invalid
        scores = torch.where(near, scores + 1e4, scores)
    return topk_stable(scores, n_sel).to(torch.int32)


def live_pairs(idx: torch.Tensor, kpos_min: torch.Tensor, qpos_max, g: int
               ) -> torch.Tensor:
    """How many of the selected (query head, key tile) pairs hold work:
    idx (B,Hkv,nqb,n_sel) tiles in range whose least key position
    ``kpos_min`` (B,Hkv,nkb) is at or before the query tile's last
    position ``qpos_max`` (nqb,); ``None`` (no causal mask) counts every
    pair in range. Each kv head's pairs count once per query head of its
    group (``g``). An int64 scalar on idx's device, no host sync."""
    nkb = kpos_min.shape[-1]
    ix = idx.long()
    ok = (ix >= 0) & (ix < nkb)
    if qpos_max is not None:
        kmin = torch.gather(kpos_min, -1, ix.clamp(0, nkb - 1).flatten(2))
        ok &= kmin.view_as(ix) <= qpos_max[:, None]
    return ok.sum() * g


# ---------------------------------------------------------------------------
# step 4: block-segment interaction (online softmax over selected tiles)
# ---------------------------------------------------------------------------


def sparse_block_attention(q: torch.Tensor, k_sorted: torch.Tensor,
                           v_sorted: torch.Tensor, pos_sorted: torch.Tensor,
                           qpos: torch.Tensor, idx: torch.Tensor,
                           bq: int, bk: int, causal: bool = True,
                           stats: bool = False):
    """Block-sparse attention with dense tiles (the plain PyTorch path;
    the CUDA kernel in kernels/block_attention.py computes the same
    contract).

    q (B,Hq,S,dh); k_sorted/v_sorted (B,Hkv,S_k,dh|dv) in cluster order;
    pos_sorted (B,Hkv,S_k) original positions; qpos (S,) query positions;
    idx (B,Hkv,nqb,n_sel) selected key tiles per query tile. Hq must be a
    multiple of Hkv (GQA: query head h reads kv head h // g). Products and
    sums in float32 (float64 for float64 inputs); the output is in q's
    dtype. ``stats=True`` also returns each row's final max ``m`` and sum
    ``l`` (B,Hq,S) in the working dtype, natural units: the weights are
    ``exp(logit - m) / l`` (the backward's row statistics).
    """
    b, hq, s, dh = q.shape
    hkv, s_k = k_sorted.shape[1], k_sorted.shape[2]
    dv = v_sorted.shape[-1]
    g = hq // hkv
    nqb = s // bq
    n_sel = idx.shape[-1]
    scale = 1.0 / float(dh) ** 0.5
    wt = torch.promote_types(q.dtype, torch.float32)

    qb = q.reshape(b, hkv, g, nqb, bq, dh).to(wt)
    kb = k_sorted.reshape(b, hkv, s_k // bk, bk, dh)
    vb = v_sorted.reshape(b, hkv, s_k // bk, bk, dv)
    pb = pos_sorted.reshape(b, hkv, s_k // bk, bk)
    qp = qpos.reshape(nqb, bq)
    ix = idx.long()
    bi = torch.arange(b, device=q.device)[:, None, None]
    hi = torch.arange(hkv, device=q.device)[None, :, None]

    m = torch.full((b, hkv, g, nqb, bq), NEG_INF, dtype=wt, device=q.device)
    l = torch.zeros((b, hkv, g, nqb, bq), dtype=wt, device=q.device)
    acc = torch.zeros((b, hkv, g, nqb, bq, dv), dtype=wt, device=q.device)
    for j in range(n_sel):
        t = ix[..., j]                                    # (b, hkv, nqb)
        kt = kb[bi, hi, t].to(wt)                         # (b,hkv,nqb,bk,dh)
        vt = vb[bi, hi, t].to(wt)
        pt = pb[bi, hi, t]                                # (b,hkv,nqb,bk)
        logit = torch.einsum("bhgqtd,bhqsd->bhgqts", qb, kt) * scale
        if causal:
            mask = pt[:, :, None, :, None, :] <= qp[None, None, None, :, :,
                                                    None]
            logit = torch.where(mask, logit, NEG_INF)
        m_new = torch.maximum(m, logit.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(logit - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhgqts,bhqsd->bhgqtd",
                                                    p, vt)
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    out = out.reshape(b, hq, s, dv).to(q.dtype)
    if stats:
        return out, m.reshape(b, hq, s), l.reshape(b, hq, s)
    return out


# ---------------------------------------------------------------------------
# decode: top-c cluster selection + gathered attention
# ---------------------------------------------------------------------------


def decode_select(q: torch.Tensor, centroids: torch.Tensor,
                  n_sel: int) -> torch.Tensor:
    """q (B,Hq,dh) grouped to kv heads scores centroids (B,Hkv,nkb,dh);
    returns idx (B,Hkv,n_sel) int32."""
    b, hq, dh = q.shape
    hkv = centroids.shape[1]
    qg = q.reshape(b, hkv, hq // hkv, dh).mean(dim=2)
    scores = (qg[:, :, None, :] * centroids).sum(dim=-1)
    return topk_stable(scores, n_sel).to(torch.int32)


def gather_tiles(x: torch.Tensor, idx: torch.Tensor, bk: int) -> torch.Tensor:
    """The selected tiles of ``x`` (B, H, S, ...) as one concatenated axis:
    idx (B, H, c) tile ids -> (B, H, c*bk, ...)."""
    b, h, s = x.shape[:3]
    rest = tuple(x.shape[3:])
    xb = x.reshape((b, h, s // bk, bk) + rest)
    bi = torch.arange(b, device=x.device)[:, None, None]
    hi = torch.arange(h, device=x.device)[None, :, None]
    sel = xb[bi, hi, idx.long()]                       # (b, h, c, bk, ...)
    return sel.reshape((b, h, idx.shape[-1] * bk) + rest)


def decode_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  pos: torch.Tensor, qpos, idx: torch.Tensor,
                  bk: int) -> torch.Tensor:
    """Single-token attention over gathered cluster tiles.

    q (B,Hq,dh); k/v (B,Hkv,S,dh); pos (B,Hkv,S); qpos scalar or (B,);
    idx (B,Hkv,c) tile ids. Returns (B,Hq,dv) in q's dtype. Entries with
    pos > qpos are masked (cache slots not yet filled, or future
    positions); a selection with no live entry gives exact zeros.
    """
    b, hq, dh = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    dv = v.shape[-1]
    ksel = gather_tiles(k, idx, bk).float()            # (b, hkv, c*bk, dh)
    vsel = gather_tiles(v, idx, bk).float()
    psel = gather_tiles(pos, idx, bk)                  # (b, hkv, c*bk)
    qp = torch.as_tensor(qpos, device=q.device).reshape(-1, 1, 1, 1)
    logit = decode_logits(q.reshape(b, hkv, g, dh).float(), ksel)
    w = masked_softmax(logit, psel[:, :, None, :] <= qp)
    out = decode_combine(w, vsel)
    return out.reshape(b, hq, dv).to(q.dtype)


# ---------------------------------------------------------------------------
# decode over plan-ordered caches (the decode service's contract)
# ---------------------------------------------------------------------------


def plan_select(q, ps, cent, qpos, *, n_sel: int, bk: int,
                window: int) -> torch.Tensor:
    """Plan-mode tile selection (B,Hkv,n_sel) int64: tiles with no live
    entry (``ps > qpos``: holes and future) score ``NEG_INF``, a live tile
    whose largest live position is within ``window`` of ``qpos`` gets
    ``+1e4``, then the top ``n_sel`` with ties to the lowest index."""
    b, hq, dh = q.shape
    hkv, s = ps.shape[1], ps.shape[2]
    g = hq // hkv
    pt = ps.reshape(b, hkv, s // bk, bk)
    qp = torch.as_tensor(qpos, device=q.device).to(torch.int64).reshape(-1)
    qp = qp.expand(b)
    live = pt <= qp[:, None, None, None]              # causal AND not-a-hole
    tile_has = live.any(-1)                           # (B,Hkv,nkb)
    # the group mean in float32 (as the fused kernel takes it); the
    # reference's XLA path averages in q's dtype, which differs in bf16
    qg = q.reshape(b, hkv, g, dh).float().mean(dim=2)
    scores = (qg[:, :, None, :] * cent.float()).sum(-1)
    scores = torch.where(tile_has, scores, NEG_INF)
    recent = torch.where(live, pt, -1).amax(-1)
    near = recent >= (qp[:, None, None] - window)
    scores = torch.where(near & tile_has, scores + 1e4, scores)
    return topk_stable(scores, n_sel)


def plan_decode_plain(q, ks, vs, ps, cent, qpos, *, n_sel: int, bk: int,
                      window: int, k_self=None, v_self=None):
    """The plain select + gather + attend over plan-ordered caches (the
    reference's ``_plan_decode_xla``), with its knobs spelled out.

    q (B,Hq,dh); ks/vs (B,Hkv,S,dh|dv) in plan order; ps (B,Hkv,S) time
    positions, ``INT32_MAX`` at holes; cent (B,Hkv,S/bk,dh); qpos (B,);
    ``k_self``/``v_self`` (B,Hkv,dh|dv) an optional always-visible column.
    """
    b, hq, dh = q.shape
    hkv = ks.shape[1]
    g = hq // hkv
    dv = vs.shape[-1]
    qp = torch.as_tensor(qpos, device=q.device).to(torch.int64).reshape(-1)
    qp = qp.expand(b)
    idx = plan_select(q, ps, cent, qp, n_sel=n_sel, bk=bk, window=window)

    ksel = gather_tiles(ks, idx, bk)
    vsel = gather_tiles(vs, idx, bk)
    psel = gather_tiles(ps, idx, bk).to(torch.int64)
    if k_self is None:
        k_self = torch.zeros((b, hkv, dh), dtype=ks.dtype, device=ks.device)
        v_self = torch.zeros((b, hkv, dv), dtype=vs.dtype, device=vs.device)
        self_pos = torch.full((b, hkv), INT32_MAX, dtype=torch.int64,
                              device=ks.device)        # masked out
    else:
        self_pos = qp[:, None].expand(b, hkv)
    # the self column is promoted with the tiles to float32, never rounded
    # to the cache dtype (the reference's concatenate promotes likewise)
    ksel = torch.cat([ksel.float(), k_self[:, :, None, :].float()], dim=2)
    vsel = torch.cat([vsel.float(), v_self[:, :, None, :].float()], dim=2)
    psel = torch.cat([psel, self_pos[:, :, None]], dim=2)
    logit = decode_logits(q.reshape(b, hkv, g, dh).float(), ksel)
    # guarded (see masked_softmax): a just-admitted slot can select nothing
    # but holes when no self column rides along
    w = masked_softmax(logit, psel[:, :, None, :] <= qp[:, None, None, None])
    out = decode_combine(w, vsel)
    return out.reshape(b, hq, dv).to(q.dtype)
