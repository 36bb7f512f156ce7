"""Cluster-block-sparse attention (ClusterKV prefill): the hand-written CUDA
kernel and its plain version.

Counterpart of the reference's ``kernels/block_attention.py`` (Pallas, TPU)
and of the two vmaps of its wrapper ``ops.block_attention``, which become
the kernel's launch grid (query tile, query head, batch): query head ``h``
reads kv head ``h // g``. For each ``(bq, dh)`` query tile an online
softmax runs over the ``n_sel`` cluster-sorted key tiles named by ``idx``,
causality elementwise (``kpos <= qpos``, masked at ``NEG_INF = -1e30``),
products and sums in float32, the output ``acc / max(l, 1e-30)`` in q's
dtype.

For a tensor on the CPU ``block_attention`` returns its plain version
(``core.clusterkv.sparse_block_attention``, the same arithmetic in
PyTorch); for a CUDA tensor it checks the call and runs the opaque op
``torch.ops.repro_torch.block_attention`` (``kernels/library.py``), whose
``CUDA`` implementation :func:`launch` launches ``csrc/block_attention.cu``,
or raises. It counts its launches in ``block_attention.launches``.

Under grad (grad mode on and q, k or v requiring grad) it runs the
differentiable op ``repro_torch::block_attention_with_stats`` instead: the
same forward, which also writes each row's statistics (m, l), and whose
backward is ``repro_torch::block_attention_backward``. Their ``CUDA``
implementations launch B6's forward (:func:`launch_with_stats`) and the
hand-written backward of ``csrc/block_attention_bwd.cu`` (bf16 at tiles of
128 in ``csrc/block_attention_bwd_sm90.cu``) (:func:`launch_backward`: the
key-tile lists, their order, dQ, dK/dV, counted in
``key_tile_lists.launches``, ``key_tile_order.launches``,
``block_attention_backward.launches``); their
``CPU`` implementations are the plain forward and
:func:`block_attention_backward_plain`, so a CPU train step runs the
algorithm the card runs.
"""
from __future__ import annotations

import torch

from repro_torch import trace
from repro_torch.core.clusterkv import NEG_INF, sparse_block_attention
from repro_torch.kernels import _build
from repro_torch.kernels.library import LIB

# (bq == bk, dh, dv) the CUDA kernel is instantiated for, per dtype: head
# dim 64 at every tile size, 128 (llava-next-34b, mistral-large-123b,
# llama4-maverick) and MLA's q/k 96 with v 64 (minicpm3-4b) at tiles of
# 128; the float32 CUDA-core kernel also at the reduced model's head dim 16
SUPPORTED = {(128, 64, 64), (64, 64, 64), (32, 64, 64), (128, 128, 128),
             (128, 96, 64)}
SUPPORTED_F32 = SUPPORTED | {(32, 16, 16)}
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def block_attention_plain(q, k_sorted, v_sorted, kpos, qpos, idx, *, bq: int,
                          bk: int, causal: bool = True) -> torch.Tensor:
    """Plain version: the online softmax of ``sparse_block_attention``."""
    return sparse_block_attention(q, k_sorted, v_sorted, kpos, qpos, idx,
                                  bq, bk, causal=causal)


def key_tile_lists_plain(idx: torch.Tensor, nkb: int):
    """Plain version of the key-tile lists: for each (b, kv head) the
    transpose of ``idx`` (B,Hkv,nqb,n_sel) as CSR. Returns ``off``
    (B,Hkv,nkb+1) and ``ent`` (B,Hkv,nqb*n_sel), int32: the entries of key
    tile t are ``ent[..., off[t]:off[t+1]]``, the flat positions
    ``qt * n_sel + slot`` that selected it in ascending order (a duplicate
    id once per occurrence), the rest of each row -1. A tile id outside
    ``[0, nkb)`` is listed nowhere, as the forward skips it."""
    b, hkv = idx.shape[:2]
    flat = idx.reshape(b * hkv, -1).long()
    n = flat.shape[1]
    key = torch.where((flat >= 0) & (flat < nkb), flat, nkb)
    order = torch.sort(key, dim=1, stable=True).indices
    counts = torch.zeros((b * hkv, nkb + 1), dtype=torch.long,
                         device=idx.device).scatter_add_(
        1, key, torch.ones_like(key))
    off = torch.nn.functional.pad(counts[:, :nkb].cumsum(1), (1, 0))
    pos = torch.arange(n, device=idx.device)
    ent = torch.where(pos < off[:, -1:], order, -1)
    return (off.to(torch.int32).reshape(b, hkv, nkb + 1),
            ent.to(torch.int32).reshape(b, hkv, n))


def key_tile_order_plain(off: torch.Tensor) -> torch.Tensor:
    """Plain version of the key-tile order: the items ``bh * nkb + t`` of
    the lists' offsets ``off`` (B,Hkv,nkb+1), longest list first, equal
    lengths in index order. Returns (B*Hkv*nkb,) int32. The dK/dV kernel
    numbers its blocks by it, so that the longest walks start first."""
    n = (off[..., 1:] - off[..., :-1]).reshape(-1)
    return torch.sort(n, descending=True, stable=True).indices.to(
        torch.int32)


def block_attention_backward_plain(q, k_sorted, v_sorted, kpos, qpos, idx,
                                   out, stats, dout, bq: int, bk: int,
                                   causal: bool = True):
    """Plain version of B6's backward, and the ``CPU`` implementation of
    ``repro_torch::block_attention_backward`` (the op's argument order):
    (dq, dk, dv) in q's, k's and v's dtypes, by the kernels' formulas.
    ``out`` is the forward's output and ``dout`` its cotangent; ``stats``
    (2,B,Hq,S) the plain forward's row max m and sum l in natural units
    (None: recomputed by the plain forward). With ``p = exp(s - m) / l`` over each selected tile
    (``s = q.k^T / sqrt(dh)``, masked to NEG_INF where ``kpos > qpos``):
    ``D = rowsum(dout o out)``, ``dS = p o (dout.v^T - D)``, zero where the
    mask replaced the logit; ``dq = dS.k / sqrt(dh)``, and each key tile's
    ``dk = dS^T.q / sqrt(dh)`` and ``dv = p^T.dout`` summed over the
    entries of its key-tile list (:func:`key_tile_lists_plain`) in list
    order. Tile ids outside ``[0, S_k/bk)`` are skipped, duplicates count
    twice, as in the forward. Sums in float32 (float64 for float64
    inputs)."""
    b, hq, s, dh = q.shape
    hkv, s_k = k_sorted.shape[1], k_sorted.shape[2]
    dv = v_sorted.shape[3]
    g, nqb, nkb, n_sel = hq // hkv, s // bq, s_k // bk, idx.shape[3]
    wt = torch.promote_types(q.dtype, torch.float32)
    scale = 1.0 / float(dh) ** 0.5
    if stats is None:
        _, m, l = sparse_block_attention(q, k_sorted, v_sorted, kpos, qpos,
                                         idx, bq, bk, causal=causal,
                                         stats=True)
    else:
        m, l = stats[0], stats[1]
    rows = (b, hkv, g, nqb, bq)
    m = m.to(wt).reshape(rows)[..., None]
    inv = 1.0 / torch.clamp_min(l.to(wt).reshape(rows), 1e-30)[..., None]
    qb = q.to(wt).reshape(*rows, dh)
    dob = dout.to(wt).reshape(*rows, dv)
    dd = (dout.to(wt) * out.to(wt)).sum(-1).reshape(rows)[..., None]
    kb = k_sorted.reshape(b, hkv, nkb, bk, dh)
    vb = v_sorted.reshape(b, hkv, nkb, bk, dv)
    pb = kpos.reshape(b, hkv, nkb, bk)
    qp = qpos.reshape(nqb, bq)
    ix = idx.long()
    valid = (ix >= 0) & (ix < nkb)
    ix = ix.clamp(0, nkb - 1)
    bi = torch.arange(b, device=q.device)[:, None, None]
    hi = torch.arange(hkv, device=q.device)[None, :, None]

    dq = torch.zeros((*rows, dh), dtype=wt, device=q.device)
    gk = torch.empty((b, hkv, nqb, n_sel, bk, dh), dtype=wt, device=q.device)
    gv = torch.empty((b, hkv, nqb, n_sel, bk, dv), dtype=wt, device=q.device)
    for j in range(n_sel):
        t = ix[..., j]                                    # (b, hkv, nqb)
        kt, vt = kb[bi, hi, t].to(wt), vb[bi, hi, t].to(wt)
        keep = valid[..., j][:, :, None, :, None, None]
        if causal:
            keep = keep & (pb[bi, hi, t][:, :, None, :, None, :]
                           <= qp[None, None, None, :, :, None])
        logit = torch.einsum("bhgqtd,bhqsd->bhgqts", qb, kt) * scale
        logit = torch.where(keep, logit, NEG_INF)
        p = torch.exp(logit - m) * inv
        # a skipped tile contributes nothing; in a row whose keys are all
        # masked p = 1 / l, which dv receives and dq / dk do not
        p = torch.where(valid[..., j][:, :, None, :, None, None], p, 0.0)
        dp = torch.einsum("bhgqtd,bhqsd->bhgqts", dob, vt)
        ds = torch.where(keep, p * (dp - dd), 0.0)
        dq += torch.einsum("bhgqts,bhqsd->bhgqtd", ds, kt)
        gk[:, :, :, j] = torch.einsum("bhgqts,bhgqtd->bhqsd", ds, qb)
        gv[:, :, :, j] = torch.einsum("bhgqts,bhgqtd->bhqsd", p, dob)
    # each key tile sums the (query tile, slot) entries of its list
    off, ent = key_tile_lists_plain(idx, nkb)
    n = nqb * n_sel
    off, ent = off.reshape(b * hkv, nkb + 1).long(), ent.reshape(b * hkv, n)
    live = ent >= 0
    src = (torch.arange(b * hkv, device=q.device)[:, None] * n
           + ent.long())[live]
    tile = torch.repeat_interleave(
        torch.arange(nkb, device=q.device).repeat(b * hkv),
        (off[:, 1:] - off[:, :-1]).reshape(-1))
    dst = (torch.arange(b * hkv, device=q.device)[:, None] * nkb
           ).expand(b * hkv, n)[live] + tile
    dk = torch.zeros((b * hkv * nkb, bk, dh), dtype=wt, device=q.device)
    dvv = torch.zeros((b * hkv * nkb, bk, dv), dtype=wt, device=q.device)
    dk.index_add_(0, dst, gk.reshape(b * hkv * n, bk, dh)[src])
    dvv.index_add_(0, dst, gv.reshape(b * hkv * n, bk, dv)[src])
    return ((dq * scale).reshape(b, hq, s, dh).to(q.dtype),
            (dk * scale).reshape(b, hkv, s_k, dh).to(k_sorted.dtype),
            dvv.reshape(b, hkv, s_k, dv).to(v_sorted.dtype))


def _check(q, k, v, kpos, qpos, idx, bq, bk):
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(f"expected q (B,Hq,S,dh) and k/v (B,Hkv,S_k,dh); "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, hq, s, dh = q.shape
    hkv, s_k = k.shape[1], k.shape[2]
    if k.shape[0] != b or tuple(v.shape[:3]) != tuple(k.shape[:3]) \
            or k.shape[3] != dh:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if hq % hkv:
        raise ValueError(f"{hq} query heads are not a multiple of {hkv} kv "
                         "heads")
    if s % bq or s_k % bk:
        raise ValueError(f"S={s} / S_k={s_k} are not whole bq={bq} / bk={bk} "
                         "tiles")
    nqb = s // bq
    if tuple(kpos.shape) != (b, hkv, s_k) or tuple(qpos.shape) != (s,) \
            or idx.ndim != 4 or tuple(idx.shape[:3]) != (b, hkv, nqb):
        raise ValueError(
            f"kpos {tuple(kpos.shape)}, qpos {tuple(qpos.shape)}, idx "
            f"{tuple(idx.shape)} do not match (B, Hkv, S_k) = "
            f"{(b, hkv, s_k)}, (S,) and (B, Hkv, S/bq, n_sel)")
    if not (q.device == k.device == v.device == kpos.device == qpos.device
            == idx.device):
        raise ValueError("all tensors must share one device")
    return b, hq, hkv, s, s_k, dh, v.shape[3], idx.shape[3]


def block_attention(q: torch.Tensor, k_sorted: torch.Tensor,
                    v_sorted: torch.Tensor, kpos: torch.Tensor,
                    qpos: torch.Tensor, idx: torch.Tensor, *, bq: int,
                    bk: int, causal: bool = True) -> torch.Tensor:
    """q (B,Hq,S,dh); k/v_sorted (B,Hkv,S_k,dh|dv) in cluster order; kpos
    (B,Hkv,S_k) original positions; qpos (S,); idx (B,Hkv,S/bq,n_sel)
    selected key tiles. Returns (B,Hq,S,dv) in q's dtype.

    ``idx`` is not range-checked here, which would cost a device sync per
    launch: ``core.clusterkv.select_blocks`` builds it in range, and the
    kernel skips a tile id outside ``[0, S_k/bk)`` rather than read past
    the cache."""
    _check(q, k_sorted, v_sorted, kpos, qpos, idx, bq, bk)
    grad = _under_grad(q, k_sorted, v_sorted)
    if q.device.type != "cuda" and not grad:
        return block_attention_plain(q, k_sorted, v_sorted, kpos, qpos, idx,
                                     bq=bq, bk=bk, causal=causal)
    if q.device.type == "cuda":
        _check_card(q, k_sorted, v_sorted, kpos, qpos, idx, bq, bk)
    if grad:
        return torch.ops.repro_torch.block_attention_with_stats(
            q, k_sorted, v_sorted, kpos, qpos, idx, bq, bk, causal)[0]
    return torch.ops.repro_torch.block_attention(
        q, k_sorted, v_sorted, kpos, qpos, idx, bq, bk, causal)


def _check_card(q, k_sorted, v_sorted, kpos, qpos, idx, bq, bk):
    """What the CUDA kernels take on top of ``_check``: a shape they are
    instantiated for, one floating dtype, int32 indices, contiguity."""
    dh, dv = q.shape[3], v_sorted.shape[3]
    shapes = SUPPORTED_F32 if q.dtype == torch.float32 else SUPPORTED
    if bq != bk or (bq, dh, dv) not in shapes:
        raise ValueError(f"the CUDA kernel supports (bq == bk, dh, dv) in "
                         f"{sorted(shapes)} for {q.dtype}, got bq={bq}, "
                         f"bk={bk}, dh={dh}, dv={dv}")
    if q.dtype not in DTYPES or k_sorted.dtype != q.dtype \
            or v_sorted.dtype != q.dtype:
        raise TypeError(f"q/k/v must share one dtype of {list(DTYPES)}; got "
                        f"{q.dtype}/{k_sorted.dtype}/{v_sorted.dtype}")
    for t in (kpos, qpos, idx):
        if t.dtype != torch.int32:
            raise TypeError(f"kpos/qpos/idx must be int32, got {t.dtype}")
    for t in (q, k_sorted, v_sorted, kpos, qpos, idx):
        if not t.is_contiguous():
            raise ValueError("the CUDA kernel needs contiguous tensors")


def _under_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def _forward(q, k_sorted, v_sorted, kpos, qpos, idx, bq, bk, causal,
             with_stats: bool):
    b, hq, s, dh = q.shape
    hkv, s_k, dv = k_sorted.shape[1], k_sorted.shape[2], v_sorted.shape[3]
    out = torch.empty((b, hq, s, dv), dtype=q.dtype, device=q.device)
    stats = (torch.empty((2, b, hq, s), dtype=torch.float32, device=q.device)
             if with_stats else None)
    with torch.cuda.device(q.device):
        code = _build.load().repro_block_attention(
            q.data_ptr(), k_sorted.data_ptr(), v_sorted.data_ptr(),
            kpos.data_ptr(), qpos.data_ptr(), idx.data_ptr(), out.data_ptr(),
            None if stats is None else stats.data_ptr(),
            b, hq, hkv, s, s_k, dh, dv, bq, bk, idx.shape[3], int(causal),
            DTYPES[q.dtype], _build.current_stream())
    _build.check(code, "block_attention")
    block_attention.launches += 1
    return out, stats


def launch(q, k_sorted, v_sorted, kpos, qpos, idx, bq: int, bk: int,
           causal: bool) -> torch.Tensor:
    """The ``CUDA`` implementation of ``repro_torch::block_attention``: one
    launch of ``csrc/block_attention.cu`` on the current stream, on inputs
    ``block_attention`` has checked."""
    return _forward(q, k_sorted, v_sorted, kpos, qpos, idx, bq, bk, causal,
                    False)[0]


def launch_with_stats(q, k_sorted, v_sorted, kpos, qpos, idx, bq: int,
                      bk: int, causal: bool):
    """The ``CUDA`` implementation of
    ``repro_torch::block_attention_with_stats``: the same launch, which
    also writes the rows' statistics (2,B,Hq,S) float32 in the kernel's
    own units (log2 in bf16, natural in float32; the backward kernels read
    them as such)."""
    return _forward(q, k_sorted, v_sorted, kpos, qpos, idx, bq, bk, causal,
                    True)


def _plain_with_stats(q, k_sorted, v_sorted, kpos, qpos, idx, bq: int,
                      bk: int, causal: bool):
    """The ``CPU`` implementation of the same op: the plain forward and its
    row statistics (natural units, in the working dtype)."""
    out, m, l = sparse_block_attention(q, k_sorted, v_sorted, kpos, qpos,
                                       idx, bq, bk, causal=causal,
                                       stats=True)
    return out, torch.stack([m, l])


def key_tile_lists(idx: torch.Tensor, nkb: int):
    """The key-tile lists of ``idx`` (B,Hkv,nqb,n_sel) int32 for ``nkb``
    key tiles: one launch of ``csrc/block_attention_bwd.cu``'s counting
    sort on a CUDA tensor, no host sync; the plain version on a CPU
    tensor. Returns ``(off, ent)`` as :func:`key_tile_lists_plain`."""
    if idx.device.type != "cuda":
        return key_tile_lists_plain(idx, nkb)
    if idx.dtype != torch.int32 or not idx.is_contiguous() or idx.ndim != 4:
        raise ValueError("key_tile_lists needs a contiguous (B, Hkv, nqb, "
                         f"n_sel) int32 idx, got {idx.dtype} "
                         f"{tuple(idx.shape)}")
    b, hkv = idx.shape[:2]
    n = idx.shape[2] * idx.shape[3]
    off = torch.empty((b, hkv, nkb + 1), dtype=torch.int32, device=idx.device)
    ent = torch.empty((b, hkv, n), dtype=torch.int32, device=idx.device)
    with torch.cuda.device(idx.device):
        code = _build.load().repro_key_tile_lists(
            idx.data_ptr(), off.data_ptr(), ent.data_ptr(), b * hkv, n, nkb,
            _build.current_stream())
    _build.check(code, "key_tile_lists")
    key_tile_lists.launches += 1
    return off, ent


def key_tile_order(off: torch.Tensor) -> torch.Tensor:
    """The key-tile order of the lists' offsets ``off`` (B,Hkv,nkb+1)
    int32: one launch of ``csrc/block_attention_bwd.cu``'s ranking kernel
    on a CUDA tensor, no host sync; the plain version on a CPU tensor.
    Returns (B*Hkv*nkb,) int32 as :func:`key_tile_order_plain`."""
    if off.device.type != "cuda":
        return key_tile_order_plain(off)
    if off.dtype != torch.int32 or not off.is_contiguous() or off.ndim != 3:
        raise ValueError("key_tile_order needs contiguous (B, Hkv, nkb + 1) "
                         f"int32 offsets, got {off.dtype} {tuple(off.shape)}")
    bh, nkb = off.shape[0] * off.shape[1], off.shape[2] - 1
    order = torch.empty((bh * nkb,), dtype=torch.int32, device=off.device)
    with torch.cuda.device(off.device):
        code = _build.load().repro_key_tile_order(
            off.data_ptr(), order.data_ptr(), bh, nkb,
            _build.current_stream())
    _build.check(code, "key_tile_order")
    key_tile_order.launches += 1
    return order


def backward_stages(q, k_sorted, v_sorted, kpos, qpos, idx, out, stats,
                    dout, bq: int, bk: int, causal: bool):
    """B6's backward on CUDA tensors as its four launches, each a call of
    no argument, in the order they must first run: ``lists``
    (:func:`key_tile_lists`), ``order`` (:func:`key_tile_order`), ``dq``
    (the dQ kernel, which also writes D) and ``dkv`` (the dK/dV kernel) of
    ``csrc/block_attention_bwd.cu`` (``csrc/block_attention_bwd_sm90.cu``
    in bf16 at tiles of 128), each on the current stream into buffers the
    stages share. Returns ``(stages, (dq, dk, dv))``, the gradients filled
    once every stage ran. A stage may be run again alone (to time it)."""
    b, hq, s, dh = q.shape
    hkv, s_k, dv = k_sorted.shape[1], k_sorted.shape[2], v_sorted.shape[3]
    for name, t, shape, dtype in (
            ("out", out, (b, hq, s, dv), q.dtype),
            ("dout", dout, (b, hq, s, dv), q.dtype),
            ("stats", stats, (2, b, hq, s), torch.float32)):
        if t.dtype != dtype or tuple(t.shape) != shape \
                or not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"{name} must be a contiguous {dtype} tensor of "
                             f"shape {shape} on {q.device}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    dq = torch.empty_like(q)
    dk = torch.empty_like(k_sorted)
    dvt = torch.empty_like(v_sorted)
    # D = rowsum(dout o out), and 1 / l (written by the bf16 dQ kernel at
    # tiles of 128 for its dK/dV kernel)
    dsum = torch.empty((2, b, hq, s), dtype=torch.float32, device=q.device)
    lists = {}
    dims = (b, hq, hkv, s, s_k, dh, dv, bq, bk, idx.shape[3], int(causal),
            DTYPES[q.dtype])

    def run_lists():
        lists["off"], lists["ent"] = key_tile_lists(idx, s_k // bk)

    def run_order():
        lists["order"] = key_tile_order(lists["off"])

    def run_dq():
        with torch.cuda.device(q.device):
            code = _build.load().repro_block_attention_dq(
                q.data_ptr(), k_sorted.data_ptr(), v_sorted.data_ptr(),
                kpos.data_ptr(), qpos.data_ptr(), idx.data_ptr(),
                out.data_ptr(), stats.data_ptr(), dout.data_ptr(),
                dq.data_ptr(), dsum.data_ptr(), *dims,
                _build.current_stream())
        _build.check(code, "block_attention backward (dQ)")

    def run_dkv():
        with torch.cuda.device(q.device):
            code = _build.load().repro_block_attention_dkv(
                q.data_ptr(), k_sorted.data_ptr(), v_sorted.data_ptr(),
                kpos.data_ptr(), qpos.data_ptr(), stats.data_ptr(),
                dsum.data_ptr(), dout.data_ptr(), lists["off"].data_ptr(),
                lists["ent"].data_ptr(), lists["order"].data_ptr(),
                dk.data_ptr(), dvt.data_ptr(), *dims,
                _build.current_stream())
        _build.check(code, "block_attention backward (dK/dV)")

    return ({"lists": run_lists, "order": run_order, "dq": run_dq,
             "dkv": run_dkv}, (dq, dk, dvt))


def logits_two_ways(q: torch.Tensor, k: torch.Tensor):
    """A check of the backward's recomputation, not a path's launch: S =
    q.k^T of one tile pair, ``q`` and ``k`` (128, 64) contiguous bf16 on a
    card, by the forward's ``mma.sync`` in its order and by the backward's
    ``wgmma`` from the same shared tiles. Returns ``(s_mma, s_wgmma)``,
    (128, 128) float32 each."""
    if q.device.type != "cuda" or q.dtype != torch.bfloat16 \
            or tuple(q.shape) != (128, 64) or tuple(k.shape) != (128, 64) \
            or k.dtype != q.dtype or not (q.is_contiguous()
                                          and k.is_contiguous()):
        raise ValueError("logits_two_ways takes two contiguous (128, 64) "
                         "bf16 tiles on a card")
    s_mma = torch.empty((128, 128), dtype=torch.float32, device=q.device)
    s_wgmma = torch.empty_like(s_mma)
    with torch.cuda.device(q.device):
        code = _build.load().repro_b6_logits_two_ways(
            q.data_ptr(), k.data_ptr(), s_mma.data_ptr(), s_wgmma.data_ptr(),
            _build.current_stream())
    _build.check(code, "logits_two_ways")
    return s_mma, s_wgmma


def launch_backward(q, k_sorted, v_sorted, kpos, qpos, idx, out, stats,
                    dout, bq: int, bk: int, causal: bool):
    """The ``CUDA`` implementation of ``repro_torch::block_attention_backward``:
    the four launches of :func:`backward_stages` in turn, from the
    forward's inputs, its output, its statistics and the cotangent
    ``dout``, no host sync. Returns (dq, dk, dv) in the inputs' dtype."""
    with trace.span("b6.backward"):
        stages, grads = backward_stages(q, k_sorted, v_sorted, kpos, qpos,
                                        idx, out, stats, dout, bq, bk, causal)
        for run in stages.values():
            run()
    block_attention_backward.launches += 1
    return grads


def block_attention_backward(q, k_sorted, v_sorted, kpos, qpos, idx, out,
                             stats, dout, *, bq: int, bk: int,
                             causal: bool = True):
    """B6's backward through ``repro_torch::block_attention_backward``:
    the hand-written kernels on CUDA tensors (``stats`` the CUDA forward's,
    :func:`launch_with_stats`), the plain version on CPU tensors (``stats``
    the plain forward's). ``block_attention`` under grad reaches it
    through autograd; a direct call is for comparing the kernels with
    their plain version."""
    _check(q, k_sorted, v_sorted, kpos, qpos, idx, bq, bk)
    if q.device.type == "cuda":
        _check_card(q, k_sorted, v_sorted, kpos, qpos, idx, bq, bk)
    return torch.ops.repro_torch.block_attention_backward(
        q, k_sorted, v_sorted, kpos, qpos, idx, out, stats, dout, bq, bk,
        causal)


def _fake(q, k_sorted, v_sorted, kpos, qpos, idx, bq: int, bk: int,
          causal: bool) -> torch.Tensor:
    """The output's shape, dtype and device; no data is read."""
    b, hq, s, _ = q.shape
    return q.new_empty((b, hq, s, v_sorted.shape[3]))


def _fake_with_stats(q, k_sorted, v_sorted, kpos, qpos, idx, bq: int,
                     bk: int, causal: bool):
    b, hq, s, _ = q.shape
    return (q.new_empty((b, hq, s, v_sorted.shape[3])),
            q.new_empty((2, b, hq, s),
                        dtype=torch.promote_types(q.dtype, torch.float32)))


def _fake_backward(q, k_sorted, v_sorted, kpos, qpos, idx, out, stats, dout,
                   bq: int, bk: int, causal: bool):
    return (torch.empty_like(q), torch.empty_like(k_sorted),
            torch.empty_like(v_sorted))


def _setup_context(ctx, inputs, output):
    q, k_sorted, v_sorted, kpos, qpos, idx, bq, bk, causal = inputs
    out, stats = output
    ctx.save_for_backward(q, k_sorted, v_sorted, kpos, qpos, idx, out, stats)
    ctx.tiles = (bq, bk, causal)


def _backward(ctx, dout, _dstats):
    q, k_sorted, v_sorted, kpos, qpos, idx, out, stats = ctx.saved_tensors
    bq, bk, causal = ctx.tiles
    dq, dk, dv = torch.ops.repro_torch.block_attention_backward(
        q, k_sorted, v_sorted, kpos, qpos, idx, out, stats,
        dout.contiguous(), bq, bk, causal)
    return dq, dk, dv, None, None, None, None, None, None


block_attention.launches = 0
key_tile_lists.launches = 0
key_tile_order.launches = 0
block_attention_backward.launches = 0
LIB.impl("block_attention", launch, "CUDA")
LIB.impl("block_attention_with_stats", launch_with_stats, "CUDA")
LIB.impl("block_attention_with_stats", _plain_with_stats, "CPU")
LIB.impl("block_attention_backward", launch_backward, "CUDA")
LIB.impl("block_attention_backward", block_attention_backward_plain,
         "CPU")
torch.library.register_fake("repro_torch::block_attention", _fake, lib=LIB)
torch.library.register_fake("repro_torch::block_attention_with_stats",
                            _fake_with_stats, lib=LIB)
torch.library.register_fake("repro_torch::block_attention_backward",
                            _fake_backward, lib=LIB)
torch.library.register_autograd("repro_torch::block_attention_with_stats",
                                _backward, setup_context=_setup_context,
                                lib=LIB)
