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
PyTorch); for a CUDA tensor it launches ``csrc/block_attention.cu`` or
raises. It counts its launches in ``block_attention.launches``.
"""
from __future__ import annotations

import torch

from repro_torch.core.clusterkv import sparse_block_attention
from repro_torch.kernels import _build

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
    b, hq, hkv, s, s_k, dh, dv, n_sel = _check(q, k_sorted, v_sorted, kpos,
                                               qpos, idx, bq, bk)
    if q.device.type != "cuda":
        return block_attention_plain(q, k_sorted, v_sorted, kpos, qpos, idx,
                                     bq=bq, bk=bk, causal=causal)
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
    out = torch.empty((b, hq, s, dv), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        code = _build.load().repro_block_attention(
            q.data_ptr(), k_sorted.data_ptr(), v_sorted.data_ptr(),
            kpos.data_ptr(), qpos.data_ptr(), idx.data_ptr(), out.data_ptr(),
            b, hq, hkv, s, s_k, dh, dv, bq, bk, n_sel, int(causal),
            DTYPES[q.dtype], _build.current_stream())
    _build.check(code, "block_attention")
    block_attention.launches += 1
    return out


block_attention.launches = 0
