"""Single-token cluster decode attention: the hand-written CUDA kernels and
their plain version.

Counterpart of the reference's ``kernels/decode_attend.py`` (Pallas, TPU),
which runs the whole decode chain in one program per (batch member, kv
head): centroid scoring of the group-mean query -> (plan mode) hole/future
masks, the ``+1e4`` recency boost and the optional always-visible self
column -> ``n_sel`` rounds of first-argmax with mask-out (ties to the
lowest index) -> the selected tiles read straight from the caches -> one
guarded softmax (``masked_softmax``) -> a ``(g, dv)`` output. Two static
contracts:

* plain mode (``plan_mode=False``): ``core.clusterkv.decode_select`` +
  ``decode_attend`` over time-ordered caches;
* plan mode (``plan_mode=True``): ``core.clusterkv.plan_decode_plain``
  (the reference's ``_plan_decode_xla``) over plan-ordered caches.

Those are the plain version. For a tensor on the CPU
``decode_attend_fused`` returns it; for a CUDA tensor it runs
``csrc/decode_attend.cu`` or raises: three launches on the current stream
(selection per (member, kv head); one block per (member, kv head, selected
tile) plus one for the self column, each writing a partial softmax; their
fixed-order combine), into one scratch buffer for the partials and the
selection that the wrapper allocates. q and the centroids go in as they
come (float32 or bfloat16) and the output comes out in q's dtype, so the
call adds no casts around the launches. It counts one launch per call in
``decode_attend_fused.launches`` and, per contract, in
``decode_attend_fused.plain_mode_launches`` or ``plan_mode_launches``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import clusterkv as ckv
from repro_torch.kernels import _build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def decode_attend_plain(q, k, v, pos, cent, qpos, k_self=None, v_self=None,
                        *, n_sel: int, bk: int, plan_mode: bool = False,
                        has_self: bool = False, window: int = 0
                        ) -> torch.Tensor:
    """Plain version of both contracts (see the module docstring)."""
    if not plan_mode:
        idx = ckv.decode_select(q.float(), cent.float(), n_sel)
        return ckv.decode_attend(q, k, v, pos, qpos, idx, bk)
    return ckv.plan_decode_plain(q, k, v, pos, cent, qpos, n_sel=n_sel, bk=bk,
                                 window=window,
                                 k_self=k_self if has_self else None,
                                 v_self=v_self if has_self else None)


def decode_attend_fused(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        pos: torch.Tensor, cent: torch.Tensor, qpos,
                        k_self: Optional[torch.Tensor] = None,
                        v_self: Optional[torch.Tensor] = None, *,
                        n_sel: int, bk: int, plan_mode: bool = False,
                        has_self: bool = False, window: int = 0,
                        sel_out: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Select + gather + attend. q (B,Hq,dh); k/v (B,Hkv,S,dh|dv);
    pos (B,Hkv,S) int32; cent (B,Hkv,S/bk,dh); qpos scalar or (B,);
    k_self/v_self (B,Hkv,dh|dv), read only when ``plan_mode`` and
    ``has_self``. Returns (B,Hq,dv) in q's dtype. ``sel_out`` (B,Hkv,n_sel)
    int32, on a CUDA tensor only, receives the kernel's tile selection."""
    b, hq, dh = q.shape
    hkv, s = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    nkb = s // bk
    if s % bk or nkb < n_sel:
        raise ValueError(f"cache length {s} needs {n_sel} whole {bk}-tiles")
    if hq % hkv:
        raise ValueError(f"{hq} query heads are not a multiple of {hkv} kv "
                         "heads")
    g = hq // hkv
    if tuple(v.shape[:3]) != (b, hkv, s) or tuple(k.shape) != (b, hkv, s, dh) \
            or tuple(pos.shape) != (b, hkv, s) \
            or tuple(cent.shape) != (b, hkv, nkb, dh):
        raise ValueError(
            f"k {tuple(k.shape)}, v {tuple(v.shape)}, pos {tuple(pos.shape)}, "
            f"cent {tuple(cent.shape)} do not match q {tuple(q.shape)} with "
            f"bk={bk}")
    if plan_mode and has_self and (k_self is None or v_self is None):
        raise ValueError("has_self needs k_self and v_self")
    if q.device.type != "cuda":
        return decode_attend_plain(q, k, v, pos, cent, qpos, k_self, v_self,
                                   n_sel=n_sel, bk=bk, plan_mode=plan_mode,
                                   has_self=has_self, window=window)
    if k.dtype not in DTYPES or v.dtype != k.dtype:
        raise TypeError(f"k/v must share one dtype of {list(DTYPES)}; got "
                        f"{k.dtype}/{v.dtype}")
    if pos.dtype != torch.int32:
        raise TypeError(f"pos must be int32, got {pos.dtype}")
    for t in (k, v, pos):
        if not t.is_contiguous():
            raise ValueError("the CUDA kernel needs contiguous caches")
    dev = q.device
    # q and the centroids in their own dtype where the kernels read it
    qk = q if q.dtype in DTYPES else q.float()
    qk = qk.reshape(b, hkv, g, dh).contiguous()
    ck = (cent if cent.dtype in DTYPES else cent.float()).contiguous()
    qp = torch.as_tensor(qpos, device=dev).to(torch.int32).reshape(-1)
    qp = qp.expand(b).contiguous()
    use_self = bool(plan_mode and has_self)
    ks = k_self.float().contiguous() if use_self else None
    vs = v_self.float().contiguous() if use_self else None
    if sel_out is not None and (tuple(sel_out.shape) != (b, hkv, n_sel)
                                or sel_out.dtype != torch.int32
                                or not sel_out.is_contiguous()):
        raise ValueError("sel_out must be a contiguous (B, Hkv, n_sel) int32 "
                         "tensor")
    out = torch.empty((b, hq, dv), dtype=qk.dtype, device=dev)
    # per (member, kv head, part, query row): max, live sum, (dv,) sums;
    # then the selection as int32, unless it goes to sel_out
    scratch = torch.empty(
        b * hkv * ((n_sel + use_self) * g * (dv + 2)
                   + (n_sel if sel_out is None else 0)),
        dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        code = _build.load().repro_decode_attend(
            qk.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
            ck.data_ptr(), qp.data_ptr(),
            None if ks is None else ks.data_ptr(),
            None if vs is None else vs.data_ptr(), out.data_ptr(),
            None if sel_out is None else sel_out.data_ptr(),
            scratch.data_ptr(),
            b, hkv, g, s, dh, dv, bk, n_sel, int(plan_mode), int(use_self),
            int(window), DTYPES[k.dtype], DTYPES[qk.dtype], DTYPES[ck.dtype],
            _build.current_stream())
    _build.check(code, "decode_attend_fused")
    decode_attend_fused.launches += 1
    if plan_mode:
        decode_attend_fused.plan_mode_launches += 1
    else:
        decode_attend_fused.plain_mode_launches += 1
    return out if out.dtype == q.dtype else out.to(q.dtype)


decode_attend_fused.launches = 0
decode_attend_fused.plain_mode_launches = 0
decode_attend_fused.plan_mode_launches = 0
