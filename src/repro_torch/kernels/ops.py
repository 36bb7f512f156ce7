"""Public wrappers for the CUDA kernels and the ``cuda`` registry backends.

On a CUDA tensor the wrappers launch the hand-written kernels
(``csrc/*.cu``, built at first use); on a CPU tensor they return the
kernels' plain PyTorch versions. The wrappers handle ``(n,)`` vs
``(n, f)`` charges, padding of the charges to the plan's full column-block
range, float32/int32 casts and slicing back to the charge length. They take
the plan's ``nbr_mask``: the kernel walks only the kept slots of each row
block and reads no masked tile (``nbr_mask=None`` keeps every slot). It
needs no tile-size arguments: one thread block per (member, row block)
loops the kept slots, through a ``cp.async`` shared-memory ring with a
register tile per thread for f > 1, and reads each kept tile once. The
plan-path backends (``cuda`` and its batched form) launch without the
per-call ``col_idx`` range check, whose host sync would stall every
``matvec``: a plan's indices are made in range where they are built.

The attention wrappers (``block_attention``, ``decode_attend_fused`` and
the ``cuda`` decode backend) take the batched layouts of the reference's
``ops.py`` and cast positions and indices to int32; the kernel modules
they call count the launches.

None of the kernels has a backward, in this package or in the reference
(whose ``jax.grad`` through a Pallas kernel raises), so a wrapper about to
launch one raises ``NotImplementedError`` when grad mode is on and an input
requires grad (ROADMAP C40), rather than return an output whose gradient
would be dropped. On a CPU tensor the plain version runs, and autograd
differentiates it.
"""
from __future__ import annotations

import torch

from repro_torch._device import DeviceLike, device_of, from_numpy
from repro_torch.core.interact import _pad_rows
from repro_torch.core.registry import (register_backend,
                                       register_batched_backend,
                                       register_decode_backend)
from repro_torch.kernels import block_attention as _ba
from repro_torch.kernels import bsr_spmv as _bsr
from repro_torch.kernels import decode_attend as _da
from repro_torch.kernels import gamma_score as _gs
from repro_torch.kernels import tsne_force as _tf


def _launches_kernel(t: torch.Tensor) -> bool:
    """Whether a wrapper given ``t`` launches its CUDA kernel (on the CPU
    it takes the plain version)."""
    return t.device.type == "cuda"


def _no_backward(kernel: str, *inputs) -> None:
    """C40: raise if ``kernel`` would launch with grad mode on and an input
    that requires grad."""
    if not torch.is_grad_enabled():
        return
    for t in inputs:
        if isinstance(t, torch.Tensor) and t.requires_grad \
                and _launches_kernel(t):
            raise NotImplementedError(
                f"{kernel} has no backward: neither the port's CUDA kernel "
                "nor the reference's Pallas kernel defines one (ROADMAP "
                "C40). Call it under torch.no_grad() or with inputs that "
                "do not require grad; on the CPU its plain version "
                "differentiates")


@register_backend("cuda")
def _cuda_backend(plan, x: torch.Tensor, **_kw) -> torch.Tensor:
    """InteractionPlan SpMV via the CUDA kernel (batched kernel at B=1).
    Handles (n,) and (n, f) charges and capacity-padded plans — dead-slot
    rows carry zero tiles and stay zero in the output."""
    b = plan.bsr
    y = bsr_spmv_batched(b.vals[None], b.col_idx[None], x[None],
                         shape_key=plan.spec.shape_key,
                         nbr_mask=b.nbr_mask[None], indices_checked=True)[0]
    return y[:plan.n]


@register_batched_backend("cuda")
def _cuda_batched(spec, data, xs: torch.Tensor) -> torch.Tensor:
    """Stacked-plan SpMV: the whole batch in ONE kernel launch."""
    return bsr_spmv_batched(data.vals, data.col_idx, xs,
                            shape_key=spec.shape_key,
                            nbr_mask=data.nbr_mask, indices_checked=True)


def _mask(nbr_mask: torch.Tensor | None) -> torch.Tensor | None:
    return None if nbr_mask is None else nbr_mask.contiguous()


def bsr_spmv(vals: torch.Tensor, col_idx: torch.Tensor, x: torch.Tensor,
             n: int | None = None,
             nbr_mask: torch.Tensor | None = None) -> torch.Tensor:
    """ELL-BSR SpMV/SpMM. x (n,) or (n, f); returns same leading length.
    ``nbr_mask`` (n_rb, nbr) bool marks the kept slots (None: all)."""
    _no_backward("bsr_spmv (B2)", vals, x)
    n_rb, nbr, bs, _ = vals.shape
    squeeze = x.ndim == 1
    if squeeze:
        x = x[:, None]
    x = _pad_rows(x, n_rb * bs)
    y = _bsr.bsr_spmv(vals.to(torch.float32).contiguous(),
                      col_idx.to(torch.int32).contiguous(),
                      x.to(torch.float32).contiguous(), _mask(nbr_mask))
    if n is not None:
        y = y[:n]
    return y[:, 0] if squeeze else y


def bsr_spmv_batched(vals: torch.Tensor, col_idx: torch.Tensor,
                     xs: torch.Tensor, shape_key: tuple | None = None,
                     nbr_mask: torch.Tensor | None = None, *,
                     indices_checked: bool = False) -> torch.Tensor:
    """Batched ELL-BSR SpMV/SpMM.

    vals (B, n_rb, nbr, bs, bs); xs (B, n) or (B, n, f); returns the same
    leading charge length as the plain batched backends (sliced to n).
    ``shape_key`` (``PlanSpec.shape_key``) names the plan's column-block
    count, which may exceed the live charge length on capacity-padded
    plans. ``nbr_mask`` (B, n_rb, nbr) bool marks the kept slots (None:
    all). ``indices_checked=True`` (a plan's own storage) launches without
    the range check of ``col_idx`` and its host sync.
    """
    _no_backward("bsr_spmv_batched (B1)", vals, xs)
    B, n_rb, nbr, bs, _ = vals.shape
    squeeze = xs.ndim == 2
    if squeeze:
        xs = xs[..., None]
    n = xs.shape[1]
    n_cb = max((n + bs - 1) // bs,
               shape_key[4] if shape_key is not None else 0)
    xs = _pad_rows(xs, n_cb * bs, axis=1)
    y = _bsr.bsr_spmv_batched(vals.to(torch.float32).contiguous(),
                              col_idx.to(torch.int32).contiguous(),
                              xs.to(torch.float32).contiguous(),
                              _mask(nbr_mask),
                              indices_checked=indices_checked)
    y = y[:, :n]
    return y[..., 0] if squeeze else y


def tsne_force(p_vals: torch.Tensor, col_idx: torch.Tensor, y: torch.Tensor,
               n: int | None = None, nbr_mask: torch.Tensor | None = None,
               *, indices_checked: bool = False) -> torch.Tensor:
    """Blockwise t-SNE attractive force via the CUDA kernel: pads ``y``
    (n, d) to whole row blocks, casts to float32/int32 and slices the
    force back to ``n`` rows. The kernel needs no tile-size argument: each
    warp walks the kept slots of its row block. ``nbr_mask`` (n_rb, nbr)
    bool marks the kept slots (None: all); ``indices_checked=True`` (a
    plan's own storage) launches without the range check of ``col_idx``
    and its host sync."""
    _no_backward("tsne_force (B4)", p_vals, y)
    n_rb, nbr, bs, _ = p_vals.shape
    yp = _pad_rows(y, n_rb * bs)
    f = _tf.tsne_force(p_vals.to(torch.float32).contiguous(),
                       col_idx.to(torch.int32).contiguous(),
                       yp.to(torch.float32).contiguous(), _mask(nbr_mask),
                       indices_checked=indices_checked)
    return f[:n] if n is not None else f


def gamma_exact(rows, cols, sigma: float, bn: int = 256, weights=None,
                device: DeviceLike = None) -> torch.Tensor:
    """Exact Eq. 4 via the tiled kernel.

    Pads the coordinate list to a tile multiple with zero-weight entries
    (exactly inert) and exploits pair symmetry to skip the upper tile
    triangle. ``weights`` supports weighted patterns (tombstoned entries
    carry weight 0). ``rows``/``cols`` may be numpy arrays or tensors; the
    sum runs on ``device`` (a tensor's own device when ``device`` is None).
    """
    dev = device_of(rows, device)
    r = from_numpy(rows, dev, torch.float32)
    c = from_numpy(cols, dev, torch.float32)
    nnz = r.shape[0]
    coords = torch.stack([r, c], 1)
    w = (torch.ones(nnz, dtype=torch.float32, device=dev) if weights is None
         else from_numpy(weights, dev, torch.float32))
    _no_backward("gamma_pairs (B3)", coords, w)
    pad = (-nnz) % bn
    coords = _pad_rows(coords, nnz + pad).contiguous()
    w = _pad_rows(w, nnz + pad).contiguous()
    total = _gs.gamma_pairs(coords, float(sigma), bn, weights=w,
                            symmetric=True)
    denom = float(nnz) if weights is None else w.sum()
    return total / (float(sigma) * denom)


def _i32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int32).contiguous()


def block_attention(q, k_sorted, v_sorted, kpos, qpos, idx, *, bq, bk,
                    causal=True) -> torch.Tensor:
    """Batched cluster-block-sparse attention.

    q (B,Hq,S,dh); k/v_sorted (B,Hkv,S,dh|dv); kpos (B,Hkv,S); qpos (S,);
    idx (B,Hkv,nqb,n_sel). GQA: q heads grouped onto kv heads, one kernel
    launch for every (query tile, query head, batch member)."""
    _no_backward("block_attention (B6)", q, k_sorted, v_sorted)
    return _ba.block_attention(q.contiguous(), k_sorted.contiguous(),
                               v_sorted.contiguous(), _i32(kpos), _i32(qpos),
                               _i32(idx), bq=bq, bk=bk, causal=causal)


def decode_attend_fused(q, k, v, pos, cent, qpos, *, n_sel, bk):
    """Fused single-token cluster decode over plain (time-ordered) caches:
    ``core.clusterkv.decode_select`` + ``decode_attend`` in one kernel.
    q (B,Hq,dh); k/v (B,Hkv,S,dh|dv); pos (B,Hkv,S); cent (B,Hkv,S/bk,dh);
    qpos scalar or (B,)."""
    _no_backward("decode_attend_fused (B5)", q, k, v, cent)
    return _da.decode_attend_fused(q, k.contiguous(), v.contiguous(),
                                   _i32(pos), cent, qpos, n_sel=n_sel, bk=bk)


@register_decode_backend("cuda")
def _cuda_plan_decode(q, ks, vs, ps, cent, qpos, cfg, *, k_self=None,
                      v_self=None):
    """Plan-ordered decode attend via the fused CUDA kernel (the counterpart
    of the reference's ``pallas`` decode backend).

    Same contract as the ``plain`` decode backend
    (``core.clusterkv.plan_decode_plain``): hole tiles masked out of
    selection, local-window recency boost, optional always-visible self
    column. On a CPU tensor it takes that plain version."""
    _no_backward("decode_attend_fused (B5)", q, ks, vs, cent, k_self, v_self)
    s = ks.shape[2]
    bk = min(cfg.block_k, s)
    has_self = k_self is not None
    return _da.decode_attend_fused(
        q, ks.contiguous(), vs.contiguous(), _i32(ps), cent, qpos, k_self,
        v_self, n_sel=min(cfg.decode_clusters, s // bk), bk=bk,
        plan_mode=True, has_self=has_self,
        window=cfg.local_window_blocks * bk)
