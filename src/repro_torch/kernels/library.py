"""The ``repro_torch`` operator library: B5 and B6 as opaque PyTorch ops.

``torch.ops.repro_torch.block_attention`` (B6) and
``torch.ops.repro_torch.decode_attend`` (B5) are defined here through
``torch.library.Library(..., "DEF")``; their ``CUDA`` implementations,
the ctypes launches, are registered by ``kernels/block_attention.py`` and
``kernels/decode_attend.py`` beside their fake implementations (output
shape, dtype and device, no data read). The wrappers of ``kernels/ops.py``
reach the kernels only through these ops, so a trace under
``FakeTensorMode`` (``launch/dryrun.py``) passes through them as single
ops without touching ``data_ptr()``, and ``FlopCounterMode`` counts them
by the formulas below: the kernels' own operation counts, the ones the
bounds of ``chip_smoke.py`` use.

Defining the ops builds nothing and needs no device.
"""
from __future__ import annotations

import torch
from torch.utils.flop_counter import register_flop_formula

LIB = torch.library.Library("repro_torch", "DEF")
LIB.define("block_attention(Tensor q, Tensor k, Tensor v, Tensor kpos, "
           "Tensor qpos, Tensor idx, int bq, int bk, bool causal) -> Tensor")
LIB.define("decode_attend(Tensor q, Tensor k, Tensor v, Tensor pos, "
           "Tensor cent, Tensor qpos, Tensor? k_self, Tensor? v_self, "
           "Tensor(a!)? sel_out, int n_sel, int bk, bool plan_mode, "
           "bool use_self, int window) -> Tensor")


def block_attention_flops(q, k, v, kpos, qpos, idx, bq: int, bk: int,
                          causal: bool, *, out_shape=None) -> int:
    """B6: ``2 bq bk (dh + dv)`` operations per selected (query tile, key
    tile) pair, ``B x Hq x S/bq x n_sel`` pairs (q (B,Hq,S,dh), v
    (B,Hkv,S_k,dv), idx (B,Hkv,S/bq,n_sel)); causally masked pairs are
    computed whole, as the kernel does."""
    b, hq, s, dh = q
    dv = v[3]
    return 2 * bq * bk * (dh + dv) * b * hq * (s // bq) * idx[3]


def decode_attend_flops(q, k, v, pos, cent, qpos, k_self, v_self, sel_out,
                        n_sel: int, bk: int, plan_mode: bool, use_self: bool,
                        window: int, *, out_shape=None) -> int:
    """B5: the group-mean query scored against every centroid (``2 dh``
    each) plus ``2 (dh + dv)`` operations per query row and selected key
    entry (and the self column in plan mode). q (B,Hkv,g,dh), k
    (B,Hkv,S,dh), v (B,Hkv,S,dv), cent (B,Hkv,S/bk,dh)."""
    b, hkv, g, dh = q
    dv = v[3]
    scores = 2 * dh * b * hkv * cent[2]
    keys = n_sel * bk + (1 if plan_mode and use_self else 0)
    return scores + 2 * (dh + dv) * b * hkv * g * keys


register_flop_formula(torch.ops.repro_torch.block_attention)(
    block_attention_flops)
register_flop_formula(torch.ops.repro_torch.decode_attend)(
    decode_attend_flops)
