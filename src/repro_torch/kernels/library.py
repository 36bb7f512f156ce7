"""The ``repro_torch`` operator library: B5, B6 and ClusterKV's key
ordering as opaque PyTorch ops.

``torch.ops.repro_torch.block_attention`` (B6),
``torch.ops.repro_torch.decode_attend`` (B5) and
``torch.ops.repro_torch.cluster_codes`` (each key set's embedding and
Morton codes) are defined here through
``torch.library.Library(..., "DEF")``, with B6's differentiable form
``block_attention_with_stats`` (output and row statistics) and its
backward ``block_attention_backward``; their ``CUDA`` implementations,
the ctypes launches, are registered by ``kernels/block_attention.py``,
``kernels/decode_attend.py`` and ``kernels/cluster_order.py`` beside their
fake implementations (output shape, dtype and device, no data read), B6's
two training ops also with ``CPU`` implementations (the plain versions)
and the autograd formula that joins them. The wrappers of
``kernels/ops.py`` reach the kernels only through these ops, so a trace under
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
LIB.define("block_attention_with_stats(Tensor q, Tensor k, Tensor v, "
           "Tensor kpos, Tensor qpos, Tensor idx, int bq, int bk, "
           "bool causal) -> (Tensor, Tensor)")
LIB.define("block_attention_backward(Tensor q, Tensor k, Tensor v, "
           "Tensor kpos, Tensor qpos, Tensor idx, Tensor out, Tensor stats, "
           "Tensor dout, int bq, int bk, bool causal) "
           "-> (Tensor, Tensor, Tensor)")
LIB.define("decode_attend(Tensor q, Tensor k, Tensor v, Tensor pos, "
           "Tensor cent, Tensor qpos, Tensor? k_self, Tensor? v_self, "
           "Tensor(a!)? sel_out, int n_sel, int bk, bool plan_mode, "
           "bool use_self, int window) -> Tensor")
LIB.define("cluster_codes(Tensor k, int d, int bits, int iters) -> Tensor")


def block_attention_flops(q, k, v, kpos, qpos, idx, bq: int, bk: int,
                          causal: bool, *, out_shape=None) -> int:
    """B6: ``2 bq bk (dh + dv)`` operations per selected (query tile, key
    tile) pair, ``B x Hq x S/bq x n_sel`` pairs (q (B,Hq,S,dh), v
    (B,Hkv,S_k,dv), idx (B,Hkv,S/bq,n_sel)); causally masked pairs are
    computed whole, as the kernel does."""
    b, hq, s, dh = q
    dv = v[3]
    return 2 * bq * bk * (dh + dv) * b * hq * (s // bq) * idx[3]


def block_attention_backward_flops(q, k, v, kpos, qpos, idx, out, stats,
                                   dout, bq: int, bk: int, causal: bool, *,
                                   out_shape=None) -> int:
    """B6's backward: per selected (query tile, key tile) pair
    ``2 bq bk (2 dh + dv)`` in the dQ kernel (S, dP, dQ) and
    ``2 bq bk (2 dh + 2 dv)`` in the dK/dV kernel (S, dP, dV, dK), over the
    forward's ``B x Hq x S/bq x n_sel`` pairs (the bf16 kernels run the
    products of p and dS twice, as hi + lo, which is not counted)."""
    b, hq, s, dh = q
    dv = v[3]
    pairs = b * hq * (s // bq) * idx[3]
    return 2 * bq * bk * ((2 * dh + dv) + (2 * dh + 2 * dv)) * pairs


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


def cluster_codes_flops(k, d: int, bits: int, iters: int, *,
                        out_shape=None) -> int:
    """ClusterKV's key ordering: ``2 S dh x 3`` operations for each product
    with the keys (the kernel takes three columns for every d <= 3), two a
    sweep and one for the projection, a (A, B, S, dh) set; the mean, the
    QR of each (dh, 3) sweep and the codes are not counted (at d = 3 the
    plain version's matrix products alone)."""
    a, b, s, dh = k
    return 2 * s * dh * 3 * (2 * iters + 1) * a * b


register_flop_formula(torch.ops.repro_torch.block_attention)(
    block_attention_flops)
register_flop_formula(torch.ops.repro_torch.block_attention_with_stats)(
    block_attention_flops)
register_flop_formula(torch.ops.repro_torch.block_attention_backward)(
    block_attention_backward_flops)
register_flop_formula(torch.ops.repro_torch.decode_attend)(
    decode_attend_flops)
register_flop_formula(torch.ops.repro_torch.cluster_codes)(
    cluster_codes_flops)
