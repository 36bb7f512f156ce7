"""The yardstick's arithmetic: peaks of the card, the operations and bytes
of the kernels the cells time, and the model FLOPs of a training step.

Frozen here so that a change to the program cannot move its own bounds.
The kernel counts are ``PERF.md`` section 6's; the model FLOPs are the
closed forms of the program's ``launch/analytic.py``, priced at the
published peak instead of the program's hardware knobs, over the
parameter counts and attention sizes of the configuration's architecture
(``archs/<architecture>.py``).
"""
from __future__ import annotations

from typing import Any, Dict

from perfbench.harness import registry

# NVIDIA H100 SXM, the data sheet's dense rates at 700 W
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def b1_bytes(kept_tiles: int, bs: int, n_rb: int, max_nbr: int, n: int,
             f: int) -> int:
    """B1 (``bsr_spmv``) reads each kept float32 tile, the int32 column
    table, the charges and writes the result once."""
    return kept_tiles * bs * bs * 4 + n_rb * max_nbr * 4 + 2 * n * f * 4


def b1_bound_s(kept_tiles: int, bs: int, n_rb: int, max_nbr: int, n: int,
               f: int) -> float:
    return b1_bytes(kept_tiles, bs, n_rb, max_nbr, n, f) / PEAK_HBM_BYTES


def b6_fwd_flops(pairs: int, bq: int, bk: int, dh: int, dv: int) -> float:
    """B6's forward: S = Q K^T and O = P V on every selected tile pair."""
    return 2.0 * bq * bk * (dh + dv) * pairs


def b6_bwd_flops(pairs: int, bq: int, bk: int, dh: int, dv: int) -> float:
    """What B6's gradient needs on every selected pair: S, dP, dV, dK, dQ
    once each (the recomputations the kernels make are not counted)."""
    return 2.0 * bq * bk * (3 * dh + 2 * dv) * pairs


def attention_pairs_flops(m: Dict[str, Any], seq: int) -> float:
    """Forward attention FLOPs of one layer and one sequence through
    ClusterKV, as ``launch/analytic.py`` counts them: every query against
    ``min(blocks_per_query * block_k, seq)`` keys (the selected tiles,
    masked entries included), plus the centroid scores."""
    ck = m["clusterkv"]
    h, dqk, dv = registry.arch(m["architecture"]).attention_dims(m)
    kv_per_q = min(ck["blocks_per_query"] * ck["block_k"], seq)
    nqb = max(seq // ck["block_q"], 1)
    nkb = max(seq // ck["block_k"], 1)
    return (2.0 * h * seq * kv_per_q * (dqk + dv)
            + 2.0 * h * nqb * nkb * dqk)


def model_flops_per_step(m: Dict[str, Any], batch: int, seq: int) -> float:
    """Model FLOPs of one training step: 6 x (every parameter but the
    embedding table) x tokens, plus forward and backward (3x) attention
    over the selected tile pairs. Remat's recompute is not counted."""
    c = registry.arch(m["architecture"]).param_counts(m)
    dense = m["num_hidden_layers"] * c["layer"] + c["head"] + c["final_norm"]
    attn = 3.0 * batch * m["num_hidden_layers"] * attention_pairs_flops(
        m, seq)
    return 6.0 * dense * batch * seq + attn
