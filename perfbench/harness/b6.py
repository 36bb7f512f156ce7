"""B6 (block-sparse attention) as a training step launches it: kernel
names in the trace, and the selected tile pairs of one launch."""
from __future__ import annotations

from typing import Tuple

from perfbench.harness import registry

DQ_KERNELS = ("dq_wgmma", "dq_mma", "dq_kernel")
BWD_KERNELS = ("key_tile", "dkv_wgmma", "dkv_mma", "dkv_kernel") + DQ_KERNELS


def launch_pairs(rec) -> Tuple[int, int, int, int, int]:
    """(selected pairs, bq, bk, dh, dv) of one launch: a microbatch's
    sequences x heads x query tiles x kept key tiles."""
    m, sh = rec["model"], rec["shape"]
    ck = m["clusterkv"]
    seq = sh["seq"]
    bq, bk = min(ck["block_q"], seq), min(ck["block_k"], seq)
    n_sel = min(ck["blocks_per_query"], seq // bk)
    rows = sh["batch"] // sh["microbatches"]
    heads, dh, dv = registry.arch(m["architecture"]).attention_dims(m)
    pairs = rows * heads * (seq // bq) * n_sel
    return pairs, bq, bk, dh, dv
