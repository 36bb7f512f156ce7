"""Tiny sizes at which the CPU tests drive whole runs of the cells."""
import copy
import time

import torch

from perfbench.harness import registry, runner

SIFT = {"n_points": 2048, "n_clusters": 16,
        "traffic": {"sample_rows": 64, "sample_span": 20, "traced_calls": 5}}

_base = registry.config("minicpm3-4b")
MLA = {"hidden_size": 64, "num_attention_heads": 4, "num_key_value_heads": 4,
       "num_hidden_layers": 2, "intermediate_size": 128, "vocab_size": 256,
       "q_lora_rank": 32, "kv_lora_rank": 16, "qk_nope_head_dim": 8,
       "qk_rope_head_dim": 4, "v_head_dim": 8,
       "clusterkv": dict(_base["clusterkv"], block_q=16, block_k=16,
                         blocks_per_query=2),
       "training": dict(_base["training"], loss_chunk=32,
                        compute_dtype="float32"),
       "traffic": {"sequences": 2, "seq_len": 64}}


def run(workload, sizes, seed=2 ** 33 + 5):
    """One run of ``workload`` on the CPU at ``sizes``: (result, checks)."""
    return runner.run(workload, seed, 0.2, False, time.perf_counter(),
                      torch.device("cpu"), sizes=copy.deepcopy(sizes))
