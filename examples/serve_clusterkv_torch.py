"""Decode through the ClusterKV decode service of the PyTorch/CUDA port: the
twin of ``examples/serve_clusterkv.py``.

A batch of requests flows through ``repro_torch.serve.ClusterKVEngine``:
each admission builds one ordering ``PlanBatch`` per layer over the
prefilled keys (``core.clusterkv.kv_plan_batch``, capacity = ``max_seq``),
prefills again through those orderings (``plan_prefill``, B6 on a GPU),
decodes over the PLAN-ORDERED cache (B5 in plan mode with the self column on
a GPU), and streams every generated key into the session's plans through
the insert tier (Morton-leaf slot claim — no per-step re-sort). All
sessions unify to one ``PlanSpec``, so the whole run has ONE decode-step
signature, and with a cluster budget covering every tile the service decode
is exact: the argmax tokens must match a flash-attention engine token for
token.

  python examples/serve_clusterkv_torch.py                 # on the GPU
  python examples/serve_clusterkv_torch.py --device cpu    # plain paths
"""
import argparse
import dataclasses
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np
import torch

from repro_torch.configs import ClusterKVConfig, reduced_config
from repro_torch.models import model_api
from repro_torch.serve import ClusterKVEngine
from repro_torch.train.serve_loop import Engine, Request


def make_requests(cfg, n, rng, max_new):
    return [Request(rid=i,
                    tokens=rng.integers(0, cfg.vocab,
                                        int(rng.integers(16, 60))
                                        ).astype(np.int32),
                    max_new=max_new)
            for i in range(n)]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda; raises without one)")
    args = ap.parse_args()
    dev = torch.device(args.device)

    max_seq, slots, n_req, max_new = 256, 2, 6, 12
    # decode_clusters covers every tile (max_seq/block_k = 8), so the
    # sparse decode selects ALL live clusters -> exact attention; float32
    # so the dense-vs-service argmax comparison is not at the mercy of
    # bf16 rounding between different but equivalent computations
    cfg = reduced_config("qwen2-0.5b").with_(
        dtype="float32",
        clusterkv=ClusterKVConfig(enabled=True, block_q=32, block_k=32,
                                  blocks_per_query=8, decode_clusters=8))
    params = model_api.init(cfg, torch.Generator(device=dev).manual_seed(0),
                            device=dev)
    rng = np.random.default_rng(0)
    prompts = make_requests(cfg, n_req, rng, max_new)

    # flash-attention reference engine
    dense = Engine(cfg, params, slots=slots, max_seq=max_seq,
                   prefill_bucket=64, backend="flash", device=dev)
    ref_reqs = [dataclasses.replace(r, output=[]) for r in prompts]
    for r in ref_reqs:
        dense.submit(r)
    t0 = time.perf_counter()
    dense.run()
    t_dense = time.perf_counter() - t0

    # the ClusterKV decode service: plan-cached continuous batching
    svc = ClusterKVEngine(cfg, params, slots=slots, max_seq=max_seq,
                          prefill_bucket=64, mode="plan", plan_prefill=True,
                          device=dev)
    svc_reqs = [dataclasses.replace(r, output=[]) for r in prompts]
    for r in svc_reqs:
        svc.submit(r)
    t0 = time.perf_counter()
    svc.run()
    t_svc = time.perf_counter() - t0

    for ref, got in zip(ref_reqs, svc_reqs):
        assert ref.output == got.output, (ref.rid, ref.output, got.output)

    rep = svc.report()
    assert rep["decode_traces"] == 1, rep["decode_traces"]
    assert rep["specs_seen"] == 1, rep["specs_seen"]
    print(f"admissions: {rep['counters']['admits']} "
          f"(slots={slots}, specs seen: {rep['specs_seen']}, "
          f"decode signatures: {rep['decode_traces']})")
    print(f"insert tier: {rep['insert_tiers']['appends']} streamed appends, "
          f"{rep['counters']['flushed_edges']} kNN edges folded")
    print(f"wall on {dev.type}: flash engine {t_dense:.2f}s, service "
          f"{t_svc:.2f}s (host claim {rep['host_claim_s']:.2f}s, decode "
          f"{rep['device_tick_s']:.2f}s)")
    print(f"service tokens match dense decode for all {n_req} requests")


if __name__ == "__main__":
    main()
