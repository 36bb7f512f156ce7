"""Where a tick of the ClusterKV decode service goes, on one CUDA card.

    python3 tools/profile_service.py [--requests 4] [--ticks 8] [--top 14]

Builds Qwen2-0.5B at full width (random weights from ``--seed``) and the
service of ``chip_smoke.py`` phase 12 (``ClusterKVEngine(mode="plan",
knn=8, plan_prefill=True)``, 4 slots, ``max_seq`` 8192, bucket 1024), admits
the first ``--requests`` prompts of phase 10's traffic, warms up with two
ticks, then

1. runs ``--ticks`` ticks under ``cProfile`` and prints the ``--top``
   functions by their own host time, with the service's split of those
   ticks into the host claim (the inserter) and the decode step;
2. runs ``--ticks`` more under ``torch.profiler`` (CPU and CUDA activity)
   and prints the device time by kernel and the device's busy share of
   the ticks' wall time (kernel time summed over the one stream the port
   uses, over the host clock of the ticks).

Ends with one JSON line. ``cProfile`` adds a little to every Python call,
so the tick times of ``chip_smoke.py`` phase 12, taken without it, are the
ones to quote; this tool says where they go. Needs a CUDA card; exits 1
without one. Imports only ``torch``, numpy and ``repro_torch``.
"""
from __future__ import annotations

import argparse
import cProfile
import io
import json
import pstats
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--ticks", type=int, default=8)
    ap.add_argument("--top", type=int, default=14)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_service: no CUDA device", file=sys.stderr)
        return 1

    from repro_torch.configs import get_config
    from repro_torch.models import model_api
    from repro_torch.serve import ClusterKVEngine
    from repro_torch.train.serve_loop import Request

    dev = torch.device("cuda")
    cfg = get_config("qwen2-0.5b")
    params = model_api.init(cfg, torch.Generator(device=dev).manual_seed(
        args.seed), device=dev)
    # phase 10's traffic: the same draws from the same seed
    rng = np.random.default_rng(args.seed + 10)
    reqs = [Request(rid=i, tokens=rng.integers(0, cfg.vocab, int(
        rng.integers(2048, 6145))).astype(np.int64), max_new=64)
        for i in range(8)][:args.requests]
    svc = ClusterKVEngine(cfg, params, slots=4, max_seq=8192,
                          prefill_bucket=1024, knn=8, plan_prefill=True,
                          device=dev)
    for r in reqs:
        svc.submit(r)
    for _ in range(2):                   # admissions + warm-up
        svc.step()
    torch.cuda.synchronize()

    def split():
        rep = svc.report()
        return rep["host_claim_s"], rep["device_tick_s"]

    c0, d0 = split()
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    for _ in range(args.ticks):
        svc.step()
    prof.disable()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    c1, d1 = split()
    out = io.StringIO()
    pstats.Stats(prof, stream=out).sort_stats("tottime").print_stats(
        args.top)
    print(f"{args.ticks} ticks under cProfile: {wall * 1e3 / args.ticks:.2f}"
          f" ms a tick; host claim {(c1 - c0) * 1e3 / args.ticks:.2f} ms, "
          f"decode step {(d1 - d0) * 1e3 / args.ticks:.2f} ms a tick")
    print(out.getvalue(), flush=True)

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as tp:
        t0 = time.perf_counter()
        for _ in range(args.ticks):
            svc.step()
        torch.cuda.synchronize()
        wall_p = time.perf_counter() - t0
    rows = []
    for e in tp.key_averages():          # the kernels themselves only
        if e.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((e.self_device_time_total, e.key, e.count))
    rows.sort(reverse=True)
    busy_ms = sum(us for us, _, _ in rows) / 1e3
    print(f"{args.ticks} ticks under torch.profiler: "
          f"{wall_p * 1e3 / args.ticks:.2f} ms a tick; device busy "
          f"{busy_ms / args.ticks:.2f} ms a tick, "
          f"{busy_ms / (wall_p * 1e3):.3f} of the wall time")
    for us, key, n in rows[:args.top]:
        print(f"  {us / 1e3 / args.ticks:8.3f} ms a tick  {n // args.ticks:5d}"
              f" calls a tick  {key[:90]}")
    print(json.dumps({
        "ticks": args.ticks, "requests": args.requests,
        "cprofile_tick_ms": wall * 1e3 / args.ticks,
        "host_claim_ms": (c1 - c0) * 1e3 / args.ticks,
        "decode_step_ms": (d1 - d0) * 1e3 / args.ticks,
        "profiler_tick_ms": wall_p * 1e3 / args.ticks,
        "device_busy_ms": busy_ms / args.ticks,
        "device_busy_share": busy_ms / (wall_p * 1e3),
        "top_kernels": [{"key": k, "ms_per_tick": us / 1e3 / args.ticks,
                         "calls_per_tick": n / args.ticks}
                        for us, k, n in rows[:args.top]]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
