"""Where the host time of a streaming step goes, on one CUDA card.

    python3 tools/profile_stream.py [--n 262144] [--steps 2] [--top 12]

Builds the SIFT plan of ``chip_smoke.py`` phase 11 (D = 128, k = 30,
tile 32, superblock 8, d = 3, ``capacity = 1.1 n``, ``ell_slack = 4``,
points from a seeded mixture, the γ guard armed), then runs ``--steps``
1 % churn steps (n/100 deletes and as many inserts from the same mixture)
and one 1 % delete-only step through ``api.update_plan``, each under
``cProfile``. Prints, per step, its host seconds (the card drained at its
end) and the ``--top`` functions by their own time, then one JSON line
with the step times. ``cProfile`` adds a little to every Python call, so
the step times of ``chip_smoke.py`` phase 11, taken without it, are the
ones to quote; this tool says where they go.

Needs a CUDA card; exits 1 without one. Imports only ``torch``, numpy and
``repro_torch``.
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
    ap.add_argument("--n", type=int, default=262144)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_stream: no CUDA device", file=sys.stderr)
        return 1

    from repro_torch import api
    from repro_torch.data.pipeline import feature_mixture

    n, m = args.n, max(args.n // 100, 1)
    pool = feature_mixture(n + (args.steps + 1) * m, 128,
                           n_clusters=max(8, n // 256), seed=args.seed + 11)
    t0 = time.perf_counter()
    plan = api.build_plan(pool[:n], k=30, bs=32, sb=8, d=3, ell_slack=4,
                          capacity=int(1.1 * n), device="cuda")
    _ = plan.gamma
    torch.cuda.synchronize()
    print(f"build_plan(capacity={plan.capacity}): "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    rng = np.random.default_rng(args.seed + 11)
    feed, times = n, []
    for step in range(args.steps + 1):
        kill = rng.choice(np.nonzero(plan.alive)[0], m, replace=False)
        xin = None
        if step < args.steps:
            xin = pool[feed:feed + m]
            feed += m
        prof = cProfile.Profile()
        t0 = time.perf_counter()
        prof.enable()
        plan = api.update_plan(plan, insert=xin, delete=kill)
        torch.cuda.synchronize()
        prof.disable()
        dt = time.perf_counter() - t0
        tier = plan.refresh_stats.last_action
        times.append({"step": step, "tier": tier, "host_s": dt})
        out = io.StringIO()
        pstats.Stats(prof, stream=out).sort_stats("tottime").print_stats(
            args.top)
        print(f"== step {step}: {tier}, {dt:.3f} s under cProfile")
        print("\n".join(line for line in out.getvalue().splitlines()
                        if line.strip() and not line.startswith(
                            ("   Ordered", "   List"))), flush=True)
    print(json.dumps({"n": n, "m": m, "steps": times,
                      "numpy": np.__version__,
                      "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
