"""Readings that a cell's correctness limits are set from, at the cell's
own size, on the card.

    python3 perfbench/calibrate.py --workload <cell> --seeds 1,2,3
                                   [--what control|half_batch]

For each seed it prints one JSON line with the numbers the cell compares
(``checks`` of ``run.py``), read with the plain reference's lower
precision put in the program's place (``control``: TF32 distances for
the interaction-plan cells, int8 products and gradients for the training
cells; ``fp8``: float8 ones for the training cells)
or, for the training cells, the reference trained on the first half of
each batch's rows put in the program's place (``half_batch``).
``--detail 1`` adds each leaf's gaps.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def sift_control(ctx):
    import torch

    from perfbench.harness import gen, plans
    x = torch.as_tensor(plans.points(ctx.config, 0), device=ctx.device)
    rows = plans.sample_rows(ctx.config, ctx.traffic, x, ctx.seed, 4)
    g = torch.Generator(device=ctx.device)
    g.manual_seed(gen.sub_seed(ctx.seed, 2))
    cols = ctx.traffic.get("columns", ctx.traffic.get("probe_columns"))
    ch = torch.randn((x.shape[0], cols), generator=g, device=ctx.device)
    err = plans.compare(ctx.config, x, rows, [None], [ch], tf32=True)[0]
    name = ("matvec_rel_err" if ctx.traffic["kind"] == "matvec"
            else "build_rel_err")
    return {name: err}


def _per_leaf(prog, ref):
    import numpy as np
    med = float(np.median(list(ref.values())))
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med, 1e-300)
            for k in ref}


def train_reading(ctx, what, detail=False):
    from perfbench.drivers.train import Driver
    drv = Driver(ctx)
    ref = drv.reference_readings()
    if what in ("control", "fp8"):
        other = drv.reference_readings(
            low="int8" if what == "control" else "fp8")
    else:
        rows = ctx.traffic["sequences"] // 2
        half = dict(ctx.traffic, sequences=rows,
                    microbatches=min(ctx.traffic["microbatches"], rows))
        drv.tr = half
        other = drv.reference_readings()
        drv.tr = ctx.traffic
    drv.check_losses = other["losses"]
    drv.grad1 = other["grad1"]
    drv.change = other["change"]
    got = drv.readings(ref)
    if detail:
        got["grad1_leaves"] = _per_leaf(drv.grad1, ref["grad1"])
        got["change_leaves"] = _per_leaf(drv.change, ref["change"])
    return got


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--what", default="control",
                    choices=("control", "fp8", "half_batch"))
    ap.add_argument("--detail", type=int, default=0,
                    help="1: also each leaf's gaps (training cells)")
    args = ap.parse_args(argv)
    for p in (ROOT / "src", ROOT):
        sys.path.insert(0, str(p))
    import torch

    from perfbench.harness import runner
    if not torch.cuda.is_available():
        print("calibrate.py: no CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        ctx = runner.Context(args.workload, seed, dev)
        if ctx.traffic["kind"] == "train":
            got = train_reading(ctx, args.what, bool(args.detail))
        else:
            got = sift_control(ctx)
        print(json.dumps({"workload": args.workload, "what": args.what,
                          "seed": seed, "readings": got,
                          "seconds": time.perf_counter() - t0}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
