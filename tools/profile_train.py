"""Where a training step of Qwen2-0.5B goes, on one CUDA card.

    python3 tools/profile_train.py [--batch 8] [--seq 4096] [--top 16]
        [--backend flash|clusterkv] [--steps N] [--root DIR]

Builds Qwen2-0.5B at full width and depth (float32 masters from
``--seed``, bf16 compute, remat on, ``loss_chunk`` 8192: the config of
``chip_smoke.py`` phase 18), takes one AdamW step of ``--batch`` x
``--seq`` tokens through ``--backend``'s attention to warm up, times
``--steps`` more on the host clock (each ends in the loss's read), then
one more under ``torch.profiler`` (CPU and CUDA activity) and prints the
device time by kernel, the same time in four classes by kernel name
(matrix products, elementwise, reductions and softmax, the rest; B6's
forward and backward kernels, under ``clusterkv``, in a class of their
own) and the device's busy share of the step's wall time (kernel time
over the host clock of the step, which ends in a sync).

``--root`` names the checkout whose ``src/repro_torch`` is run (default:
the one holding this script): two commits unpacked side by side are
profiled by the same code in one call.

Ends with one JSON line. Needs a CUDA card; exits 1 without one. Imports
only ``torch`` and ``repro_torch``.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parents[1]

# kernel-name fragments of each class, tested in this order
CLASSES = (("B6 (block_attention*, dq/dkv, key-tile lists and order)",
            ("block_attention", "dq_wgmma", "dkv_wgmma", "dq_mma",
             "dkv_mma", "key_tile")),
           ("matmul", ("gemm", "cutlass", "sm90_xmma", "nvjet", "matmul")),
           ("reduce / softmax", ("reduce", "softmax", "logsumexp", "norm",
                                 "scan")),
           ("elementwise", ("elementwise", "vectorized", "unrolled", "copy",
                            "fill", "where", "index", "cat", "gather",
                            "scatter")))


def kernel_class(name: str) -> str:
    low = name.lower()
    for cls, keys in CLASSES:
        if any(k in low for k in keys):
            return cls
    return "other"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--top", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--backend", default="flash",
                    choices=("flash", "clusterkv"))
    ap.add_argument("--steps", type=int, default=0,
                    help="steps timed on the host clock before the "
                         "profiled one")
    ap.add_argument("--root", type=Path, default=HERE)
    args = ap.parse_args()
    sys.path.insert(0, str(args.root.resolve() / "src"))
    if not torch.cuda.is_available():
        print("profile_train: no CUDA device", file=sys.stderr)
        return 1

    from repro_torch.configs import get_config
    from repro_torch.data import pipeline
    from repro_torch.models import model_api
    from repro_torch.optim.optimizers import make_optimizer
    from repro_torch.train import trainer

    dev = torch.device("cuda")
    cfg = get_config("qwen2-0.5b")
    params = model_api.init(cfg, torch.Generator(device=dev).manual_seed(
        args.seed), device=dev)
    opt = make_optimizer(cfg.optimizer, warmup=1, total=args.steps + 2)
    step, _ = trainer.make_train_step(cfg, None, args.backend,
                                      optimizer=opt)
    state = opt.init(params)
    batch = pipeline.to_device(pipeline.token_batch(cfg, 0, args.batch,
                                                    args.seq, args.seed),
                               dev)
    _, _, m = step(params, state, batch)
    float(m["loss"])
    timed = []
    for _ in range(args.steps):
        t0 = time.perf_counter()
        _, _, m = step(params, state, batch)
        float(m["loss"])
        timed.append((time.perf_counter() - t0) * 1e3)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as tp:
        t0 = time.perf_counter()
        _, _, m = step(params, state, batch)
        loss = float(m["loss"])
        wall = time.perf_counter() - t0
    rows = []
    for e in tp.key_averages():          # the kernels themselves only
        if e.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((e.self_device_time_total, e.key, e.count))
    rows.sort(reverse=True)
    busy_ms = sum(us for us, _, _ in rows) / 1e3
    by_class: dict = {}
    for us, key, _ in rows:
        cls = kernel_class(key)
        by_class[cls] = by_class.get(cls, 0.0) + us / 1e3
    if timed:
        print(f"{args.backend}: {args.steps} steps of {args.batch} x "
              f"{args.seq} tokens on the host clock: median "
              f"{sorted(timed)[len(timed) // 2]:.1f} ms, each "
              + ", ".join(f"{t:.1f}" for t in timed))
    print(f"one {args.backend} step of {args.batch} x {args.seq} tokens under "
          f"torch.profiler: {wall * 1e3:.1f} ms on the host clock (loss "
          f"{loss:.4f}); device busy {busy_ms:.1f} ms, "
          f"{busy_ms / (wall * 1e3):.3f} of the wall time")
    for cls, ms in sorted(by_class.items(), key=lambda kv: -kv[1]):
        print(f"  {cls:18s} {ms:9.1f} ms  {ms / busy_ms:.3f} of the device "
              "time")
    for us, key, n in rows[:args.top]:
        print(f"  {us / 1e3:9.1f} ms  {n:6d} calls  {key[:90]}")
    print(json.dumps({
        "backend": args.backend, "root": str(args.root),
        "steps_ms": timed, "batch": args.batch, "seq": args.seq,
        "step_ms": wall * 1e3,
        "device_busy_ms": busy_ms, "device_busy_share":
        busy_ms / (wall * 1e3), "ms_by_class": by_class,
        "card": torch.cuda.get_device_name(0),
        "top_kernels": [{"key": k, "ms": us / 1e3, "calls": n}
                        for us, k, n in rows[:args.top]]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
