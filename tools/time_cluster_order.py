"""Time ClusterKV's key ordering on one CUDA card, beside its bound and the
plain path.

    python3 tools/time_cluster_order.py [--root DIR] [--seed S]

``--root`` names the checkout whose ``src/repro_torch`` is timed (default:
the one holding this script), so that two commits unpacked side by side are
timed by the same code in the same call. At each of minicpm3-4b's two
training shapes (one microbatch's keys: 1 x 40 heads x 8 192 and 4 x 40 x
2 048, head dim 96, bf16; clustered random keys from ``--seed``) it prints
one JSON line:

* ``kernel_ms``: ``ops.cluster_codes`` (one launch of
  ``csrc/cluster_order.cu``), ``order_ms``: ``core.clusterkv.cluster_perm``
  (the kernel and the stable argsort), ``argsort_ms``: the argsort alone;
  each by CUDA events, the median of three runs of 20 calls after one to
  warm up; null for a checkout without the kernel;
* ``plain_ms``, ``plain_order_ms``: the plain version
  (``pca_project_det`` + ``morton_codes``; with the argsort, which is
  ``cluster_perm`` in a checkout without the kernel), by CUDA events over
  runs of 5 calls: the card's time from the first launch to the last;
* ``order_wall_ms``, ``plain_order_wall_ms``: the host clock a call with a
  synchronize after each, what a training step waits;
* ``bound_ms`` and ``bound_by``: the larger of the keys read once and the
  codes written once at 3.35 TB/s and ``(2 iters + 1) x 2 S dh d`` float32
  operations at 67 TFLOP/s (the CUDA cores' rate: no TF32, no bf16
  product);
* ``layout``: the kernel's blocks a set, rows a block, rows a chunk and
  whether the keys are read once (``resident``);
* ``y_gap``: the largest ``|y - y_plain|`` over each set's largest
  ``|y_plain|``; ``codes_differ``: the share of codes unlike the plain
  version's (cell-edge near-ties, ROADMAP C31); from
  ``cluster_order.check_against_plain``, which fails the run where they
  pass its limits.

``chip_smoke.py``'s phase 2 holds and times the kernel alone too; this
tool adds the whole ordering (with the argsort), the host's wall clock
and a checkout without the kernel (``--root``), for comparing two
commits.

Needs a CUDA card; exits 1 without one. Imports only ``torch`` and the
chosen checkout's ``repro_torch``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent.parent
# (cell, B, H, S): the keys of one microbatch of each training cell
SHAPES = (("minicpm3-4b.train8k", 1, 40, 8192),
          ("minicpm3-4b.train2k", 4, 40, 2048))
DH, D, BITS, ITERS = 96, 3, 10, 4
HBM_BPS, F32_FLOPS = 3.35e12, 67e12


def events_ms(fn, iters: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(3):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(iters):
            fn()
        e1.record()
        torch.cuda.synchronize()
        runs.append(e0.elapsed_time(e1) / iters)
    return sorted(runs)[1]


def wall_ms(fn, iters: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def keys(gen, b, h, s, dev):
    """Clustered keys with a nonzero mean, bf16 (B, H, S, DH)."""
    centers = torch.randn((b, h, 16, DH), generator=gen, device=dev) * 3
    pick = torch.randint(0, 16, (b, h, s), generator=gen, device=dev)
    k = torch.gather(centers, 2, pick[..., None].expand(b, h, s, DH))
    k = k + 1.5 + 0.3 * torch.randn((b, h, s, DH), generator=gen,
                                     device=dev)
    return k.bfloat16()


def time_shape(gen, cell, b, h, s, dev):
    from repro_torch.core import clusterkv as ckv
    from repro_torch.core.embedding import pca_project_det
    from repro_torch.core.hierarchy import morton_codes
    try:
        from repro_torch.kernels import cluster_order as co
    except ImportError:
        co = None
    k = keys(gen, b, h, s, dev)
    n = b * h
    flat = k.reshape(n, s, DH)

    def plain():
        return morton_codes(pca_project_det(flat, D, ITERS), BITS)

    def plain_order():
        return torch.argsort(plain(), dim=-1, stable=True)

    row = {"config": cell, "B": b, "H": h, "S": s, "dh": DH, "d": D,
           "dtype": "bfloat16"}
    read = n * s * DH * k.element_size() + n * s * 8
    flops = 2.0 * s * DH * D * (2 * ITERS + 1) * n
    row.update(bytes=read, flops=flops)
    t_bytes, t_ops = read / HBM_BPS * 1e3, flops / F32_FLOPS * 1e3
    row["bound_ms"] = max(t_bytes, t_ops)
    row["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    row["plain_ms"] = events_ms(plain, 5)
    row["plain_order_ms"] = events_ms(plain_order, 5)
    row["plain_order_wall_ms"] = wall_ms(plain_order, 5)
    if co is None:
        row.update(kernel_ms=None, order_ms=None, argsort_ms=None,
                   order_wall_ms=None, layout=None)
        return row
    from repro_torch.kernels import ops
    row["layout"] = co.layout(n, s, DH, k.dtype)._asdict()
    codes = ops.cluster_codes(k, D, BITS)
    row["kernel_ms"] = events_ms(lambda: ops.cluster_codes(k, D, BITS))
    row["order_ms"] = events_ms(lambda: ckv.cluster_perm(k, D, BITS))
    row["argsort_ms"] = events_ms(
        lambda: torch.argsort(codes, dim=-1, stable=True))
    row["order_wall_ms"] = wall_ms(lambda: ckv.cluster_perm(k, D, BITS))
    row["kernel_share_of_bound"] = row["bound_ms"] / row["kernel_ms"]
    row.update(co.check_against_plain(k, *co.embed_and_code(k, D, BITS),
                                      D, BITS, ITERS))
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", type=Path, default=HERE)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(args.root.resolve() / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels import _build

    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    _build.load()
    gen = torch.Generator(device=dev).manual_seed(args.seed + 33)
    for shape in SHAPES:
        row = time_shape(gen, *shape, dev)
        row.update(root=str(args.root), card=card)
        print(json.dumps(row), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
