#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` and drives the
port's main path, ``api.build_plan(x) -> plan.matvec(charges)``, at the
paper's SIFT setting (arXiv 1709.03671 §4.2: 128-d descriptors, k = 30,
tile 32, superblock 8) on n = 262 144 synthetic descriptors made from a
seed. Phases, each of which fails the run when it fails:

1. environment: versions, the card, the kernel build with its wall time;
2. every kernel against its plain PyTorch version on the card, on the
   paper's §4.1 micro matrices (16 dense tiles per row block, banded and
   scattered) and on random nonzero coordinates;
3. the main path at full size — per-stage build times, ``matvec`` through
   the ``cuda`` backend for (n,) and (n, 8) charges against the ``bsr``
   and ``csr`` reference paths, the single-plan kernel entry on the plan's
   storage, and a small plan against a dense float64 product;
4. γ of the ordered pattern at the paper's Table 1 size (n = 4096, k = 30,
   σ = 15) through the γ-pair kernel, dual-tree against scattered;
5. each kernel's time at the main path's shapes beside its plain version,
   one library call and the least time the card could take.

Launch counters are set to 0 before phase 3 and read after phase 4: every
kernel must have been launched by the main path itself.

Needs a CUDA device and ``nvcc``; without a device it exits non-zero and
prints no result. ``--rehearse-cpu`` walks the same phases at tiny sizes
through the plain versions (to find wrong shapes and control flow without
a card); it never prints a result and always exits non-zero.

The last line of standard output is the result,
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``;
the line before it is the card's name and power limit, and the line before
that one JSON object with one entry per kernel.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM data-sheet peaks the bounds are stated against
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
# float32 operations counted per γ pair term: 2 subtractions, 2 multiplies
# and 1 add for the squared distance, the scale by -1/σ², the exponential
# (counted as one), the weight multiply and the accumulate
GAMMA_OPS_PER_PAIR = 9

# kernel-vs-plain tolerance: float32 sums taken in another order, so
# max-abs error <= REL_TOL * max|plain| (about 20 ulp of the largest value)
REL_TOL = 2e-5
# backend-vs-backend tolerance of the main path: the quickstart's 1e-4
# max-abs at unit-scale results, scaled by the result's magnitude
BACKEND_TOL = 1e-4


def say(msg: str = "") -> None:
    print(msg, flush=True)


class Timer:
    """ms per call of ``fn``: after a warm-up, the median of three runs of
    ``iters`` calls each — timed with CUDA events on a card, with the host
    clock on the CPU (rehearsal only)."""

    REPEATS = 3

    def __init__(self, device):
        self.device = device

    def _run(self, fn, iters: int) -> float:
        if self.device.type != "cuda":
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            return (time.perf_counter() - t0) * 1e3 / iters
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(iters):
            fn()
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / iters

    def __call__(self, fn, iters: int) -> float:
        fn()
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        return sorted(self._run(fn, iters) for _ in range(self.REPEATS))[1]


def check_close(name: str, got, want, rel_tol: float = REL_TOL):
    """max-abs error of ``got`` against ``want``; raises beyond
    ``rel_tol * max|want|``."""
    if tuple(got.shape) != tuple(want.shape):
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite values")
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    if err > rel_tol * max(scale, 1e-30):
        raise AssertionError(f"{name}: max-abs error {err:.3e} exceeds "
                             f"{rel_tol:g} x scale {scale:.3e}")
    return err, scale


def spmv_bound(kept_tiles: int, bs: int, col_idx_numel: int, x_numel: int,
               y_numel: int, f: int):
    """Least time for the ELL-BSR product: each kept tile, the index array,
    the charges and the result cross device memory once; 2 flops per tile
    entry and feature column."""
    byts = 4 * (kept_tiles * bs * bs + col_idx_numel + x_numel + y_numel)
    ops = 2 * kept_tiles * bs * bs * f
    t_b, t_o = byts / HBM_BYTES_PER_S * 1e3, ops / FP32_FLOP_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def gamma_bound(n: int, bn: int, symmetric: bool):
    nb = n // bn
    pairs = (nb * (nb + 1) // 2 if symmetric else nb * nb) * bn * bn
    t_b = (n * 12 + 4) / HBM_BYTES_PER_S * 1e3
    t_o = pairs * GAMMA_OPS_PER_PAIR / FP32_FLOP_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def library_bsr(vals, col_idx, mask, n_cb: int):
    """The same matrix as a ``torch.sparse_bsr_tensor`` (kept tiles only;
    stacked members become one block-diagonal matrix) — the yardstick's
    operand, used nowhere in the port."""
    B, n_rb, nbr = col_idx.shape
    bs = vals.shape[-1]
    counts = mask.reshape(B * n_rb, nbr).sum(1)
    crow = torch.zeros(B * n_rb + 1, dtype=torch.int32, device=vals.device)
    crow[1:] = counts.cumsum(0)
    off = (torch.arange(B, device=vals.device, dtype=torch.int32)
           * n_cb)[:, None, None]
    cols = (col_idx + off)[mask]
    tiles = vals[mask]
    return torch.sparse_bsr_tensor(crow, cols, tiles,
                                   size=(B * n_rb * bs, B * n_cb * bs))


def time_library(timer, vals, col_idx, mask, xs, iters: int):
    """ms of ``bsr_tensor @ x`` on the same operands, or None (with the
    reason printed) when this PyTorch build does not offer the product.
    This is the one place a failure is tolerated: the library call is a
    yardstick and no part of the port."""
    B, n_rb, _ = col_idx.shape
    bs = vals.shape[-1]
    n_cb = xs.shape[1] // bs
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            A = library_bsr(vals, col_idx, mask, n_cb)
            x2 = xs.reshape(B * n_cb * bs, -1)
            return timer(lambda: A @ x2, iters)
    except (RuntimeError, NotImplementedError) as e:
        say(f"    library yardstick unavailable: {type(e).__name__}: "
            f"{str(e).splitlines()[0]}")
        return None


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=262144,
                    help="points of the main path (default: 262144)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rehearse-cpu", action="store_true",
                    help="walk the phases on the CPU at tiny sizes; prints "
                         "no result and exits non-zero")
    args = ap.parse_args()

    rehearse = args.rehearse_cpu
    if not rehearse and not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script measures the port on a GPU and does not "
              "run on the CPU", file=sys.stderr)
        return 1

    from repro_torch import api
    from repro_torch.configs import paper_spmv
    from repro_torch.core import measures
    from repro_torch.core.blocksparse import random_bsr
    from repro_torch.data.pipeline import feature_mixture, sift_like
    from repro_torch.kernels import _build
    from repro_torch.kernels import bsr_spmv as k_bsr
    from repro_torch.kernels import gamma_score as k_gs
    from repro_torch.kernels import ops

    dev = torch.device("cpu" if rehearse else "cuda")
    timer = Timer(dev)
    t_start = time.perf_counter()
    wrappers = {"bsr_spmv_batched": k_bsr.bsr_spmv_batched,
                "bsr_spmv": k_bsr.bsr_spmv,
                "gamma_pairs": k_gs.gamma_pairs}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    # sizes: the real ones, or tiny ones for the CPU rehearsal
    exp = paper_spmv.TABLE1[0]                 # sift, n=4096, k=30, σ=15
    micro = paper_spmv.MICRO                   # tile 32, 16 tiles per row
    n_main = 2048 if rehearse else args.n
    n_micro = 2048 if rehearse else args.n
    n_gamma = 512 if rehearse else exp.n_points
    k, bs, sb = (8 if rehearse else exp.k_neighbors), exp.tile, exp.superblock
    n_clusters = max(8, n_main // 256)
    it_fast, it_slow = (2, 1) if rehearse else (20, 3)

    # ---------------------------------------------------------------- 1 ---
    say("== phase 1: environment")
    say(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}")
    smi_line = "no nvidia-smi (CPU rehearsal)"
    if not rehearse:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True)
        smi_line = smi.stdout.strip().splitlines()[0]
        say(f"card: {smi_line}")
        say(f"matmul allow_tf32={torch.backends.cuda.matmul.allow_tf32}  "
            f"cudnn allow_tf32={torch.backends.cudnn.allow_tf32}")
        t0 = time.perf_counter()
        _build.load()
        say(f"kernel build: {time.perf_counter() - t0:.2f} s "
            f"({', '.join(p.name for p in _build._sources())})")

    # ---------------------------------------------------------------- 2 ---
    say("== phase 2: kernels against their plain versions")
    micro_cases = []
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    for banded in (True, False):
        mat = random_bsr(args.seed + 1, n_micro, micro["tile"],
                         micro["tiles_per_row"], sb=sb, banded=banded,
                         device=dev)
        kind = "banded" if banded else "scattered"
        for B in (1, 8):
            if B == 1:
                vals, col = mat.vals[None], mat.col_idx[None]
            else:
                # members: fresh normal tiles, the pattern rolled per member
                vals = torch.randn((B,) + tuple(mat.vals.shape),
                                   generator=gen, device=dev)
                col = torch.stack([mat.col_idx.roll(b, 0) for b in range(B)])
            mask = torch.ones_like(col, dtype=torch.bool)
            for f in (1, 8):
                xs = torch.randn((B, mat.n_cb * mat.bs, f), generator=gen,
                                 device=dev)
                got = k_bsr.bsr_spmv_batched(vals, col, xs)
                sync()
                want = k_bsr.bsr_spmv_batched_plain(vals, col, xs)
                err, scale = check_close(
                    f"bsr_spmv_batched {kind} B={B} f={f}", got, want)
                ms = timer(lambda: k_bsr.bsr_spmv_batched(vals, col, xs),
                           it_fast)
                plain_ms = timer(
                    lambda: k_bsr.bsr_spmv_batched_plain(vals, col, xs),
                    it_slow)
                lib_ms = time_library(timer, vals, col, mask, xs,
                                      it_slow)
                bound, by = spmv_bound(col.numel(), mat.bs, col.numel(),
                                       xs.numel(), got.numel(), f)
                case = {"kernel": "bsr_spmv_batched", "matrix": kind,
                        "n": n_micro, "B": B, "f": f, "max_abs_err": err,
                        "scale": scale, "ms": ms, "plain_ms": plain_ms,
                        "library_ms": lib_ms, "bound_ms": bound,
                        "bound_by": by}
                micro_cases.append(case)
                say(f"  B1 {kind:9s} B={B} f={f}: err {err:.2e} (scale "
                    f"{scale:.1f})  kernel {ms:.3f} ms  plain "
                    f"{plain_ms:.3f} ms  library "
                    f"{'n/a' if lib_ms is None else f'{lib_ms:.3f} ms'}  "
                    f"bound {bound:.3f} ms ({by})")
                if B == 1:
                    got2 = k_bsr.bsr_spmv(vals[0], col[0], xs[0])
                    sync()
                    want2 = k_bsr.bsr_spmv_plain(vals[0], col[0], xs[0])
                    err2, _ = check_close(
                        f"bsr_spmv {kind} f={f}", got2, want2)
                    ms2 = timer(
                        lambda: k_bsr.bsr_spmv(vals[0], col[0], xs[0]),
                        it_fast)
                    micro_cases.append(
                        {"kernel": "bsr_spmv", "matrix": kind, "n": n_micro,
                         "B": 1, "f": f, "max_abs_err": err2, "ms": ms2,
                         "bound_ms": bound, "bound_by": by})
                    say(f"  B2 {kind:9s}     f={f}: err {err2:.2e}  "
                        f"kernel {ms2:.3f} ms")
            del vals, col, mask
        del mat
    n_pairs = 1024 if rehearse else 8192
    coords = torch.randint(0, 4096, (n_pairs, 2), generator=gen,
                           device=dev).float()
    wts = (torch.rand(n_pairs, generator=gen, device=dev) > 0.1).float()
    for symmetric in (False, True):
        got = k_gs.gamma_pairs(coords, exp.sigma, 256, weights=wts,
                               symmetric=symmetric)
        again = k_gs.gamma_pairs(coords, exp.sigma, 256, weights=wts,
                                 symmetric=symmetric)
        sync()
        want = k_gs.gamma_pairs_plain(coords, exp.sigma, 256, weights=wts,
                                      symmetric=symmetric)
        err, scale = check_close(
            f"gamma_pairs symmetric={symmetric}", got.reshape(1),
            want.reshape(1))
        if got.item() != again.item():
            raise AssertionError("gamma_pairs is not reproducible run to run")
        micro_cases.append({"kernel": "gamma_pairs", "n": n_pairs,
                            "bn": 256, "symmetric": symmetric,
                            "max_abs_err": err, "scale": scale})
        say(f"  B3 n={n_pairs} bn=256 symmetric={symmetric}: err {err:.2e} "
            f"(sum {scale:.4e}), reproducible")

    # ------------------------------------------------------------ 3 + 4 ---
    for w in wrappers.values():
        w.launches = 0

    say(f"== phase 3: main path, build_plan -> matvec at n={n_main}")
    t0 = time.perf_counter()
    x = feature_mixture(n_main, 128, n_clusters=n_clusters, seed=args.seed)
    say(f"  data: {x.shape} float32 mixture of {n_clusters} clusters "
        f"({time.perf_counter() - t0:.1f} s on the host)")

    def gaussian_values(rows, cols, d2):
        return np.exp(-d2 / max(float(d2.mean()), 1e-30))

    t0 = time.perf_counter()
    plan = api.build_plan(x, k=k, bs=bs, sb=sb, d=3, bits=10, leaf_size=64,
                          backend="auto", values=gaussian_values, device=dev)
    sync()
    build_s = time.perf_counter() - t0
    b = plan.bsr
    stages = "  ".join(f"{name} {sec:.2f} s"
                       for name, sec in plan.host.timings.items())
    say(f"  build_plan: {build_s:.2f} s  ({stages})")
    kept = int(b.nbr_mask.sum())
    plan_bytes = sum(t.numel() * t.element_size()
                     for t in (b.vals, b.col_idx, b.nbr_mask, plan.pi,
                               plan.inv))
    say(f"  {plan}")
    say(f"  {b.n_rb} row blocks, ELL width {b.max_nbr}, {kept} kept tiles "
        f"({kept / b.n_rb:.1f} per row block), fill {b.fill:.4f}; tile "
        f"tensor {b.vals.numel() * 4 / 1e9:.3f} GB, plan on device "
        f"{plan_bytes / 1e9:.3f} GB")
    if b.vals.numel() * 4 > 16e9:
        raise AssertionError(
            "tile tensor passes 16 GB at this n: halve --n (the widths stay)")
    if plan.resolve_backend() != ("bsr" if rehearse else "cuda"):
        raise AssertionError(f"backend 'auto' resolved to "
                             f"{plan.resolve_backend()!r}")

    rng = np.random.default_rng(args.seed + 2)
    charges = {}
    for shape in ((n_main,), (n_main, 8)):
        ch = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                              ).to(dev)
        y = plan.matvec(ch)                       # backend="auto"
        sync()
        charges[str(shape)] = ch
        for other in ("bsr", "csr"):
            want = plan.matvec(ch, backend=other)
            err, scale = check_close(f"matvec {shape} vs {other}", y,
                                     want, rel_tol=BACKEND_TOL)
            say(f"  matvec {str(shape):13s} cuda vs {other}: max-abs "
                f"{err:.2e} (scale {scale:.2f}, tolerance "
                f"{BACKEND_TOL:g} x scale)")
        # the single-plan kernel entry on the plan's storage
        xs_sorted = plan.permute(ch)
        y2 = ops.bsr_spmv(b.vals, b.col_idx, xs_sorted, plan.n)
        sync()
        err, _ = check_close(f"ops.bsr_spmv {shape}", y2,
                             plan.apply(xs_sorted, backend="bsr"),
                             rel_tol=BACKEND_TOL)
        say(f"  ops.bsr_spmv {str(shape):9s} vs bsr: max-abs {err:.2e}")

    # what comes out is right: a small plan against a dense float64 product
    n_small = 2048
    xs_small = feature_mixture(n_small, 128, n_clusters=32,
                               seed=args.seed + 3)
    small = api.build_plan(xs_small, k=16, bs=bs, sb=sb, device=dev,
                           values=gaussian_values)
    r, c, v = small.coo
    dense = np.zeros((n_small, n_small), np.float64)
    np.add.at(dense, (small.host.pi[r], small.host.pi[c]), v)
    ch = rng.standard_normal((n_small, 8)).astype(np.float32)
    got = small.matvec(ch).cpu().numpy()
    err = float(np.abs(got - dense @ ch).max())
    if got.shape != ch.shape or not np.isfinite(got).all() or \
            err > BACKEND_TOL * max(1.0, float(np.abs(dense @ ch).max())):
        raise AssertionError(f"small plan disagrees with the dense product: "
                             f"max-abs {err:.3e}")
    say(f"  n={n_small} plan vs dense float64 A @ x: max-abs {err:.2e}")

    say(f"== phase 4: gamma at n={n_gamma}, k={k}, sigma={exp.sigma}")
    x4 = sift_like(n_gamma, seed=args.seed)
    gammas, pattern = {}, None
    for ordering in ("dual_tree", "scattered"):
        prof = api.build_plan(x4, k=k, ordering=ordering, with_bsr=False,
                              sigma=exp.sigma, device=dev)
        r4, c4, _ = prof.coo
        g_exact = float(measures.gamma_exact(r4, c4, exp.sigma, device=dev))
        gammas[ordering] = (g_exact, prof.gamma)
        if ordering == "dual_tree":
            pattern = (r4, c4)
        say(f"  {ordering:10s} gamma_exact {g_exact:8.3f} (nnz {len(r4)}, "
            f"tiled kernel)   gamma_score {prof.gamma:8.3f}")
    for idx, which in enumerate(("gamma_exact", "gamma_score")):
        if not gammas["dual_tree"][idx] > gammas["scattered"][idx]:
            raise AssertionError(f"{which}: dual_tree does not beat "
                                 f"scattered: {gammas}")

    launches = {name: w.launches for name, w in wrappers.items()}
    say(f"  launches on the main path: {launches}")
    if not rehearse:
        for name, count in launches.items():
            if count <= 0:
                raise AssertionError(
                    f"kernel {name} was never launched by the main path")

    # ---------------------------------------------------------------- 5 ---
    say("== phase 5: kernels at the main path's shapes")
    # what a caller waits for: permute, pad, kernel, slice, unpermute
    matvec_ms = {}
    for shape, ch in charges.items():
        matvec_ms[shape] = timer(lambda: plan.matvec(ch), it_fast)
        say(f"  plan.matvec {shape:13s} end to end: {matvec_ms[shape]:.3f} "
            f"ms per call")
    vals1, col1, mask1 = b.vals[None], b.col_idx[None], b.nbr_mask[None]
    entries = []
    spmv_rows = {}
    for f in (1, 8):
        xs = torch.randn((1, b.n_cb * b.bs, f), generator=gen, device=dev)
        lib_ms = time_library(timer, vals1, col1, mask1, xs, it_slow)
        bound, by = spmv_bound(kept, b.bs, col1.numel(), xs.numel(),
                               b.n_rb * b.bs * f, f)
        for name, run, plain in (
                ("bsr_spmv_batched",
                 lambda: k_bsr.bsr_spmv_batched(vals1, col1, xs),
                 lambda: k_bsr.bsr_spmv_batched_plain(vals1, col1, xs)),
                ("bsr_spmv",
                 lambda: k_bsr.bsr_spmv(vals1[0], col1[0], xs[0]),
                 lambda: k_bsr.bsr_spmv_plain(vals1[0], col1[0], xs[0]))):
            got = run()
            sync()
            err, scale = check_close(f"{name} plan f={f}", got,
                                     plain())
            row = {"f": f, "max_abs_err": err, "scale": scale,
                   "ms": timer(run, it_fast),
                   "plain_ms": timer(plain, it_slow), "library_ms": lib_ms,
                   "bound_ms": bound, "bound_by": by}
            spmv_rows[(name, f)] = row
            say(f"  {name:17s} f={f}: err {err:.2e}  kernel "
                f"{row['ms']:.3f} ms  plain {row['plain_ms']:.3f} ms  "
                f"library "
                f"{'n/a' if lib_ms is None else f'{lib_ms:.3f} ms'}  bound "
                f"{bound:.3f} ms ({by})")
    shape = (f"vals (1, {b.n_rb}, {b.max_nbr}, {b.bs}, {b.bs}), "
             f"{kept} kept tiles")
    for name, f_head, line in (("bsr_spmv_batched", 1, 110),
                               ("bsr_spmv", 8, 58)):
        head = dict(spmv_rows[(name, f_head)])
        entries.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/bsr_spmv.cu",
            "replaces": f"src/repro/kernels/bsr_spmv.py:{line}",
            "launches": launches[name], "shape": f"{shape}, f={f_head}",
            **{key: head[key] for key in
               ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms")},
            "cases": [spmv_rows[(name, f)] for f in (1, 8)]})

    r4, c4 = pattern
    nnz = len(r4)
    pad = (-nnz) % 256
    co = torch.zeros((nnz + pad, 2), dtype=torch.float32, device=dev)
    co[:nnz, 0] = torch.from_numpy(r4.astype(np.float32)).to(dev)
    co[:nnz, 1] = torch.from_numpy(c4.astype(np.float32)).to(dev)
    wt = torch.zeros(nnz + pad, dtype=torch.float32, device=dev)
    wt[:nnz] = 1.0

    def run_gamma():
        return k_gs.gamma_pairs(co, exp.sigma, 256, weights=wt,
                                symmetric=True)

    def plain_gamma():
        return k_gs.gamma_pairs_plain(co, exp.sigma, 256, weights=wt,
                                      symmetric=True)

    got = run_gamma()
    sync()
    err, scale = check_close("gamma_pairs plan pattern",
                             got.reshape(1), plain_gamma().reshape(1))
    bound, by = gamma_bound(nnz + pad, 256, True)
    g_row = {"ms": timer(run_gamma, it_fast),
             "plain_ms": timer(plain_gamma, 1)}
    say(f"  gamma_pairs nnz={nnz}: err {err:.2e} (sum {scale:.4e})  kernel "
        f"{g_row['ms']:.3f} ms  plain {g_row['plain_ms']:.3f} ms  bound "
        f"{bound:.3f} ms ({by})")
    entries.append({
        "name": "gamma_pairs", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/gamma_pairs.cu",
        "replaces": "src/repro/kernels/gamma_score.py:55",
        "launches": launches["gamma_pairs"],
        "shape": f"coords ({nnz + pad}, 2), bn=256, symmetric",
        "max_abs_err": err, "ms": g_row["ms"], "plain_ms": g_row["plain_ms"],
        "bound_ms": bound, "bound_by": by, "library_ms": None})

    say(f"== done in {time.perf_counter() - t_start:.1f} s")
    if rehearse:
        say("rehearsal on the CPU finished: every phase ran through the "
            "plain versions. No result: the check needs a CUDA device.")
        return 3

    say(json.dumps({"micro_cases": micro_cases,
                    "build_plan_s": build_s,
                    "stage_s": plan.host.timings,
                    "matvec_ms": matvec_ms,
                    "plan_bytes": plan_bytes, "n": n_main,
                    "max_nbr": b.max_nbr, "kept_tiles": kept,
                    "gamma": {o: {"exact": g[0], "score": g[1]}
                              for o, g in gammas.items()}}))
    say(json.dumps({"kernels": entries}))
    say(smi_line)
    say(json.dumps({"ok": True,
                    "device": {"platform": "gpu",
                               "kind": torch.cuda.get_device_name(0),
                               "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
