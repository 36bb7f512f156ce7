#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` and drives the
port's paths through the entry points a user calls: ``api.build_plan(x) ->
plan.matvec(charges)`` at the paper's SIFT setting (arXiv 1709.03671 §4.2:
128-d descriptors, k = 30, tile 32, superblock 8) on n = 262 144 synthetic
descriptors made from a seed, then the paper's two iterative applications
(§3) at the same n, then Qwen2-0.5B at full width (random weights from the
seed) served with ClusterKV attention. Phases, each of which fails the run
when it fails:

1. environment: versions, the card, the kernel build with its wall time,
   and the registers and spills ``-Xptxas -v`` reports for the bf16 B6
   kernel;
2. every kernel against its plain PyTorch version on the card, on the
   paper's §4.1 micro matrices (16 dense tiles per row block, banded and
   scattered; B1/B2 also under padded masks — kept counts spread over
   0..16 as prefixes, holes anywhere, NaN tiles under the mask — and
   required to be bit-equal run to run), on random nonzero coordinates
   (γ, also at σ = 1, where far terms underflow) and on random ELL
   affinity patterns with a ragged last row block (t-SNE force, also
   under the same three kinds of padded mask, run twice and required to
   be bit-equal), the ClusterKV prefill kernel (causal and not, g = 7,
   tiles of 128 and 64, float32 and bf16) and the decode kernel (plain
   mode, plan mode with holes with and without the self column, g = 1 and
   7, float32 and bf16; the same tiles selected as the plain path; and
   one NaN key tile, selected first as ``topk_stable`` ranks it);
3. the main path at full size — per-stage build times, ``matvec`` through
   the ``cuda`` backend for (n,) and (n, 8) charges against the ``bsr``
   and ``csr`` reference paths, the single-plan kernel entry on the plan's
   storage, and a small plan against a dense float64 product;
4. γ of the ordered pattern at the paper's Table 1 size (n = 4096, k = 30,
   σ = 15) through the γ-pair kernel, dual-tree against scattered;
5. each kernel's time at the main path's shapes beside its plain version,
   one library call and the least time the card could take (B1/B2 timed
   as the plan path launches them: with the plan's mask and no per-call
   range check, which is timed apart; with GB/s of kept tiles; B3's bound
   from its exponentials at the card's SM count and highest SM clock,
   both printed in phase 1);
6. t-SNE attraction at full width: P calibrated to perplexity 30 over
   k = 90 neighbours (van der Maaten, JMLR 15, 2014), symmetrised, planned
   with ``InteractionPlan.from_coo`` ordered from the data; 20 attraction
   steps through ``plan.tsne_attractive`` (the ``tsne_force`` kernel over
   the plan's kept tiles), held against the plain path, a float64
   edge-wise sum and, bit for bit, the kernel over every slot, then timed
   (the kernel as the plan launches it, with the direct entry's range
   check apart). Dense repulsion at this n is not part of the package and
   is not run;
7. mean shift with the refresh tiers at full size: ``build_plan(t,
   sources=src)``, four ``plan.meanshift_step``s with a ``plan.refresh``
   between them — auto first, then each tier not yet taken, forced — each
   checked against a float64 edge-wise mean on sampled rows;
8. the twin examples ``examples/tsne_torch.py`` and
   ``examples/meanshift_torch.py`` on the card, which must print
   "clusters separated OK" and "converged to modes OK";
9. batched plans: ``kv_plan_batch(k, with_bsr=True)`` over Qwen2-0.5B's
   prefilled keys (24 layers x 2 kv heads = 48 members), whose
   ``matvec(backend="cuda")`` must be ONE launch of the batched SpMV kernel
   (held against ``bsr``), and ``plan_prefill`` through those orderings
   held against ``prefill`` (float32, budgets covering every tile);
10. serving Qwen2-0.5B through ``Engine(backend="clusterkv")``: 4 slots,
   ``max_seq`` 8192, prefill bucket 1024, 8 requests of 2048-6144 seeded
   tokens, 32 new tokens each (prefill ms per request, decode ms per tick,
   tokens/s); a scalar-position ``decode_step`` loop (the decode kernel's
   plain mode); and a float32 run with budgets covering every tile that
   must give the flash engine's greedy tokens and first-token logits
   within 1e-3 x scale;

then B5 and B6 are timed at the serving path's shapes beside their plain
versions, SDPA with the equivalent mask (B6) and their bounds (B6's at the
bf16 tensor-core rate); B5 also at the covering budget (64 tiles). B5's
``ms`` is the time per call back to back, what the serving path pays;
its ``device_ms``, one call replayed as a CUDA graph, is the launches'
device time without the host's, which is the larger part of a call.

Launch counters are set to 0 just before each path (phases 3-4, 6, 7, 9,
10) and read just after it; launches made to compare or time a kernel are
not counted. Every kernel must have been launched by a path: B6 by the
prefills, B5 by the ticks (plan mode) and the scalar steps (plain mode),
B1 once per 48-member ``PlanBatch.matvec``.

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
import importlib.util
import json
import re
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
# float32 outside the tensor cores: the rate of every kernel that computes
# on the CUDA cores (B1-B4, B5, and B6 in float32)
FP32_FLOP_PER_S = 67e12
# bf16 on the tensor cores, dense: B6's bf16 path computes its products
# there (mma.sync, bf16 in, float32 accumulate), so its least time is
# stated at this rate, not at the float32 one
BF16_FLOP_PER_S = 989e12
# γ's pair terms, counted by what they issue on an SM (CUDA C Programming
# Guide, arithmetic instruction throughput, compute capability 9.0): one
# exponential on the special-function units, which take 16 ex2 a clock on
# each SM, and 5 instructions on the FMA pipe, which takes 128 a clock on
# each SM: two subtractions, a multiply and a fused multiply-add for
# -|c_p - c_q|^2 over prescaled coordinates, and the weighted accumulate
GAMMA_EX2_PER_CLOCK_SM = 16
GAMMA_FMA_PER_CLOCK_SM = 128
GAMMA_FMA_PER_PAIR = 5
# the H100 SXM's SM count and its highest SM clock (MHz), used by the CPU
# rehearsal only: on a card both are read from the card
H100_SMS, H100_MAX_SM_MHZ = 132, 1980

# float32 operations counted per t-SNE pair at embedding dimension d (a
# multiply-add counts two): d subtractions, d multiply-adds for |diff|^2,
# one add and one reciprocal for q, one multiply for p*q, d multiply-adds
# into the force
def tsne_ops_per_pair(d: int) -> int:
    return 5 * d + 3


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

    def device_time(self, fn, iters: int) -> float:
        """ms of device work per call of ``fn``: one call captured in a
        CUDA graph and the graph replayed, so that the host's time to
        launch (Python, ctypes) is left out. Reported beside the time per
        call, never in its place. The plain timer on the CPU (rehearsal
        only)."""
        if self.device.type != "cuda":
            return self(fn, iters)
        fn()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            fn()
        return self(graph.replay, iters)


def bf16_spacing(x):
    """The distance between adjacent bf16 values at each element's
    magnitude (8 significant bits), 0 at exact zeros."""
    _, e = torch.frexp(x)
    return torch.where(x == 0, 0.0, torch.ldexp(torch.ones_like(x), e - 8))


def check_close(name: str, got, want, rel_tol: float = REL_TOL,
                bf16_ulps: int = 0):
    """max-abs error of ``got`` against ``want``; raises where an element
    differs by more than ``rel_tol * max|want|`` plus ``bf16_ulps`` bf16
    spacings at that element's magnitude."""
    if tuple(got.shape) != tuple(want.shape):
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite values")
    diff = (got - want).abs()
    err = float(diff.max())
    scale = float(want.abs().max())
    limit = rel_tol * max(scale, 1e-30)
    if bf16_ulps:
        limit = limit + bf16_ulps * bf16_spacing(want)
    if bool((diff > limit).any()):
        raise AssertionError(f"{name}: max-abs error {err:.3e} exceeds "
                             f"{rel_tol:g} x scale {scale:.3e}"
                             + (f" + {bf16_ulps} bf16 spacing"
                                if bf16_ulps else ""))
    return err, scale


def ptxas_summary(report: str, kernel: str) -> list:
    """Registers and spills of each instantiation of ``kernel`` from the
    ``-Xptxas -v`` report of the kernel build (mangled names: the first
    template argument, the tile height, names the instantiation)."""
    rows = []
    blocks = re.split(r"Compiling entry function '", report)[1:]
    for blk in blocks:
        name = blk.split("'", 1)[0]
        if kernel not in name:
            continue
        tile = re.search(kernel + r"ILi(\d+)E", name)
        regs = re.search(r"Used (\d+) registers", blk)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", blk)
        rows.append({"kernel": f"{kernel}<{tile.group(1) if tile else '?'}>",
                     "registers": int(regs.group(1)) if regs else None,
                     "spill_stores": int(spill.group(1)) if spill else None,
                     "spill_loads": int(spill.group(2)) if spill else None})
    return rows


def spmv_bound(kept_tiles: int, bs: int, col_idx_numel: int, x_numel: int,
               y_numel: int, f: int):
    """Least time for the ELL-BSR product: each kept tile, the index array,
    the charges and the result cross device memory once; 2 flops per tile
    entry and feature column."""
    byts = 4 * (kept_tiles * bs * bs + col_idx_numel + x_numel + y_numel)
    ops = 2 * kept_tiles * bs * bs * f
    t_b, t_o = byts / HBM_BYTES_PER_S * 1e3, ops / FP32_FLOP_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def gamma_bound(n: int, bn: int, symmetric: bool, sms: int, sm_mhz: float):
    """Least time for the γ pair sum: the larger of its bytes (coordinates
    and weights in, the sum out), its FMA-pipe instructions and its
    exponentials, each at the card's rate for ``sms`` SMs at ``sm_mhz``.
    Returns (ms, "bytes" | "operations", which rate binds)."""
    nb = n // bn
    pairs = (nb * (nb + 1) // 2 if symmetric else nb * nb) * bn * bn
    clock = sms * sm_mhz * 1e6
    t_b = (n * 12 + 4) / HBM_BYTES_PER_S * 1e3
    t_f = pairs * GAMMA_FMA_PER_PAIR / (GAMMA_FMA_PER_CLOCK_SM * clock) * 1e3
    t_e = pairs / (GAMMA_EX2_PER_CLOCK_SM * clock) * 1e3
    t = max(t_b, t_f, t_e)
    if t == t_b:
        return t, "bytes", "HBM"
    return t, "operations", "ex2" if t_e >= t_f else "FMA pipe"


def tsne_bound(kept_tiles: int, bs: int, col_idx_numel: int, y_numel: int,
               f_numel: int, d: int):
    """Least time for the t-SNE force: each kept P tile, the index array,
    the embedding and the force cross device memory once; the pair
    arithmetic of every kept tile entry counts as operations."""
    byts = 4 * (kept_tiles * bs * bs + col_idx_numel + y_numel + f_numel)
    ops = kept_tiles * bs * bs * tsne_ops_per_pair(d)
    t_b, t_o = byts / HBM_BYTES_PER_S * 1e3, ops / FP32_FLOP_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def random_affinities(gen, n: int, bs: int, nbr: int, d: int, pad_slots: int,
                      device):
    """Random ELL affinity pattern on the card: ``nbr`` slots per row block
    of which the last ``pad_slots`` are padding (zero tile, column 0), and
    the target rows past ``n`` (a ragged last row block) zero."""
    n_rb = -(-n // bs)
    col = torch.randint(0, n_rb, (n_rb, nbr), generator=gen, device=device,
                        dtype=torch.int32)
    p = torch.rand((n_rb, nbr, bs, bs), generator=gen, device=device)
    p /= n_rb * bs
    col[:, nbr - pad_slots:] = 0
    p[:, nbr - pad_slots:] = 0.0
    rows = torch.arange(n_rb * bs, device=device).reshape(n_rb, bs)
    p *= (rows < n)[:, None, :, None]
    y = torch.randn((n_rb * bs, d), generator=gen, device=device)
    y[n:] = 0.0
    return p, col, y


def padded_masks(gen, shape, device):
    """ELL slot masks a plan's storage holds (kept counts spread over
    0..nbr as prefixes) or could hold (holes anywhere)."""
    nbr = shape[-1]
    counts = torch.randint(0, nbr + 1, tuple(shape[:-1]) + (1,),
                           generator=gen, device=device)
    return {"prefix": torch.arange(nbr, device=device) < counts,
            "holes": torch.rand(tuple(shape), generator=gen,
                                device=device) < 0.5}


def load_example(name: str):
    """A module of ``examples/`` (the t-SNE twin holds the P calibration)."""
    path = ROOT / "examples" / name
    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


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


def ell_width(rows, cols, pi, n: int, bs: int, device):
    """ELL width and kept tiles of a COO under ordering ``pi``, reckoned on
    the card before any tile tensor is dressed."""
    pi = torch.as_tensor(pi, device=device)
    inv = torch.empty_like(pi)
    inv[pi] = torch.arange(n, device=device)
    n_rb = -(-n // bs)
    tile = (inv[rows] // bs) * n_rb + inv[cols] // bs
    counts = torch.bincount(torch.unique(tile) // n_rb, minlength=n_rb)
    return int(counts.max()), int(counts.sum()), n_rb


def phase_tsne(args, dev, timer, sync, x, rehearse, reset_counts,
               collect_counts, k_tf):
    """Phase 6: t-SNE attraction through ``plan.tsne_attractive``."""
    from repro_torch import api
    from repro_torch.core.embedding import embed

    perplexity, k = 30.0, 90                  # JMLR 15 (2014): k = 3 x perp.
    bs, sb, steps = 32, 8, 20
    n = x.shape[0]
    tsne_ex = load_example("tsne_torch.py")
    say(f"== phase 6: t-SNE attraction, perplexity {perplexity:g}, "
        f"k={k}, d=2, bs={bs}, sb={sb}")
    while True:
        t0 = time.perf_counter()
        rows, cols, pv = tsne_ex.p_matrix(x[:n], k, perplexity, device=dev)
        sync()
        p_s = time.perf_counter() - t0
        pi = api.cluster_order(x[:n], d=3, device=dev)
        width, kept, n_rb = ell_width(rows, cols, pi, n, bs, dev)
        tile_bytes = n_rb * width * bs * bs * 4
        say(f"  n={n}: P {len(pv)} symmetrised edges in {p_s:.2f} s; ELL "
            f"width {width}, {kept} kept tiles ({kept / n_rb:.1f} per row "
            f"block), tile tensor {tile_bytes / 1e9:.3f} GB")
        if tile_bytes <= 16e9:
            break
        n //= 2
        say(f"  the tile tensor would pass 16 GB: n halved to {n}")
    t0 = time.perf_counter()
    plan = api.InteractionPlan.from_coo(rows, cols, pv, n, x=x[:n], d=3,
                                        bs=bs, sb=sb, device=dev)
    sync()
    plan_s = time.perf_counter() - t0
    b = plan.bsr
    tile_bytes = b.vals.numel() * 4
    say(f"  from_coo {plan_s:.2f} s: {plan}; ELL width {b.max_nbr} "
        f"(reckoned {width}), tile tensor {tile_bytes / 1e9:.3f} GB")

    # PCA initialisation, std 1e-4; learning rate n/12, exaggeration 12
    y0 = embed(x[:n], 2, device=dev)
    y = plan.permute(y0 / y0[:, 0].std() * 1e-4)
    lr, exagg, mom = n / 12.0, 12.0, 0.5
    vel = torch.zeros_like(y)
    sync()
    reset_counts()
    t0 = time.perf_counter()
    for _ in range(steps):
        f = plan.tsne_attractive(y)               # backend None: the kernel
        vel = mom * vel - lr * (4.0 * exagg * f)
        y = y + vel
        y = y - y.mean(0)
    sync()
    steps_s = time.perf_counter() - t0
    launches = collect_counts("t-SNE")
    if not rehearse and launches["tsne_force"] != steps:
        raise AssertionError(f"{steps} attraction steps launched tsne_force "
                             f"{launches['tsne_force']} times")
    say(f"  {steps} attraction steps: {steps_s:.3f} s "
        f"({steps_s / steps * 1e3:.3f} ms per step, host clock)")

    f = plan.tsne_attractive(y)
    again = plan.tsne_attractive(y)
    plain = plan.tsne_attractive(y, backend="bsr")
    sync()
    err, scale = check_close("tsne_attractive kernel vs bsr", f, plain)
    if not torch.equal(f, again):
        raise AssertionError("tsne_attractive is not reproducible")
    # float64 edge-wise sum over the COO on sampled rows
    r, c, v = plan.coo
    rng = np.random.default_rng(args.seed + 6)
    sample = np.sort(rng.choice(n, min(4096, n), replace=False))
    sel = np.isin(r, sample)
    rs, cs = (torch.from_numpy(a[sel]).to(dev) for a in (r, c))
    vs = torch.from_numpy(v[sel].astype(np.float64)).to(dev)
    yd = y.double()
    diff = yd[rs] - yd[cs]
    q = 1.0 / (1.0 + (diff * diff).sum(1))
    f64 = torch.zeros_like(yd).index_add_(0, rs, (vs * q)[:, None] * diff)
    smp = torch.from_numpy(sample).to(dev)
    err64, scale64 = check_close("tsne_attractive vs float64 edge sum",
                                 f[smp].double(), f64[smp],
                                 rel_tol=BACKEND_TOL)
    say(f"  force vs bsr: max-abs {err:.2e} (scale {scale:.2e}, tolerance "
        f"{REL_TOL:g} x scale), bit-reproducible; vs float64 edge sum on "
        f"{len(sample)} rows: {err64:.2e} (tolerance {BACKEND_TOL:g} x "
        "scale)")

    yp = torch.nn.functional.pad(y, (0, 0, 0, b.n_cb * b.bs - n))
    # the plan's force reads only kept tiles; skipping its zero tiles adds
    # exact zeros in the same order, so every slot gives the same bits
    every = k_tf.tsne_force(b.vals, b.col_idx, yp)[:n]
    sync()
    if not torch.equal(f, every):
        raise AssertionError("the force through the plan's mask differs "
                             "from the force over every slot")
    kept_plan = int(b.nbr_mask.sum())
    it_fast, it_slow = (2, 1) if rehearse else (20, 3)
    # ms: as the plan path launches it (the plan's mask, indices checked
    # where they were made); checked: the direct entry's per-call range
    # check (a host sync) on top; every slot: no mask, as before the kept
    # walk, padding streamed
    ms = timer(lambda: k_tf.tsne_force(b.vals, b.col_idx, yp, b.nbr_mask,
                                       indices_checked=True), it_fast)
    checked_ms = timer(lambda: k_tf.tsne_force(b.vals, b.col_idx, yp,
                                               b.nbr_mask), it_fast)
    every_ms = timer(lambda: k_tf.tsne_force(b.vals, b.col_idx, yp,
                                             indices_checked=True), it_fast)
    plain_ms = timer(lambda: k_tf.tsne_force_plain(b.vals, b.col_idx, yp,
                                                   b.nbr_mask), it_slow)
    step_ms = timer(lambda: plan.tsne_attractive(y), it_fast)
    bound, by = tsne_bound(kept_plan, b.bs, b.col_idx.numel(), yp.numel(),
                           b.n_rb * b.bs * 2, 2)
    kept_gb_s = kept_plan * b.bs * b.bs * 4 / ms * 1e-6
    say(f"  tsne_force: kernel {ms:.3f} ms as the plan launches it "
        f"({kept_gb_s:.0f} GB/s of kept tiles; with range check "
        f"{checked_ms:.3f} ms; every slot {every_ms:.3f} ms)  plain "
        f"{plain_ms:.3f} ms  bound {bound:.3f} ms ({by}); "
        f"plan.tsne_attractive end to end {step_ms:.3f} ms; force through "
        "the mask equals the force over every slot bit for bit")
    entry = {
        "name": "tsne_force", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/tsne_force.cu",
        "replaces": "src/repro/kernels/tsne_force.py:47",
        "launches": launches["tsne_force"],
        "shape": (f"p_vals ({b.n_rb}, {b.max_nbr}, {b.bs}, {b.bs}), "
                  f"{kept_plan} kept tiles, y ({yp.shape[0]}, 2)"),
        "max_abs_err": err, "ms": ms, "checked_ms": checked_ms,
        "every_slot_ms": every_ms, "kept_tile_gb_s": kept_gb_s,
        "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
        "library_ms": None}
    return {"n": n, "k": k, "perplexity": perplexity, "nnz": len(pv),
            "p_s": p_s, "from_coo_s": plan_s, "max_nbr": b.max_nbr,
            "kept_tiles": kept_plan, "tile_bytes": tile_bytes,
            "steps": steps, "steps_s": steps_s, "attractive_ms": step_ms,
            "err_vs_bsr": err, "err_vs_f64": err64, "entry": entry}


def phase_meanshift(args, dev, sync, n, n_clusters, rehearse, reset_counts,
                    collect_counts):
    """Phase 7: mean shift through every refresh tier."""
    from repro_torch import api
    from repro_torch.core import knn
    from repro_torch.data.pipeline import feature_mixture

    k, bs, sb = 30, 32, 8
    src = feature_mixture(n, 128, n_clusters=n_clusters, seed=args.seed + 7)
    say(f"== phase 7: mean shift with refresh tiers at n={n}, D=128, k={k}")
    rng = np.random.default_rng(args.seed + 7)
    src_d = torch.from_numpy(src).to(dev)
    t_d = src_d.clone()                       # targets start at the points
    # bandwidth from the data: the median squared distance to the k-th
    # neighbour of 4096 sampled targets
    smp = np.sort(rng.choice(n, min(4096, n), replace=False))
    _, d2 = knn.knn_graph(t_d[torch.from_numpy(smp).to(dev)], src_d, k,
                          device=dev)
    h2 = float(d2[:, -1].median())
    say(f"  h2 = {h2:.4f} (median squared distance to the {k}-th "
        f"neighbour over {len(smp)} sampled targets)")
    reset_counts()
    t0 = time.perf_counter()
    plan = api.build_plan(src, k=k, sources=src, bs=bs, sb=sb, ell_slack=2,
                          device=dev)
    sync()
    build_s = time.perf_counter() - t0
    say(f"  build_plan {build_s:.2f} s: {plan}, ELL width "
        f"{plan.bsr.max_nbr}")

    def step(plan, t_d):
        t0 = time.perf_counter()
        m = plan.meanshift_step(plan.permute(t_d), plan.permute(src_d), h2)
        sync()
        return m, (time.perf_counter() - t0) * 1e3

    def check_step(plan, t_d, m_s):
        """The step against a float64 edge-wise mean on sampled rows."""
        r, c, _ = plan.coo
        rows = np.sort(rng.choice(n, min(4096, n), replace=False))
        sel = np.isin(r, rows)
        rs, cs = (torch.from_numpy(a[sel]).to(dev) for a in (r, c))
        ts = plan.permute(t_d).double()
        ss = plan.permute(src_d).double()
        w = torch.exp(-((ts[rs] - ss[cs]) ** 2).sum(1) / h2)
        num = torch.zeros_like(ts).index_add_(0, rs, w[:, None] * ss[cs])
        den = torch.zeros(n, dtype=torch.float64, device=dev
                          ).index_add_(0, rs, w)
        want = num / den.clamp_min(1e-12)[:, None]
        pick = torch.from_numpy(rows).to(dev)
        return check_close("meanshift_step vs float64", m_s[pick].double(),
                           want[pick], rel_tol=BACKEND_TOL)[0]

    ch = torch.from_numpy(rng.standard_normal((n, 4)).astype(np.float32)
                          ).to(dev)
    m_s, ms = step(plan, t_d)
    err = check_step(plan, t_d, m_s)
    t_d = plan.unpermute(m_s)
    say(f"  step 0: {ms:.1f} ms, vs float64 edge mean {err:.2e}")
    rows_out = [{"step": 0, "step_ms": ms, "err_vs_f64": err}]
    taken = []
    policies = [None]
    for i in range(1, 4):
        policy = policies[i - 1] if i <= len(policies) else None
        t_np = t_d.cpu().numpy()
        t0 = time.perf_counter()
        plan = plan.refresh(t_np, policy=policy)
        sync()
        refresh_s = time.perf_counter() - t0
        st = plan.refresh_stats
        tier = st.last_action
        if policy is not None and tier != policy:
            raise AssertionError(f"forced {policy} ran as {tier} (a patch "
                                 "that overflows the ELL width escalates)")
        taken.append(tier)
        if i == 1:   # the tiers auto did not take, forced; patch last
            policies += [t for t in ("rebucket", "rebuild", "patch")
                         if t != tier]
        y_cuda = plan.matvec(ch)
        err_mv, _ = check_close(f"matvec after {tier}", y_cuda,
                                plan.matvec(ch, backend="bsr"),
                                rel_tol=BACKEND_TOL)
        m_s, ms = step(plan, t_d)
        err = check_step(plan, t_d, m_s)
        t_d = plan.unpermute(m_s)
        row = {"step": i, "policy": policy or "auto", "tier": tier,
               "refresh_s": refresh_s,
               "migrated_frac": st.last_migrated_frac,
               "drift_frac": st.ordering_drift_frac,
               "gamma": plan.gamma, "fill": plan.fill,
               "max_nbr": plan.bsr.max_nbr, "err_matvec": err_mv,
               "step_ms": ms, "err_vs_f64": err}
        rows_out.append(row)
        say(f"  refresh {i} ({policy or 'auto'}): {tier} in "
            f"{refresh_s:.2f} s, migrated {st.last_migrated_frac:.4f}, "
            f"gamma {plan.gamma:.3f}, fill {plan.fill:.4f}, ELL width "
            f"{plan.bsr.max_nbr}; matvec cuda vs bsr {err_mv:.2e}; step "
            f"{ms:.1f} ms, vs float64 edge mean {err:.2e}")
    launches = collect_counts("mean-shift")
    if sorted(taken) != ["patch", "rebucket", "rebuild"]:
        raise AssertionError(f"the refreshes ran {taken}, not every tier")
    if not rehearse and launches["bsr_spmv_batched"] <= 0:
        raise AssertionError("the refreshed plans never ran the matvec "
                             "kernel")
    return {"n": n, "k": k, "h2": h2, "build_s": build_s,
            "steps": rows_out}


def phase_examples(rehearse: bool):
    """Phase 8: the twin examples, each in its own process."""
    say("== phase 8: the twin examples" + (" (CPU)" if rehearse else ""))
    cpu = ["--device", "cpu"] if rehearse else []
    for script, extra, ok in (
            ("tsne_torch.py", ["--n", "512", "--iters", "220", "--k", "16"]
             if rehearse else [], "clusters separated OK"),
            ("meanshift_torch.py", [], "converged to modes OK")):
        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, str(ROOT / "examples" / script), *cpu, *extra],
            cwd=ROOT, capture_output=True, text=True, timeout=600)
        lines = r.stdout.strip().splitlines()
        if r.returncode != 0 or ok not in r.stdout:
            raise AssertionError(f"{script} failed (exit {r.returncode}):\n"
                                 + "\n".join(lines[-10:])
                                 + r.stderr[-2000:])
        say(f"  {script} {' '.join(cpu + extra) or '(defaults)'}: {lines[-1]} "
            f"({time.perf_counter() - t0:.1f} s)")


# ---------------------------------------------------------------------------
# ClusterKV attention kernels (B5, B6) and serving Qwen2-0.5B (phases 9-10)
# ---------------------------------------------------------------------------

# bf16 kernel-vs-plain tolerance: both round float32 results that differ in
# the last float32 bits (REL_TOL) to bf16, which can land them one bf16
# spacing apart, so each element may also differ by the spacing at its own
# magnitude
BF16_ULPS = 1
BF16_TOL_TEXT = f"{REL_TOL:g} x scale + {BF16_ULPS} bf16 spacing"
# serving check: first-token logits of the covering-budget ClusterKV engine
# against the flash engine, float32 (examples/serve_clusterkv.py's bound)
SERVE_TOL = 1e-3


def attention_inputs(gen, b, hq, hkv, s, dh, bq, n_sel, dtype, device):
    """Cluster-sorted k/v with a permuted position per key and, for every
    query tile, ``n_sel`` distinct key tiles drawn at random."""
    q = torch.randn((b, hq, s, dh), generator=gen, device=device).to(dtype)
    k = torch.randn((b, hkv, s, dh), generator=gen, device=device).to(dtype)
    v = torch.randn((b, hkv, s, dh), generator=gen, device=device).to(dtype)
    kpos = torch.stack([torch.randperm(s, generator=gen, device=device)
                        for _ in range(b * hkv)]).reshape(b, hkv, s)
    nqb = s // bq
    idx = torch.argsort(torch.rand((b, hkv, nqb, s // bq), generator=gen,
                                   device=device), dim=-1)[..., :n_sel]
    return (q, k, v, kpos.to(torch.int32),
            torch.arange(s, dtype=torch.int32, device=device),
            idx.to(torch.int32).contiguous())


def decode_inputs(gen, b, hkv, g, s, dh, bk, dtype, device, holes: float):
    """Plan-ordered caches: whole tiles shuffled with time order kept inside
    a tile, a fraction ``holes`` of slots marked INT32_MAX."""
    from repro_torch.core.clusterkv import block_centroids
    q = torch.randn((b, hkv * g, dh), generator=gen, device=device).to(dtype)
    k = torch.randn((b, hkv, s, dh), generator=gen, device=device).to(dtype)
    v = torch.randn((b, hkv, s, dh), generator=gen, device=device).to(dtype)
    nkb = s // bk
    order = torch.argsort(torch.rand((b, hkv, nkb), generator=gen,
                                     device=device), dim=-1)
    pos = (order[..., None] * bk + torch.arange(bk, device=device)
           ).reshape(b, hkv, s)
    if holes:
        pos[torch.rand(pos.shape, generator=gen, device=device) < holes] = \
            2 ** 31 - 1
    cent = block_centroids(k.float(), bk)
    return q, k, v, pos.to(torch.int32).contiguous(), cent


def block_attention_bound(b, hq, s, dh, bq, n_sel, elem: int):
    """Least time of B6: every selected (query tile, key tile) pair costs
    2 x 2 x bq x bk x dh operations (q.k and p.v), at the bf16 tensor-core
    rate in bf16 (``elem`` 2) and the float32 CUDA-core rate in float32;
    bytes are q, the kv heads' k and v, positions, indices and the output,
    each once."""
    ops = 4.0 * b * hq * (s // bq) * n_sel * bq * bq * dh
    byts = elem * (2 * b * hq * s * dh) + elem * 2 * b * 2 * s * dh \
        + 4 * (b * 2 * s + s + b * 2 * (s // bq) * n_sel)
    rate = BF16_FLOP_PER_S if elem == 2 else FP32_FLOP_PER_S
    t_b, t_o = byts / HBM_BYTES_PER_S * 1e3, ops / rate * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def decode_bound(b, hkv, g, s, dh, bk, n_sel, elem: int, plan_mode: bool):
    """Least time of B5: the selected k/v tiles, the positions (of the whole
    cache in plan mode, of the selected tiles otherwise), the float32
    centroids, q and the output (both in the caches' dtype) each cross
    device memory once; 2 x g operations per selected key entry for q.k and
    again for p.v."""
    sel = b * hkv * n_sel * bk
    byts = elem * sel * 2 * dh + 4 * (b * hkv * s if plan_mode else sel) \
        + 4 * b * hkv * (s // bk) * dh + elem * 2 * b * hkv * g * dh
    ops = 4.0 * g * sel * dh
    t_b, t_o = byts / HBM_BYTES_PER_S * 1e3, ops / FP32_FLOP_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def check_attention_kernels(args, dev, rehearse, cases):
    """Phase 2, B5 and B6: each kernel against its plain version."""
    from repro_torch.core.clusterkv import (block_centroids, decode_select,
                                            plan_select)
    from repro_torch.kernels import block_attention as k_ba
    from repro_torch.kernels import decode_attend as k_da

    gen = torch.Generator(device=dev).manual_seed(args.seed + 20)
    s6 = 512 if rehearse else 2048
    for dtype in (torch.float32, torch.bfloat16):
        ulps = 0 if dtype == torch.float32 else BF16_ULPS
        tol = f"{REL_TOL:g} x scale" if ulps == 0 else BF16_TOL_TEXT
        for bq in (128, 64):
            for causal in (True, False):
                q, k, v, kpos, qpos, idx = attention_inputs(
                    gen, 1, 14, 2, s6, 64, bq, 8, dtype, dev)
                got = k_ba.block_attention(q, k, v, kpos, qpos, idx, bq=bq,
                                           bk=bq, causal=causal)
                want = k_ba.block_attention_plain(q, k, v, kpos, qpos, idx,
                                                  bq=bq, bk=bq,
                                                  causal=causal)
                err, scale = check_close(
                    f"block_attention {dtype} bq={bq} causal={causal}",
                    got.float(), want.float(), bf16_ulps=ulps)
                cases.append({"kernel": "block_attention",
                              "dtype": str(dtype), "S": s6, "g": 7,
                              "dh": 64, "bq": bq, "n_sel": 8,
                              "causal": causal, "max_abs_err": err,
                              "scale": scale, "tolerance": tol})
                say(f"  B6 {str(dtype):14s} S={s6} g=7 dh=64 bq=bk={bq} "
                    f"causal={causal!s:5s}: err {err:.2e} (scale "
                    f"{scale:.2f}, tolerance {tol})")
    b, s5, bk, n_sel = 4, (2048 if rehearse else 8192), 128, 16
    qpos = torch.tensor([s5 - 500, s5 // 3, s5 - 1, 40], dtype=torch.int32,
                        device=dev)
    for dtype in (torch.float32, torch.bfloat16):
        ulps = 0 if dtype == torch.float32 else BF16_ULPS
        tol = f"{REL_TOL:g} x scale" if ulps == 0 else BF16_TOL_TEXT
        for g in (1, 7):
            for mode in ("plain", "plan", "plan+self"):
                plan_mode = mode != "plain"
                q, k, v, pos, cent = decode_inputs(
                    gen, b, 2, g, s5, 64, bk, dtype, dev,
                    holes=0.2 if plan_mode else 0.0)
                ks = torch.randn((b, 2, 64), generator=gen,
                                 device=dev).to(dtype)
                vs = torch.randn((b, 2, 64), generator=gen,
                                 device=dev).to(dtype)
                kw = dict(n_sel=n_sel, bk=bk, plan_mode=plan_mode,
                          has_self=mode == "plan+self", window=bk)
                sel = torch.zeros((b, 2, n_sel), dtype=torch.int32,
                                  device=dev)
                got = k_da.decode_attend_fused(
                    q, k, v, pos, cent, qpos, ks, vs,
                    sel_out=None if rehearse else sel, **kw)
                want = k_da.decode_attend_plain(q, k, v, pos, cent, qpos, ks,
                                                vs, **kw)
                err, scale = check_close(
                    f"decode_attend {dtype} g={g} {mode}", got.float(),
                    want.float(), bf16_ulps=ulps)
                if plan_mode:
                    want_sel = plan_select(q, pos, cent, qpos, n_sel=n_sel,
                                           bk=bk, window=bk)
                else:
                    want_sel = decode_select(q.float(), cent, n_sel)
                # the same set of tiles; their order may differ where two
                # scores differ in the last bits only (it changes nothing
                # but the order of the softmax sums)
                want_sel = want_sel.long()
                same = rehearse or torch.equal(
                    sel.long().sort(-1).values, want_sel.sort(-1).values)
                if not same:
                    raise AssertionError(f"decode_attend {dtype} g={g} "
                                         f"{mode}: tile selection differs")
                ordered = rehearse or torch.equal(sel.long(), want_sel)
                cases.append({"kernel": "decode_attend_fused",
                              "dtype": str(dtype), "S": s5, "B": b, "g": g,
                              "mode": mode, "n_sel": n_sel,
                              "max_abs_err": err, "scale": scale,
                              "tolerance": tol, "selection_equal": True,
                              "selection_order_equal": bool(ordered)})
                say(f"  B5 {str(dtype):14s} B={b} S={s5} g={g} "
                    f"{mode:9s}: err {err:.2e} (scale {scale:.2f}, "
                    f"tolerance {tol}), selected tiles equal"
                    + ("" if ordered else " (order differs)"))
    # ROADMAP C15: a key tile holding NaN scores NaN; the kernel must select
    # it first, as topk_stable (and the reference's lax.top_k) rank it, and
    # the rows of its kv head come out NaN as in the plain version
    for dtype in (torch.float32, torch.bfloat16):
        ulps = 0 if dtype == torch.float32 else BF16_ULPS
        for mode in ("plain", "plan"):
            plan_mode = mode == "plan"
            q, k, v, pos, _ = decode_inputs(gen, b, 2, 7, s5, 64, bk, dtype,
                                            dev, holes=0.2 if plan_mode
                                            else 0.0)
            k[1, 0, 3 * bk:4 * bk] = float("nan")
            pos[1, 0, 3 * bk] = 0                 # one live entry at least
            cent = block_centroids(k.float(), bk)
            kw = dict(n_sel=n_sel, bk=bk, plan_mode=plan_mode,
                      has_self=False, window=bk)
            sel = torch.zeros((b, 2, n_sel), dtype=torch.int32, device=dev)
            got = k_da.decode_attend_fused(q, k, v, pos, cent, qpos,
                                           sel_out=None if rehearse else sel,
                                           **kw)
            want = k_da.decode_attend_plain(q, k, v, pos, cent, qpos, **kw)
            if plan_mode:
                want_sel = plan_select(q, pos, cent, qpos, n_sel=n_sel,
                                       bk=bk, window=bk).long()
            else:
                want_sel = decode_select(q.float(), cent, n_sel).long()
            if rehearse:
                sel = want_sel.to(torch.int32)
            nan = torch.isnan(want.float())
            if not (nan[1, :7].all() and int(want_sel[1, 0, 0]) == 3):
                raise AssertionError("the plain version did not select the "
                                     "NaN tile first")
            if int(sel[1, 0, 0]) != 3 or not torch.equal(
                    sel.long().sort(-1).values, want_sel.sort(-1).values):
                raise AssertionError(f"decode_attend {dtype} {mode} with a "
                                     "NaN key tile: tile selection differs")
            if not torch.equal(torch.isnan(got.float()), nan):
                raise AssertionError(f"decode_attend {dtype} {mode} with a "
                                     "NaN key tile: NaN rows differ")
            err, scale = check_close(
                f"decode_attend {dtype} {mode} NaN key tile",
                torch.where(nan, 0.0, got.float()),
                torch.where(nan, 0.0, want.float()), bf16_ulps=ulps)
            cases.append({"kernel": "decode_attend_fused",
                          "dtype": str(dtype), "S": s5, "B": b, "g": 7,
                          "mode": mode, "nan_key_tile": True,
                          "n_sel": n_sel, "max_abs_err": err,
                          "scale": scale, "selection_equal": True,
                          "nan_rows": int(nan.any(-1).sum())})
            say(f"  B5 {str(dtype):14s} B={b} S={s5} g=7 {mode:9s} one NaN "
                f"key tile: selected first, selected tiles equal, "
                f"{int(nan.any(-1).sum())} NaN rows as in the plain "
                f"version, err elsewhere {err:.2e}")


def time_attention_kernels(args, dev, timer, rehearse, launches):
    """B5 and B6 at the serving path's shapes, with their bounds."""
    from repro_torch.kernels import block_attention as k_ba
    from repro_torch.kernels import decode_attend as k_da

    gen = torch.Generator(device=dev).manual_seed(args.seed + 21)
    it_fast, it_slow = (2, 1) if rehearse else (20, 3)
    entries = []
    dtype = torch.float32 if rehearse else torch.bfloat16
    elem = 4 if rehearse else 2
    # B6: one layer's prefill of a 4096-token prompt at Qwen2-0.5B
    s6, n6 = (512, 4) if rehearse else (4096, 16)
    q, k, v, kpos, qpos, idx = attention_inputs(gen, 1, 14, 2, s6, 64, 128,
                                                n6, dtype, dev)
    run = lambda: k_ba.block_attention(q, k, v, kpos, qpos, idx, bq=128,
                                       bk=128)
    plain = lambda: k_ba.block_attention_plain(q, k, v, kpos, qpos, idx,
                                               bq=128, bk=128)
    got = run()
    err, _ = check_close("block_attention at the prefill shape",
                         got.float(), plain().float(),
                         bf16_ulps=0 if rehearse else BF16_ULPS)
    ms, plain_ms = timer(run, it_fast), timer(plain, it_slow)
    # the library yardstick: scaled_dot_product_attention over the same
    # keys with the equivalent boolean mask (selected tiles AND causal)
    g = 7
    tile_of = torch.arange(s6, device=dev) // 128
    sel = torch.zeros((1, 2, s6 // 128, s6 // 128), dtype=torch.bool,
                      device=dev)
    sel.scatter_(-1, idx.long(), True)
    mask = sel[:, :, :, tile_of].repeat_interleave(128, dim=2)
    mask &= kpos[:, :, None, :] <= qpos[None, None, :, None]
    mask = mask.repeat_interleave(g, dim=1)
    kx, vx = k.repeat_interleave(g, dim=1), v.repeat_interleave(g, dim=1)
    lib_ms = timer(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, kx, vx, attn_mask=mask), it_fast)
    del mask, kx, vx, sel
    bound, by = block_attention_bound(1, 14, s6, 64, 128, n6, elem)
    say(f"  block_attention B=1 Hq=14 S={s6} n_sel={n6} {dtype}: kernel "
        f"{ms:.3f} ms  plain {plain_ms:.3f} ms  library (SDPA, boolean "
        f"mask) {lib_ms:.3f} ms  bound {bound:.3f} ms ({by})")
    entries.append({
        "name": "block_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/block_attention.cu",
        "replaces": "src/repro/kernels/block_attention.py:60",
        "launches": launches.get("block_attention", 0),
        "shape": (f"q (1, 14, {s6}, 64) {dtype}, k/v (1, 2, {s6}, 64), "
                  f"bq=bk=128, n_sel={n6}, causal"),
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound, "bound_by": by, "library_ms": lib_ms})
    del q, k, v, kpos, qpos, idx, got
    # B5: one layer's tick of the engine (4 slots, plan mode, no self
    # column), and the covering budget of phase 10's check (every tile)
    b, s5 = (2, 1024) if rehearse else (4, 8192)
    q, k, v, pos, cent = decode_inputs(gen, b, 2, 7, s5, 64, 128, dtype, dev,
                                       holes=0.0)
    qp = torch.tensor([s5 - 1, s5 // 2, s5 // 3, s5 // 4][:b],
                      dtype=torch.int32, device=dev)
    shapes = {}
    for what, n5 in (("tick", 4 if rehearse else 16),
                     ("covering", s5 // 128)):
        kw = dict(n_sel=n5, bk=128, plan_mode=True, has_self=False,
                  window=128)
        run = lambda: k_da.decode_attend_fused(q, k, v, pos, cent, qp, **kw)
        plain = lambda: k_da.decode_attend_plain(q, k, v, pos, cent, qp,
                                                 **kw)
        err, _ = check_close(f"decode_attend at the {what} shape",
                             run().float(), plain().float(),
                             bf16_ulps=0 if rehearse else BF16_ULPS)
        # the time per call back to back (what the serving path pays, the
        # host's launch cost included) and the launches' device time alone
        # (graph replay)
        ms, plain_ms = timer(run, it_fast), timer(plain, it_slow)
        device_ms = timer.device_time(run, it_fast)
        bound, by = decode_bound(b, 2, 7, s5, 64, 128, n5, elem, True)
        say(f"  decode_attend_fused B={b} Hkv=2 g=7 S={s5} n_sel={n5} "
            f"{dtype} plan mode ({what}): kernel {ms:.4f} ms a call back to "
            f"back ({device_ms:.4f} ms device, graph replay)  plain "
            f"{plain_ms:.3f} ms  bound {bound:.4f} ms ({by}); {b * 2} "
            f"selection + {b * 2 * n5} part + {b * 2} combine blocks")
        shapes[what] = dict(n_sel=n5, max_abs_err=err, ms=ms,
                            device_ms=device_ms, plain_ms=plain_ms,
                            bound_ms=bound, bound_by=by)
    tick = shapes["tick"]
    cover = shapes["covering"]
    entries.append({
        "name": "decode_attend_fused", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode_attend.cu",
        "replaces": "src/repro/kernels/decode_attend.py:137",
        "launches": launches.get("decode_attend_fused", 0),
        "shape": (f"q ({b}, 14, 64), k/v ({b}, 2, {s5}, 64) {dtype}, "
                  f"bk=128, n_sel={tick['n_sel']}, plan mode"),
        "max_abs_err": tick["max_abs_err"], "ms": tick["ms"],
        "device_ms": tick["device_ms"],
        "plain_ms": tick["plain_ms"], "bound_ms": tick["bound_ms"],
        "bound_by": tick["bound_by"], "library_ms": None,
        "covering": cover})
    return entries


def qwen_config(rehearse: bool):
    """Qwen2-0.5B at full width (its own ClusterKV defaults), or the reduced
    twin with small tiles for the CPU rehearsal."""
    from repro_torch.configs import ClusterKVConfig, get_config, reduced_config
    if rehearse:
        return reduced_config("qwen2-0.5b").with_(
            clusterkv=ClusterKVConfig(enabled=True, block_q=32, block_k=32,
                                      blocks_per_query=4, decode_clusters=4))
    return get_config("qwen2-0.5b")


def phase_plan_batch(args, dev, sync, cfg, params, rehearse, reset_counts,
                     collect_counts, k_bsr):
    """Phase 9: batched plans over Qwen's prefilled layer keys."""
    import dataclasses
    from repro_torch.core import clusterkv as ckv
    from repro_torch.models import transformer as tf

    s = 256 if rehearse else 2048
    nkb = s // cfg.clusterkv.block_k
    # budgets cover every tile at this length, so prefill through any key
    # ordering is exact attention: plan_prefill must match prefill
    cfg32 = cfg.with_(dtype="float32", clusterkv=dataclasses.replace(
        cfg.clusterkv, blocks_per_query=nkb))
    say(f"== phase 9: batched plans over {cfg.name}'s layer keys, S={s}")
    rng = np.random.default_rng(args.seed + 9)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (1, s))).to(dev)
    reset_counts()
    cache, logits = tf.prefill(params, cfg32, {"tokens": tokens}, "clusterkv")
    keys = cache["k"]                             # (L, 1, Hkv, S, dh)
    t0 = time.perf_counter()
    pb = ckv.kv_plan_batch(keys, with_bsr=True)
    sync()
    build_s = time.perf_counter() - t0
    members = cfg.n_layers * cfg.n_kv_heads
    if pb.batch != members:
        raise AssertionError(f"{pb.batch} members, expected {members}")
    xs = torch.from_numpy(rng.standard_normal((pb.batch, pb.capacity, 1))
                          .astype(np.float32)).to(dev)
    n0 = k_bsr.bsr_spmv_batched.launches
    y = pb.matvec(xs, backend="cuda")
    sync()
    one = k_bsr.bsr_spmv_batched.launches - n0
    if not rehearse and one != 1:
        raise AssertionError(f"PlanBatch.matvec launched the batched kernel "
                             f"{one} times for {pb.batch} members")
    err_mv, scale_mv = check_close("PlanBatch.matvec cuda vs bsr", y,
                                   pb.matvec(xs, backend="bsr"),
                                   rel_tol=BACKEND_TOL)
    perms = ckv.plan_batch_perm(pb, (cfg.n_layers, 1, cfg.n_kv_heads))
    got = tf.plan_prefill(params, cfg32, {"tokens": tokens}, perms)
    sync()
    err_pf, scale_pf = check_close("plan_prefill vs prefill", got, logits,
                                   rel_tol=SERVE_TOL)
    if int(got.argmax()) != int(logits.argmax()):
        raise AssertionError("plan_prefill and prefill pick other tokens")
    launches = collect_counts("plan batch")
    say(f"  kv_plan_batch: {pb} in {build_s:.2f} s (ELL width "
        f"{pb.spec.max_nbr}, mean fill {np.mean(pb.fills):.3f})")
    say(f"  PlanBatch.matvec B={pb.batch}: {one} launch of the batched "
        f"kernel; cuda vs bsr max-abs {err_mv:.2e} (scale {scale_mv:.2f})")
    say(f"  plan_prefill vs prefill (float32, budgets cover all {nkb} "
        f"tiles): last logits max-abs {err_pf:.2e} (scale {scale_pf:.2f}, "
        f"tolerance {SERVE_TOL:g} x scale), same argmax")
    return {"S": s, "members": pb.batch, "capacity": pb.capacity,
            "max_nbr": pb.spec.max_nbr, "build_s": build_s,
            "matvec_launches": one, "err_matvec": err_mv,
            "err_plan_prefill": err_pf, "launches": launches}


def phase_serve(args, dev, sync, cfg, params, rehearse, reset_counts,
                collect_counts):
    """Phase 10: serving Qwen2-0.5B through ``Engine(backend="clusterkv")``."""
    import dataclasses
    from repro_torch.models import model_api
    from repro_torch.models import transformer as tf
    from repro_torch.train.serve_loop import Engine, Request

    if rehearse:
        slots, max_seq, bucket, n_req, max_new = 2, 256, 64, 4, 6
        lo, hi = 16, 120
    else:
        slots, max_seq, bucket, n_req, max_new = 4, 8192, 1024, 8, 32
        lo, hi = 2048, 6144
    say(f"== phase 10: serving {cfg.name} ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.dtype}) through Engine(backend='clusterkv'): "
        f"slots={slots}, max_seq={max_seq}, bucket={bucket}, {n_req} "
        f"requests of {lo}-{hi} tokens, max_new={max_new}")
    rng = np.random.default_rng(args.seed + 10)
    reqs = [Request(rid=i, tokens=rng.integers(0, cfg.vocab, int(
        rng.integers(lo, hi + 1))).astype(np.int64), max_new=max_new)
        for i in range(n_req)]
    eng = Engine(cfg, params, slots=slots, max_seq=max_seq,
                 prefill_bucket=bucket, backend="clusterkv", device=dev)
    for r in reqs:
        eng.submit(r)
    sync()
    reset_counts()
    t0 = time.perf_counter()
    eng.run()
    sync()
    wall = time.perf_counter() - t0
    launches = collect_counts("serving (Engine)")
    plan_mode = launches["decode_attend_fused.plan_mode"]
    if not rehearse:
        if launches["block_attention"] != cfg.n_layers * n_req:
            raise AssertionError(f"prefills launched block_attention "
                                 f"{launches['block_attention']} times")
        if plan_mode != cfg.n_layers * eng.ticks or \
                launches["decode_attend_fused"] != plan_mode:
            raise AssertionError(f"{eng.ticks} ticks launched the plan-mode "
                                 f"decode kernel {plan_mode} times")
    for r in reqs:
        if len(r.output) != max_new or not all(0 <= t < cfg.vocab
                                               for t in r.output):
            raise AssertionError(f"request {r.rid}: output {r.output}")
    for rid, lg in eng.first_logits.items():
        if not torch.isfinite(lg).all():
            raise AssertionError(f"request {rid}: non-finite logits")
    generated = sum(len(r.output) for r in reqs)
    pre = [t * 1e3 for t in eng.timings["prefill_s"]]
    tick = [t * 1e3 for t in eng.timings["tick_s"]]
    say(f"  {n_req} requests, {generated} tokens in {wall:.2f} s: "
        f"{generated / wall:.1f} tokens/s; {eng.ticks} ticks")
    say(f"  prefill ms per request: "
        + ", ".join(f"{len(r.tokens)}->{t:.1f}" for r, t in zip(reqs, pre)))
    say(f"  decode ms per tick: median {float(np.median(tick)):.2f}, mean "
        f"{float(np.mean(tick)):.2f}, min {min(tick):.2f}, max "
        f"{max(tick):.2f}")

    # plain-mode decode kernel: a scalar-position decode_step loop
    steps = 8
    plen = 64 if rehearse else 2048
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (1, plen))).to(dev)
    cache, logits = tf.prefill(params, cfg, {"tokens": toks}, "clusterkv")
    cache = model_api.grow_cache(cfg, cache, 2 * plen)
    sync()
    reset_counts()
    nxt = logits.argmax(-1)[:, None]
    t0 = time.perf_counter()
    for _ in range(steps):
        logits, cache = tf.decode_step(params, cfg, cache, nxt, "clusterkv")
        nxt = logits.argmax(-1)[:, None]
    sync()
    step_ms = (time.perf_counter() - t0) * 1e3 / steps
    launches_p = collect_counts("scalar decode_step")
    plain_mode = launches_p["decode_attend_fused.plain_mode"]
    if not rehearse and (plain_mode != cfg.n_layers * steps or
                         launches_p["decode_attend_fused"] != plain_mode):
        raise AssertionError(f"{steps} scalar decode steps launched the "
                             f"plain-mode decode kernel {plain_mode} times")
    if not torch.isfinite(logits).all():
        raise AssertionError("scalar decode_step: non-finite logits")
    say(f"  scalar decode_step over a {plen}-token prompt in a "
        f"{2 * plen}-slot cache: {step_ms:.2f} ms per step (host clock)")

    # correctness: float32, budgets covering every tile -> exact attention;
    # the ClusterKV engine must give the flash engine's greedy tokens
    cover = max_seq // cfg.clusterkv.block_k
    cfgc = cfg.with_(dtype="float32", clusterkv=dataclasses.replace(
        cfg.clusterkv, blocks_per_query=cover, decode_clusters=cover))
    n_chk, new_chk = 2, 8
    chk = [rng.integers(0, cfg.vocab, int(n)).astype(np.int64)
           for n in ((40, 70) if rehearse else (2048, 3000))]
    outs, firsts = {}, {}
    for backend in ("flash", "clusterkv"):
        e = Engine(cfgc, params, slots=n_chk, max_seq=max_seq,
                   prefill_bucket=bucket, backend=backend, device=dev)
        rs = [Request(rid=i, tokens=t, max_new=new_chk)
              for i, t in enumerate(chk)]
        for r in rs:
            e.submit(r)
        e.run()
        outs[backend] = [r.output for r in rs]
        firsts[backend] = e.first_logits
    collect_counts("covering-budget check")
    if outs["flash"] != outs["clusterkv"]:
        raise AssertionError(f"clusterkv engine tokens {outs['clusterkv']} "
                             f"!= flash engine tokens {outs['flash']}")
    errs = [check_close(f"first-token logits request {i}",
                        firsts["clusterkv"][i], firsts["flash"][i],
                        rel_tol=SERVE_TOL) for i in range(n_chk)]
    say(f"  covering budgets (blocks_per_query = decode_clusters = {cover}), "
        f"float32: {n_chk} requests x {new_chk} tokens equal the flash "
        f"engine's token for token; first-token logits max-abs "
        + ", ".join(f"{e:.2e} (scale {s:.2f})" for e, s in errs)
        + f", tolerance {SERVE_TOL:g} x scale")
    return {"slots": slots, "max_seq": max_seq, "bucket": bucket,
            "requests": n_req, "prompt_tokens": [len(r.tokens) for r in reqs],
            "max_new": max_new, "generated": generated, "wall_s": wall,
            "tokens_per_s": generated / wall, "ticks": eng.ticks,
            "prefill_ms": pre, "tick_ms": tick,
            "tick_ms_median": float(np.median(tick)),
            "scalar_decode_ms": step_ms, "launches": launches,
            "scalar_decode_launches": launches_p,
            "check_tokens": outs["clusterkv"],
            "check_logit_err": [e for e, _ in errs]}


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
    from repro_torch.kernels import block_attention as k_ba
    from repro_torch.kernels import bsr_spmv as k_bsr
    from repro_torch.kernels import decode_attend as k_da
    from repro_torch.kernels import gamma_score as k_gs
    from repro_torch.kernels import ops
    from repro_torch.kernels import tsne_force as k_tf
    from repro_torch.models import model_api

    dev = torch.device("cpu" if rehearse else "cuda")
    timer = Timer(dev)
    t_start = time.perf_counter()
    wrappers = {"bsr_spmv_batched": k_bsr.bsr_spmv_batched,
                "bsr_spmv": k_bsr.bsr_spmv,
                "gamma_pairs": k_gs.gamma_pairs,
                "tsne_force": k_tf.tsne_force,
                "block_attention": k_ba.block_attention,
                "decode_attend_fused": k_da.decode_attend_fused}
    # the decode kernel's wrapper also counts its launches per contract
    mode_counters = {"decode_attend_fused.plain_mode": "plain_mode_launches",
                     "decode_attend_fused.plan_mode": "plan_mode_launches"}
    # launches by the paths (phases 3-4, 6, 7, 9, 10): counters are set to 0
    # just before a path and read just after it
    main_launches = dict.fromkeys(wrappers, 0)

    def reset_counts():
        for w in wrappers.values():
            w.launches = 0
        for attr in mode_counters.values():
            setattr(k_da.decode_attend_fused, attr, 0)

    def collect_counts(path: str) -> dict:
        got = {name: w.launches for name, w in wrappers.items()}
        for name, count in got.items():
            main_launches[name] += count
        modes = {name: getattr(k_da.decode_attend_fused, attr)
                 for name, attr in mode_counters.items()}
        say(f"  launches on the {path} path: {got}; decode modes {modes}")
        reset_counts()
        return {**got, **modes}

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
    sms, sm_mhz = H100_SMS, H100_MAX_SM_MHZ
    ptxas = []
    if not rehearse:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True)
        smi_line = smi.stdout.strip().splitlines()[0]
        say(f"card: {smi_line}")
        clk = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=60, check=True)
        sm_mhz = float(clk.stdout.strip().splitlines()[0])
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        say(f"{sms} SMs, highest SM clock {sm_mhz:g} MHz (nvidia-smi "
            "clocks.max.sm): the rates of B3's bound")
        say(f"matmul allow_tf32={torch.backends.cuda.matmul.allow_tf32}  "
            f"cudnn allow_tf32={torch.backends.cudnn.allow_tf32}")
        t0 = time.perf_counter()
        _build.load()
        say(f"kernel build: {time.perf_counter() - t0:.2f} s "
            f"({', '.join(p.name for p in _build._sources())})")
        ptxas = ptxas_summary(_build.ptxas_report(), "block_attention_mma")
        if not ptxas:
            raise AssertionError("no -Xptxas -v report of the bf16 B6 kernel")
        for row in ptxas:
            say(f"  ptxas {row['kernel']}: {row['registers']} registers, "
                f"{row['spill_stores']} bytes spill stores, "
                f"{row['spill_loads']} bytes spill loads")

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
            padded = padded_masks(gen, col.shape, dev)
            nan_vals = torch.where(padded["prefix"][..., None, None], vals,
                                   torch.full_like(vals, float("nan")))
            for f in (1, 8):
                xs = torch.randn((B, mat.n_cb * mat.bs, f), generator=gen,
                                 device=dev)
                got = k_bsr.bsr_spmv_batched(vals, col, xs)
                sync()
                want = k_bsr.bsr_spmv_batched_plain(vals, col, xs)
                err, scale = check_close(
                    f"bsr_spmv_batched {kind} B={B} f={f}", got, want)
                # timed as the plan path launches it (mask, no range check)
                ms = timer(lambda: k_bsr.bsr_spmv_batched(
                    vals, col, xs, mask, indices_checked=True), it_fast)
                checked_ms = timer(
                    lambda: k_bsr.bsr_spmv_batched(vals, col, xs), it_fast)
                plain_ms = timer(
                    lambda: k_bsr.bsr_spmv_batched_plain(vals, col, xs),
                    it_slow)
                lib_ms = time_library(timer, vals, col, mask, xs,
                                      it_slow)
                bound, by = spmv_bound(col.numel(), mat.bs, col.numel(),
                                       xs.numel(), got.numel(), f)
                case = {"kernel": "bsr_spmv_batched", "matrix": kind,
                        "n": n_micro, "B": B, "f": f, "max_abs_err": err,
                        "scale": scale, "ms": ms, "checked_ms": checked_ms,
                        "plain_ms": plain_ms, "library_ms": lib_ms,
                        "bound_ms": bound, "bound_by": by}
                micro_cases.append(case)
                say(f"  B1 {kind:9s} B={B} f={f}: err {err:.2e} (scale "
                    f"{scale:.1f})  kernel {ms:.3f} ms (with range check "
                    f"{checked_ms:.3f})  plain {plain_ms:.3f} ms  library "
                    f"{'n/a' if lib_ms is None else f'{lib_ms:.3f} ms'}  "
                    f"bound {bound:.3f} ms ({by})")
                if B == 1:
                    got2 = k_bsr.bsr_spmv(vals[0], col[0], xs[0])
                    sync()
                    want2 = k_bsr.bsr_spmv_plain(vals[0], col[0], xs[0])
                    err2, _ = check_close(
                        f"bsr_spmv {kind} f={f}", got2, want2)
                    ms2 = timer(lambda: k_bsr.bsr_spmv(
                        vals[0], col[0], xs[0], mask[0],
                        indices_checked=True), it_fast)
                    micro_cases.append(
                        {"kernel": "bsr_spmv", "matrix": kind, "n": n_micro,
                         "B": 1, "f": f, "max_abs_err": err2, "ms": ms2,
                         "bound_ms": bound, "bound_by": by})
                    say(f"  B2 {kind:9s}     f={f}: err {err2:.2e}  "
                        f"kernel {ms2:.3f} ms")
                for mname, mk, v in (("prefix", padded["prefix"], vals),
                                     ("holes", padded["holes"], vals),
                                     ("nan", padded["prefix"], nan_vals)):
                    got = k_bsr.bsr_spmv_batched(v, col, xs, mk)
                    again = k_bsr.bsr_spmv_batched(v, col, xs, mk,
                                                   indices_checked=True)
                    sync()
                    err, scale = check_close(
                        f"bsr_spmv_batched {kind} B={B} f={f} mask {mname}",
                        got, k_bsr.bsr_spmv_batched_plain(v, col, xs, mk))
                    if not torch.equal(got, again):
                        raise AssertionError("bsr_spmv_batched is not "
                                             "reproducible run to run")
                    case = {"kernel": "bsr_spmv_batched", "matrix": kind,
                            "mask": mname, "kept": int(mk.sum()),
                            "n": n_micro, "B": B, "f": f,
                            "max_abs_err": err, "scale": scale}
                    if B == 1:
                        got2 = k_bsr.bsr_spmv(v[0], col[0], xs[0], mk[0])
                        sync()
                        case["max_abs_err_bsr_spmv"], _ = check_close(
                            f"bsr_spmv {kind} f={f} mask {mname}", got2,
                            k_bsr.bsr_spmv_plain(v[0], col[0], xs[0],
                                                 mk[0]))
                    micro_cases.append(case)
                    say(f"  B1{'/B2' if B == 1 else '   '} {kind:9s} B={B} "
                        f"f={f} mask {mname:6s} ({case['kept']} of "
                        f"{mk.numel()} slots kept): err {err:.2e} (scale "
                        f"{scale:.1f}), bit-reproducible")
            del vals, col, mask, padded, nan_vals
        del mat
    n_pairs = 1024 if rehearse else 8192
    coords = torch.randint(0, 4096, (n_pairs, 2), generator=gen,
                           device=dev).float()
    wts = (torch.rand(n_pairs, generator=gen, device=dev) > 0.1).float()
    # σ = 1: terms between coordinates farther apart than about 10
    # underflow (the kernel's ex2 flushes them to zero, the plain version
    # keeps float32 denormals)
    for sigma, symmetric in ((exp.sigma, False), (exp.sigma, True),
                             (1.0, True)):
        got = k_gs.gamma_pairs(coords, sigma, 256, weights=wts,
                               symmetric=symmetric)
        again = k_gs.gamma_pairs(coords, sigma, 256, weights=wts,
                                 symmetric=symmetric)
        sync()
        want = k_gs.gamma_pairs_plain(coords, sigma, 256, weights=wts,
                                      symmetric=symmetric)
        err, scale = check_close(
            f"gamma_pairs sigma={sigma:g} symmetric={symmetric}",
            got.reshape(1), want.reshape(1))
        if got.item() != again.item():
            raise AssertionError("gamma_pairs is not reproducible run to run")
        micro_cases.append({"kernel": "gamma_pairs", "n": n_pairs,
                            "bn": 256, "sigma": sigma,
                            "symmetric": symmetric, "max_abs_err": err,
                            "scale": scale})
        say(f"  B3 n={n_pairs} bn=256 sigma={sigma:g} symmetric="
            f"{symmetric}: err {err:.2e} (sum {scale:.4e}), reproducible")
    for bs4 in (16, 32):
        for d4 in (2, 3):
            n4 = n_micro - 7                      # ragged last row block
            p4, c4, y4 = random_affinities(gen, n4, bs4, 16, d4, 3, dev)
            got = k_tf.tsne_force(p4, c4, y4)
            again = k_tf.tsne_force(p4, c4, y4)
            sync()
            want = k_tf.tsne_force_plain(p4, c4, y4)
            err, scale = check_close(f"tsne_force bs={bs4} d={d4}", got,
                                     want)
            if not torch.equal(got, again):
                raise AssertionError("tsne_force is not reproducible run "
                                     "to run")
            if (got[n4:] != 0).any():
                raise AssertionError("tsne_force: padded rows not zero")
            micro_cases.append({"kernel": "tsne_force", "n": n4, "bs": bs4,
                                "d": d4, "nbr": 16, "pad_slots": 3,
                                "max_abs_err": err, "scale": scale})
            say(f"  B4 n={n4} bs={bs4} d={d4} nbr=16 (3 padding): err "
                f"{err:.2e} (scale {scale:.2e}), bit-reproducible, padded "
                "rows exactly 0")
            padded = padded_masks(gen, c4.shape, dev)
            nan4 = torch.where(padded["prefix"][..., None, None], p4,
                               torch.full_like(p4, float("nan")))
            for mname, mk, v in (("prefix", padded["prefix"], p4),
                                 ("holes", padded["holes"], p4),
                                 ("nan", padded["prefix"], nan4)):
                got = k_tf.tsne_force(v, c4, y4, mk)
                again = k_tf.tsne_force(v, c4, y4, mk, indices_checked=True)
                sync()
                err, scale = check_close(
                    f"tsne_force bs={bs4} d={d4} mask {mname}", got,
                    k_tf.tsne_force_plain(v, c4, y4, mk))
                if not torch.equal(got, again):
                    raise AssertionError("tsne_force is not reproducible "
                                         "run to run under a mask")
                micro_cases.append({"kernel": "tsne_force", "n": n4,
                                    "bs": bs4, "d": d4, "nbr": 16,
                                    "mask": mname, "kept": int(mk.sum()),
                                    "max_abs_err": err, "scale": scale})
                say(f"  B4 n={n4} bs={bs4} d={d4} mask {mname:6s} "
                    f"({int(mk.sum())} of {mk.numel()} slots kept): err "
                    f"{err:.2e} (scale {scale:.2e}), bit-reproducible")
            del p4, c4, y4, padded, nan4
    check_attention_kernels(args, dev, rehearse, micro_cases)

    # ------------------------------------------------------------ 3 + 4 ---
    reset_counts()

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
    stage_s, max_nbr = dict(plan.host.timings), b.max_nbr
    stages = "  ".join(f"{name} {sec:.2f} s"
                       for name, sec in stage_s.items())
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
        y2 = ops.bsr_spmv(b.vals, b.col_idx, xs_sorted, plan.n,
                          nbr_mask=b.nbr_mask)
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

    launches = collect_counts("build_plan -> matvec")
    if not rehearse:
        for name in ("bsr_spmv_batched", "bsr_spmv", "gamma_pairs"):
            if launches[name] <= 0:
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
    kept_bytes = kept * b.bs * b.bs * 4
    entries = []
    spmv_rows = {}
    for f in (1, 8):
        xs = torch.randn((1, b.n_cb * b.bs, f), generator=gen, device=dev)
        lib_ms = time_library(timer, vals1, col1, mask1, xs, it_slow)
        bound, by = spmv_bound(kept, b.bs, col1.numel(), xs.numel(),
                               b.n_rb * b.bs * f, f)
        # run: as the plan path launches it (the plan's mask, indices
        # checked where they were built); checked: the direct entry's
        # per-call range check (a host sync) on top
        for name, run, checked, plain in (
                ("bsr_spmv_batched",
                 lambda: k_bsr.bsr_spmv_batched(vals1, col1, xs, mask1,
                                                indices_checked=True),
                 lambda: k_bsr.bsr_spmv_batched(vals1, col1, xs, mask1),
                 lambda: k_bsr.bsr_spmv_batched_plain(vals1, col1, xs,
                                                      mask1)),
                ("bsr_spmv",
                 lambda: k_bsr.bsr_spmv(vals1[0], col1[0], xs[0], mask1[0],
                                        indices_checked=True),
                 lambda: k_bsr.bsr_spmv(vals1[0], col1[0], xs[0], mask1[0]),
                 lambda: k_bsr.bsr_spmv_plain(vals1[0], col1[0], xs[0],
                                              mask1[0]))):
            got = run()
            sync()
            err, scale = check_close(f"{name} plan f={f}", got,
                                     plain())
            ms = timer(run, it_fast)
            row = {"f": f, "max_abs_err": err, "scale": scale, "ms": ms,
                   "checked_ms": timer(checked, it_fast),
                   "kept_tile_gb_s": kept_bytes / ms * 1e-6,
                   "plain_ms": timer(plain, it_slow), "library_ms": lib_ms,
                   "bound_ms": bound, "bound_by": by}
            spmv_rows[(name, f)] = row
            say(f"  {name:17s} f={f}: err {err:.2e}  kernel "
                f"{ms:.3f} ms ({row['kept_tile_gb_s']:.0f} GB/s of kept "
                f"tiles; with range check {row['checked_ms']:.3f} ms)  "
                f"plain {row['plain_ms']:.3f} ms  library "
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
    bound, by, rate = gamma_bound(nnz + pad, 256, True, sms, sm_mhz)
    g_row = {"ms": timer(run_gamma, it_fast),
             "plain_ms": timer(plain_gamma, 1)}
    say(f"  gamma_pairs nnz={nnz}: err {err:.2e} (sum {scale:.4e})  kernel "
        f"{g_row['ms']:.3f} ms  plain {g_row['plain_ms']:.3f} ms  bound "
        f"{bound:.3f} ms ({by}: {rate} at {sms} SMs x {sm_mhz:g} MHz)")
    entries.append({
        "name": "gamma_pairs", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/gamma_pairs.cu",
        "replaces": "src/repro/kernels/gamma_score.py:55",
        "launches": launches["gamma_pairs"],
        "shape": f"coords ({nnz + pad}, 2), bn=256, symmetric",
        "max_abs_err": err, "ms": g_row["ms"], "plain_ms": g_row["plain_ms"],
        "bound_ms": bound, "bound_by": by, "bound_rate": rate,
        "sm_mhz": sm_mhz, "library_ms": None})

    del plan, b, vals1, col1, mask1, charges
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # ---------------------------------------------------------------- 6 ---
    tsne = phase_tsne(args, dev, timer, sync, x, rehearse, reset_counts,
                      collect_counts, k_tf)
    entries.append(tsne.pop("entry"))
    del x

    # ---------------------------------------------------------------- 7 ---
    meanshift = phase_meanshift(args, dev, sync, n_main, n_clusters,
                                rehearse, reset_counts, collect_counts)

    # ---------------------------------------------------------------- 8 ---
    phase_examples(rehearse)

    # ----------------------------------------------------------- 9 + 10 ---
    cfg = qwen_config(rehearse)
    gen_w = torch.Generator(device=dev).manual_seed(args.seed)
    t0 = time.perf_counter()
    params = model_api.init(cfg, gen_w, device=dev)
    sync()
    say(f"== {cfg.name}: random weights from seed {args.seed} in "
        f"{time.perf_counter() - t0:.2f} s")
    plan_batch = phase_plan_batch(args, dev, sync, cfg, params, rehearse,
                                  reset_counts, collect_counts, k_bsr)
    serve = phase_serve(args, dev, sync, cfg, params, rehearse, reset_counts,
                        collect_counts)
    del params
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    say("== B5 and B6 at the serving path's shapes")
    entries += time_attention_kernels(args, dev, timer, rehearse,
                                      main_launches)

    say(f"  launches on all paths: {main_launches}")
    if not rehearse:
        for name, count in main_launches.items():
            if count <= 0:
                raise AssertionError(
                    f"kernel {name} was never launched by a path")
    for e in entries:
        e["launches"] = main_launches[e["name"]]

    # both lines are composed in the rehearsal too, so that a fault in
    # them shows on the CPU
    details = json.dumps({"ptxas_b6_bf16": ptxas,
                          "micro_cases": micro_cases,
                          "build_plan_s": build_s,
                          "stage_s": stage_s,
                          "matvec_ms": matvec_ms,
                          "plan_bytes": plan_bytes, "n": n_main,
                          "max_nbr": max_nbr, "kept_tiles": kept,
                          "gamma": {o: {"exact": g[0], "score": g[1]}
                                    for o, g in gammas.items()},
                          "tsne": tsne, "meanshift": meanshift,
                          "plan_batch": plan_batch, "serve": serve})
    kernels = json.dumps({"kernels": entries})
    say(f"== done in {time.perf_counter() - t_start:.1f} s")
    if rehearse:
        say("rehearsal on the CPU finished: every phase ran through the "
            "plain versions. No result: the check needs a CUDA device.")
        return 3

    say(details)
    say(kernels)
    say(smi_line)
    say(json.dumps({"ok": True,
                    "device": {"platform": "gpu",
                               "kind": torch.cuda.get_device_name(0),
                               "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
