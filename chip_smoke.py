#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` and drives the
port's paths through the entry points a user calls: ``api.build_plan(x) ->
plan.matvec(charges)`` at the paper's SIFT setting (arXiv 1709.03671 §4.2:
128-d descriptors, k = 30, tile 32, superblock 8) on n = 262 144 synthetic
descriptors made from a seed, then the paper's two iterative applications
(§3) at the same n. Phases, each of which fails the run when it fails:

1. environment: versions, the card, the kernel build with its wall time;
2. every kernel against its plain PyTorch version on the card, on the
   paper's §4.1 micro matrices (16 dense tiles per row block, banded and
   scattered), on random nonzero coordinates and on random ELL affinity
   patterns with a ragged last row block (t-SNE force, also run twice and
   required to be bit-equal);
3. the main path at full size — per-stage build times, ``matvec`` through
   the ``cuda`` backend for (n,) and (n, 8) charges against the ``bsr``
   and ``csr`` reference paths, the single-plan kernel entry on the plan's
   storage, and a small plan against a dense float64 product;
4. γ of the ordered pattern at the paper's Table 1 size (n = 4096, k = 30,
   σ = 15) through the γ-pair kernel, dual-tree against scattered;
5. each kernel's time at the main path's shapes beside its plain version,
   one library call and the least time the card could take;
6. t-SNE attraction at full width: P calibrated to perplexity 30 over
   k = 90 neighbours (van der Maaten, JMLR 15, 2014), symmetrised, planned
   with ``InteractionPlan.from_coo`` ordered from the data; 20 attraction
   steps through ``plan.tsne_attractive`` (the ``tsne_force`` kernel), held
   against the plain path and a float64 edge-wise sum, then timed. Dense
   repulsion at this n is not part of the package and is not run;
7. mean shift with the refresh tiers at full size: ``build_plan(t,
   sources=src)``, four ``plan.meanshift_step``s with a ``plan.refresh``
   between them — auto first, then each tier not yet taken, forced — each
   checked against a float64 edge-wise mean on sampled rows;
8. the twin examples ``examples/tsne_torch.py`` and
   ``examples/meanshift_torch.py`` on the card, which must print
   "clusters separated OK" and "converged to modes OK".

Launch counters are set to 0 just before each path (phases 3-4, 6, 7) and
read just after it; launches made to compare or time a kernel are not
counted. Every kernel must have been launched by a path.

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
    kept_plan = int(b.nbr_mask.sum())
    it_fast, it_slow = (2, 1) if rehearse else (20, 3)
    ms = timer(lambda: k_tf.tsne_force(b.vals, b.col_idx, yp), it_fast)
    plain_ms = timer(lambda: k_tf.tsne_force_plain(b.vals, b.col_idx, yp),
                     it_slow)
    step_ms = timer(lambda: plan.tsne_attractive(y), it_fast)
    bound, by = tsne_bound(kept_plan, b.bs, b.col_idx.numel(), yp.numel(),
                           b.n_rb * b.bs * 2, 2)
    say(f"  tsne_force: kernel {ms:.3f} ms  plain {plain_ms:.3f} ms  "
        f"bound {bound:.3f} ms ({by}); plan.tsne_attractive end to end "
        f"{step_ms:.3f} ms")
    entry = {
        "name": "tsne_force", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/tsne_force.cu",
        "replaces": "src/repro/kernels/tsne_force.py:47",
        "launches": launches["tsne_force"],
        "shape": (f"p_vals ({b.n_rb}, {b.max_nbr}, {b.bs}, {b.bs}), "
                  f"{kept_plan} kept tiles, y ({yp.shape[0]}, 2)"),
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound, "bound_by": by, "library_ms": None}
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
    from repro_torch.kernels import tsne_force as k_tf

    dev = torch.device("cpu" if rehearse else "cuda")
    timer = Timer(dev)
    t_start = time.perf_counter()
    wrappers = {"bsr_spmv_batched": k_bsr.bsr_spmv_batched,
                "bsr_spmv": k_bsr.bsr_spmv,
                "gamma_pairs": k_gs.gamma_pairs,
                "tsne_force": k_tf.tsne_force}
    # launches by the paths (phases 3-4, 6, 7): counters are set to 0 just
    # before a path and read just after it
    main_launches = dict.fromkeys(wrappers, 0)

    def reset_counts():
        for w in wrappers.values():
            w.launches = 0

    def collect_counts(path: str) -> dict:
        got = {name: w.launches for name, w in wrappers.items()}
        for name, count in got.items():
            main_launches[name] += count
        say(f"  launches on the {path} path: {got}")
        reset_counts()
        return got

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
            del p4, c4, y4

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
    details = json.dumps({"micro_cases": micro_cases,
                          "build_plan_s": build_s,
                          "stage_s": stage_s,
                          "matvec_ms": matvec_ms,
                          "plan_bytes": plan_bytes, "n": n_main,
                          "max_nbr": max_nbr, "kept_tiles": kept,
                          "gamma": {o: {"exact": g[0], "score": g[1]}
                                    for o, g in gammas.items()},
                          "tsne": tsne, "meanshift": meanshift})
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
