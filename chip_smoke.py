#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` and drives the
port's paths through the entry points a user calls: ``api.build_plan(x) ->
plan.matvec(charges)`` at the paper's SIFT setting (arXiv 1709.03671 §4.2:
128-d descriptors, k = 30, tile 32, superblock 8) on n = 262 144 synthetic
descriptors made from a seed, then the paper's two iterative applications
(§3) at the same n, then Qwen2-0.5B at full width (random weights from the
seed) served with ClusterKV attention, six decoder-only models of the
zoo at full width (phase 16), and the SSM LM, the hybrid and the
encoder-decoder of the zoo at full width and depth through the serving
launcher (phase 17), and Qwen2-0.5B trained at full width and depth on
the card, then served from its trained weights, then trained through
ClusterKV (B6's forward and its hand-written backward, phase 18), then trained
on a process mesh of the one card (phase 19), then dry-run over a traced
world of 256 ranks (phase 20). Phases, each of which fails
the run when it fails:

1. environment: versions, the card, the kernel build with its wall time,
   and the registers and spills ``-Xptxas -v`` reports for every B6
   instantiation (bf16 and float32), its backward's (dQ and dK/dV) too;
2. every kernel against its plain PyTorch version on the card, on the
   paper's §4.1 micro matrices (16 dense tiles per row block, banded and
   scattered; B1/B2 also under padded masks — kept counts spread over
   0..16 as prefixes, holes anywhere, NaN tiles under the mask — and
   required to be bit-equal run to run), on random nonzero coordinates
   (γ, also at σ = 1, where far terms underflow) and on random ELL
   affinity patterns with a ragged last row block (t-SNE force, also
   under the same three kinds of padded mask, run twice and required to
   be bit-equal), the ClusterKV prefill kernel (causal and not, g = 7,
   tiles of 128 and 64, float32 and bf16; float32 also at tiles of 32 and
   head dim 16, the reduced model's; at tiles of 128 also head dim 128
   and MLA's q/k 96 with v 64, both dtypes) and the decode kernel (plain
   mode, plan mode with holes with and without the self column, g = 1 and
   7, float32 and bf16; at head dim 128 with g = 7 and 12; the same tiles
   selected as the plain path; and one NaN key tile, selected first as
   ``topk_stable`` ranks it); B6's backward under autograd (the forward's
   statistics, the key-tile lists and their order, dQ and dK/dV; bf16 at
   tiles of 128 by wgmma) against the plain backward at every shape the
   forward supports, both dtypes, causal and not, the key-tile lists and
   their order bit-equal to theirs with ids outside the cache, and S of
   one tile pair by the backward's wgmma against the forward's mma.sync;
   ClusterKV's key ordering (``ops.cluster_codes``: each key set's
   embedding and Morton codes in one launch) against ``pca_project_det``
   + ``morton_codes`` on the same keys at minicpm3-4b's two training
   shapes in bf16 and one float32 shape streamed through shared memory,
   the same codes run to run, timed beside the plain version and its
   bound;
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
8. the twin examples ``examples/tsne_torch.py``,
   ``examples/meanshift_torch.py``, ``examples/stream_torch.py``,
   ``examples/serve_clusterkv_torch.py``, ``examples/krr_torch.py`` and
   ``examples/spectral_torch.py`` on the card, which must print
   "clusters separated OK", "converged to modes OK", "streamed plan OK",
   "service tokens match dense decode" and "OK" (after the dense scipy
   check and the planted-cluster recovery);
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
12. (run right after phase 10, with its weights) the ClusterKV decode
   service, ``ClusterKVEngine(mode="plan", knn=8, plan_prefill=True)``, on
   phase 10's traffic (the same prompts): B5 in plan mode with the self
   column once per layer per tick, B6 once per layer per admission (plan
   prefill), no SpMV; after 8 ticks one session loses a prompt and a
   generated position (``trim``) and another is rebucketed, and decode
   goes on with one decode signature and the insert-tier telemetry exact
   (appends = inserts x 48, flushed edges = appends x knn); B5 on tick 8's
   real state (every layer) against ``plan_decode_plain`` within C10 with
   the same tiles; seconds per admission split into flash prefill, the 24
   ``kv_plan_batch`` builds, staging with ``attach`` and the plan prefill,
   tick ms, tokens/s and the host claim against the decode step, beside
   phase 10's; then a float32 covering-budget check: the service's tokens
   equal the flash engine's, and a snapshot after 3 ticks, written to
   disk by ``checkpoint.Checkpointer`` and restored, resumed in a fresh
   engine gives the same tokens;

then B5 and B6 are timed at the serving path's shapes beside their plain
versions, SDPA with the equivalent mask (B6) and their bounds (B6's at the
bf16 tensor-core rate); B5 also at the covering budget (64 tiles). B5's
``ms`` is the time per call back to back, what the serving path pays;
its ``device_ms``, one call replayed as a CUDA graph, is the launches'
device time without the host's, which is the larger part of a call.

11. streaming at the paper's widths: the SIFT plan of phases 3-5 built
   with ``capacity = 1.1 n`` and ``ell_slack = 4``, the γ guard armed,
   then steps of 1 % replaced (deletes plus inserts of points from the
   same mixture), one delete-only step, then from that streamed plan one
   step through a ``DoubleBufferedPlan`` (deletes past ``max_dead_frac``
   applied in place, the compaction they leave pending built on a
   background thread while mid-build ``dbp.matvec`` through B1 stays
   ``torch.equal`` to the old generation and a 1 % churn is queued,
   remapped through ``compact_map`` and replayed after the swap, the
   successor ``torch.equal`` to ``apply_pending_layout`` run inline), and
   ``plan.compact()``. After every step, on
   the card: ``plan.matvec`` through B1 against the plain blockwise path
   and the maintained COO (1e-4 x scale), B2 on the plan's storage
   against the plain path, dead rows exactly 0, and the previous
   generation's ``matvec`` bit-equal to what it gave before the step; the
   compacted plan ``torch.equal`` to a fresh build on the survivors, γ
   streamed / fresh within 0.9-1.1. Then ``build_plan_batch`` over 8
   members of 24 000-32 768 points (capacity 32 768) and two lockstep
   ``batch.update`` steps, each followed by ONE batched B1 launch held
   against the plain batched path (1e-4 x scale) and bit for bit against
   every member's own ``matvec``. Host seconds per step (with the
   tier taken), ``matvec`` ms of the streamed plan against the fresh
   build and γ streamed / fresh are printed;
13. the iterative solvers at the same widths: the SIFT generator and
   widths (with its own seed) built with ``symmetrize=True, values=RBFValues()``; a KRR
   fit (``krr_fit``, lam 0.5, block-Jacobi, the config's ``cg_tol`` and
   ``cg_maxiter``, ``y = tanh(x @ w)``) with every lane converged, the
   true residual through the plain path within 10 x ``cg_tol``, the same
   fit through ``bsr`` within 1e-3 x max|alpha| and 2 iterations, B1
   launched once per CG iteration plus the Gershgorin apply and held
   against the plain path on this plan,
   ``predict`` on 1024 held-out points, block-Jacobi against identity,
   ``check_every`` 1 against 8 (the same bits, both timed), B1's share of
   an iteration and the card's busy share of a solve (``torch.profiler``);
   ``krr_fit_batch`` over 8 members of 24 000-32 768 points with ONE
   batched B1 launch per iteration, held against the plain batched path
   at these shapes, each lane held against its member's own fit; ``plan.eigs(k=6, m=32)`` and ``spectral_embedding(plan=,
   bandwidth=0, m=32)`` with one B1 launch per Lanczos iteration, the
   eigenvalues through ``cuda`` and ``bsr`` from one start vector within
   1e-4 x scale, the spectral Ritz residuals through the plain path
   within 1e-3 and the Ritz vectors orthonormal within 1e-4.

14. the cost model and autotune with this card's knobs, and plan
   persistence, on phase 3's SIFT plan: the knobs probed (a device copy's
   rate, host seconds per launch, the segment gather's penalty, seconds
   per ``index_add_`` edge) are written to a knob file and installed;
   ``tune_backend`` at f = 1 and f = 8 and ``tune_batch_backend`` on phase
   13's 8-member batch, from fresh calibration, must give ``cuda`` (the
   card's rule; the model's ranking is printed beside it) with B1
   launched and checked against ``bsr`` by the probes, and the model's
   B1 bytes equal to ``spmv_bytes``; ``choose_decode_backend`` at phase
   10's tick shape must pick ``cuda``; ``tune_blocks_per_query`` over phase 9's layer
   keys; the plan saved (blocking, then async) and restored on the card
   with its integer arrays and tiles ``torch.equal`` and ``matvec``
   through B1 and B2 bit-equal at (n,) and (n, 8), then restored with
   ``refresh_with`` its own points (the tier printed); the batch saved and
   restored, one B1 launch bit-equal. Save, restore and bytes on disk are
   printed beside ``build_plan``'s seconds.

15. sharded plans on the one card (meshes of 1 and 4 shards, every shard
   on the same card; no exchange between cards is measured): phase 3's
   SIFT plan sharded (each ``ShardSpec`` printed: mode, halo, hot set,
   transfer fraction), its ``matvec`` one B2 launch per shard held
   against the unsharded ``matvec`` (``torch.equal`` printed, 1e-4 x
   scale enforced) and timed beside it (CUDA events, 20 launches, median
   of 3); ``plan.apply(backend="dist")``; ``tune_backend(device_count=4)``
   (``dist`` probed on the one card, its report printed); ``krr_fit`` on
   phase 13's plan sharded 4 ways (4 B2 launches per CG iteration)
   against phase 13's unsharded fit; a delete-only ``ShardedPlan.update`` that patches the
   owning shard only (the others keep their tensors, ``unshard()`` equals
   the updated plan's BSR, the input ``ShardedPlan`` unchanged); a
   ``DoubleBufferedPlan`` swap absorbed at n = 32 768 (the tombstone half
   patched, the compaction re-sharded on the same mesh);
   ``restore_plan(mesh=)`` of phase 14's checkpoint; and Qwen2-0.5B at
   full width through 8 ``decode_step(sharded_long=True)`` steps with the
   8 192-slot cache split over 4 shards — at a covering budget in float32
   the unsharded decode's tokens and logits within 1e-3 x scale, at the
   default budget in bf16 ms per step beside ``clusterkv_decode``'s.

16. the decoder-only model zoo at full width, bf16 compute, weights from
   the seed drawn in place in their parameter dtype, one model at a time
   (freed before the next; each prints its depth, cuts and weight bytes):
   granite-moe-3b-a800m (MoE, 40 experts top 8) served on phase 10's
   traffic through ``Engine(backend="clusterkv")`` and
   ``ClusterKVEngine(mode="plan", knn=8, plan_prefill=True)`` (prefill
   ms, tick ms, tokens/s, B5/B6 launches) plus the float32 covering-budget
   check against the flash engine; then h2o-danube-3-4b (SWA 4096, the
   flash path, a 6144-token prompt), minicpm3-4b (MLA: B6 at q/k 96, v
   64; the absorbed decode), llava-next-34b (vlm from embeddings, bf16
   master weights), mistral-large-123b (20 of 88 layers) and
   llama4-maverick-400b-a17b (1 of 48 layers): ``prefill`` of one 4096-
   token prompt, then 8 scalar ``decode_step``s in an 8192-slot cache
   (B6 once a layer, B5 once a layer a step where ClusterKV is on);
   minicpm3-4b and mistral-large-123b (4 layers) held against their own
   flash path in float32 at a covering budget (logits within 1e-3 x
   scale, same tokens). Then B6 is timed at the zoo's new shapes (a
   llava layer at dh 128 in bf16 and float32, a minicpm3 MLA layer) and
   B5 at head dim 128 (g = 7 and 12).

17. the rest of the zoo at full width and full depth, bf16 compute over
   float32 master weights from the seed, one model at a time, each
   served through ``launch.serve.generate`` (``prefill``, the cache grown
   to prompt + gen, greedy ``decode_step``s; prefill ms, ms a step,
   tokens/s, weight bytes, B5/B6 launches): falcon-mamba-7b (64 mamba1
   layers; batch 4, prompt 2048, 32 tokens, attention-free),
   zamba2-1.2b (42 mamba2 layers in 7 groups with one shared attention
   block; batch 4, prompt 3968, 128 tokens, ClusterKV: B6 once a group a
   prefill, B5 once a group a step, 32 / 32 heads of 128, g = 1) and
   whisper-medium (24 + 24 layers; batch 4, 448 frames and 448 tokens,
   32 tokens). Checks: zamba2 in float32 at budgets covering every tile
   gives its flash path's tokens and logits (1e-3 x scale);
   falcon-mamba-7b and whisper-medium at 4 layers of full width in
   float32 hold teacher forcing (``prefill(S)`` against ``prefill(S-1)``
   and one step, 1e-3 x scale); one mamba1 layer at full width
   (d_inner 8192, d_state 16, S 2048) scans within 1e-4 x scale of the
   float64 step recurrence. Then B6 and B5 are held against their plain
   versions at each ClusterKV config's heads and dims (zamba2's too) and
   timed at the zoo's new shapes (zamba2's among them).

18. single-card training. Qwen2-0.5B at full width and depth (24 layers,
   d 896, vocab 151 936, tied), float32 masters from the seed, bf16
   compute, remat on, ``loss_chunk`` 8192, ``make_optimizer(cfg.optimizer)``
   with the launcher's schedule for 6 steps, trained by
   ``train.trainer.make_train_step`` for 6 steps on one fixed batch of 16 x
   4096 tokens (train_4k's length; its global batch 256 cut to 16 for the
   run's time limit) in 2 microbatches of 8: loss per step, step ms (the
   median of steps 2-6), tokens/s, peak memory, and the analytic model's
   FLOPs a step with their share of 989 TFLOP/s. Training launches no
   kernel (flash attention); the trained weights are then served through
   ``make_prefill_step``/``make_decode_step`` with ClusterKV (one
   4096-token prompt, 8 scalar steps: B6 24 times, B5 24 times a step).
   Checks: finite metrics, the fixed batch's loss lowered; float32 at 2
   layers of full width, ``microbatch=2`` against 1 and ``compress_grads``
   against exact within the reference's bounds; the mamba1 scan's gradient
   at full width (d_inner 8192, d_state 16, S 512) against float64
   autograd of the step recurrence (1e-4 x scale); one step each of
   falcon-mamba-7b (2 layers), zamba2-1.2b (one group of 6),
   whisper-medium (2 + 2 layers), granite-moe-3b-a800m (2 layers, aux
   loss), minicpm3-4b (2 layers, MLA) and mistral-large-123b (1 layer, bf16
   masters, Adafactor) at full width, finite, ms printed. Then ClusterKV
   training: the Qwen2-0.5B run again (same weights, batch, steps,
   microbatches and remat) with ``--backend clusterkv``, B6's forward
   twice a layer a microbatch (remat's recompute) and its backward once,
   step ms, tokens/s and peak beside the flash run's, losses finite and
   falling; one ClusterKV step of granite-moe-3b-a800m and minicpm3-4b
   (MLA, B6 at 96 / 64) at full width and 2 layers; a 2-layer full-width
   Qwen ClusterKV step through the kernels against the same step through
   B6's plain forward and backward (loss rel 1e-3, grad norm rel 1e-2)
   and through B6's forward kernel and plain backward (each attention
   projection's gradient in each layer rel 2e-2), with four faults
   planted in B6's backward that must break that limit; B6's backward at
   Qwen's training microbatch and a llava-next-34b and a minicpm3-4b
   layer, held against its plain version and timed beside it (the whole
   op, and the lists, their order, dQ and dK/dV each alone, with the
   tensor cores' issued TFLOP/s and a dK/dV block's largest and mean
   visits), beside ``torch.autograd.grad`` of SDPA with the equivalent
   boolean mask and its bound; and C40's raise for B1-B5 (B5's wrapper
   under grad);
19. training on a process mesh of the one card: an ``nccl`` group of one
   rank in this process (``file://`` rendezvous, ``device_id`` cuda:0),
   torn down at the end, and a (1, 1) ("data", "model") mesh
   (``launch.mesh.make_test_mesh``). Phase 18's Qwen2-0.5B run (full
   width and depth, 16 x 4096 tokens in 2 microbatches) for 3 steps
   through ``make_train_step(mesh=)`` on DTensor parameters and state
   (``trainer.place_train_state``), against 3 steps without a mesh
   from the same init: loss and grad norm within rtol 1e-5, seconds a step
   and peak GiB of both; granite-moe-3b-a800m at full width (2 of 32
   layers) with ``expert_parallel=True`` (the expert-parallel branch, its
   all-to-alls over a group of one), one step against one without a mesh,
   and mistral-large-123b at full width (1 of 88 layers, Adafactor on the
   shards), two steps against two without;
   ``launch.train --mesh 1,1`` with a checkpoint directory, its last
   checkpoint removed and the run resumed through ``restore(shardings=)``;
   ``pipeline_apply`` at one stage against sequential application, its
   output and its backward's gradients. No exchange between two ranks is
   measured: the machine has one card;
20. the dry run (``launch.dryrun``) and the roofline: seven cells traced
   at once, each in its own process, over a ``fake`` process group with
   fake CUDA tensors (nothing allocated): phase 19's Qwen2-0.5B step
   (16 x 4096 tokens in 2 microbatches) on a (1, 1) world, whose
   predicted per-rank peak must be within 15 % of the peak phase 19
   measured in this run; Qwen2-0.5B's and h2o-danube-3-4b's ``train_4k``
   on the production 16x16 world and on a fake 16x1 world (16 rows a
   rank, no tensor split); Qwen2-0.5B's ``prefill_32k`` through ClusterKV
   on the 16x16 world, which must trace B6 (a rank's heads) as the opaque
   op ``repro_torch::block_attention``; Qwen2-0.5B's ``train_4k`` through
   ClusterKV on 16x16, which must trace B6's forward and backward as the
   opaque ops ``block_attention_with_stats`` and
   ``block_attention_backward``. Each 16x16 ``train_4k`` cell's
   FLOPs a rank against its 16x1 trace / 16 and against the analytic
   model: Qwen's ratio to the 16x1 trace must be at most 1.3, and
   h2o-danube's predicted peak a rank below the card's memory. The
   roofline of the records (H100 rates applied to counts), and B5 per
   call at the tick shape through its op against its ``CUDA``
   implementation called directly.

Launch counters are set to 0 just before each path (phases 3-4, 6, 7, 9,
10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20) and read just after it; launches made to
compare or time a kernel are not counted. Every kernel must have been
launched by a path: B6 by the prefills and the service's plan prefills
and by ClusterKV training (phase 18), B6's backward, its key-tile
lists and their order by ClusterKV training,
B5 by the ticks of both engines (plan mode) and the scalar steps (plain
mode; phase 18 serves its trained weights through both), B1
once per 48-member ``PlanBatch.matvec``, by every streamed plan's and
every double-buffered ``matvec`` (phase 11) and by every solver iteration
(phase 13) and by the autotune's probes and the restored plan and batch
(phase 14), B2 by the single-plan entry on the main, streamed and
restored plans and once per shard by every sharded ``matvec`` (phase 15).

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
import dataclasses
import importlib.util
from contextlib import contextmanager
import json
import math
import re
import shutil
import subprocess
import sys
import tempfile
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
    ``-Xptxas -v`` report of the kernel build (mangled names: the integer
    template arguments name the instantiation, e.g. B6's bq, bk, dh, dv)."""
    rows = []
    blocks = re.split(r"Compiling entry function '", report)[1:]
    for blk in blocks:
        name = blk.split("'", 1)[0]
        if kernel not in name:
            continue
        targs = re.search(kernel + r"I((?:Li\d+E)+)", name)
        targs = ", ".join(re.findall(r"Li(\d+)E", targs.group(1))) \
            if targs else "?"
        regs = re.search(r"Used (\d+) registers", blk)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", blk)
        rows.append({"kernel": f"{kernel}<{targs}>",
                     "registers": int(regs.group(1)) if regs else None,
                     "spill_stores": int(spill.group(1)) if spill else None,
                     "spill_loads": int(spill.group(2)) if spill else None})
    return rows


def spmv_bytes(kept_tiles: int, bs: int, col_idx_numel: int, x_numel: int,
               y_numel: int) -> int:
    """Bytes the ELL-BSR product must move: each kept float32 tile, the
    int32 index array, the float32 charges and result, once each. Counted
    here, apart from the code it bounds: phase 14 and
    ``tests/test_torch_costmodel.py`` hold the cost model's ``cuda`` bytes
    equal to it."""
    return 4 * (kept_tiles * bs * bs + x_numel + y_numel) + 4 * col_idx_numel


def spmv_bound(kept_tiles: int, bs: int, col_idx_numel: int, x_numel: int,
               y_numel: int, f: int):
    """Least time for the ELL-BSR product: its bytes (:func:`spmv_bytes`)
    at the memory rate, or 2 flops per kept tile entry and feature column
    at the float32 peak, whichever is longer."""
    byts = spmv_bytes(kept_tiles, bs, col_idx_numel, x_numel, y_numel)
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
            ("meanshift_torch.py", [], "converged to modes OK"),
            ("stream_torch.py", ["--n", "2048", "--steps", "10"]
             if rehearse else [], "streamed plan OK"),
            ("serve_clusterkv_torch.py", [],
             "service tokens match dense decode"),
            ("krr_torch.py", [], "dense scipy reference: max rel err"),
            ("spectral_torch.py", [], "planted-cluster recovery")):
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
# MoE FFN in bf16 against its plain float32 version: the bf16 path rounds
# each expert product, the SwiGLU and the gated sum to bf16 (2^-9 relative
# each), so an element may be some 2^-9 x 4 of its own size off; a wrong
# expert, gate or drop is off by the whole of its term
MOE_BF16_TOL = 2e-2


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
    # the float32 instance at the reduced model's head dim (the twin
    # example's plan prefill): tiles of 32, dh = 16, g = 2
    for causal in (True, False):
        q, k, v, kpos, qpos, idx = attention_inputs(
            gen, 2, 4, 2, 256, 16, 32, 3, torch.float32, dev)
        got = k_ba.block_attention(q, k, v, kpos, qpos, idx, bq=32, bk=32,
                                   causal=causal)
        err, scale = check_close(
            f"block_attention float32 dh=16 causal={causal}", got,
            k_ba.block_attention_plain(q, k, v, kpos, qpos, idx, bq=32,
                                       bk=32, causal=causal))
        cases.append({"kernel": "block_attention", "dtype": "torch.float32",
                      "S": 256, "g": 2, "dh": 16, "bq": 32, "n_sel": 3,
                      "causal": causal, "max_abs_err": err, "scale": scale,
                      "tolerance": f"{REL_TOL:g} x scale"})
        say(f"  B6 torch.float32  S=256 g=2 dh=16 bq=bk=32 causal="
            f"{causal!s:5s}: err {err:.2e} (scale {scale:.2f})")
    # the model zoo's head dims at tiles of 128 (phase 16): dh = dv = 128
    # (float32 at half a query tile a block) and MLA's q/k 96 with v 64
    for dh, dv in ((128, 128), (96, 64)):
        for dtype in (torch.float32, torch.bfloat16):
            ulps = 0 if dtype == torch.float32 else BF16_ULPS
            tol = f"{REL_TOL:g} x scale" if ulps == 0 else BF16_TOL_TEXT
            for causal in (True, False):
                q, k, _, kpos, qpos, idx = attention_inputs(
                    gen, 1, 14, 2, s6, dh, 128, 8, dtype, dev)
                v = torch.randn((1, 2, s6, dv), generator=gen,
                                device=dev).to(dtype)
                got = k_ba.block_attention(q, k, v, kpos, qpos, idx, bq=128,
                                           bk=128, causal=causal)
                err, scale = check_close(
                    f"block_attention {dtype} dh={dh} dv={dv} "
                    f"causal={causal}", got.float(),
                    k_ba.block_attention_plain(q, k, v, kpos, qpos, idx,
                                               bq=128, bk=128,
                                               causal=causal).float(),
                    bf16_ulps=ulps)
                cases.append({"kernel": "block_attention",
                              "dtype": str(dtype), "S": s6, "g": 7,
                              "dh": dh, "dv": dv, "bq": 128, "n_sel": 8,
                              "causal": causal, "max_abs_err": err,
                              "scale": scale, "tolerance": tol})
                say(f"  B6 {str(dtype):14s} S={s6} g=7 dh={dh} dv={dv} "
                    f"bq=bk=128 causal={causal!s:5s}: err {err:.2e} (scale "
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
    # head dim 128 at the zoo's GQA groups (llava-next-34b 7,
    # mistral-large-123b 12): the part kernel stages ~144 KB at g = 12
    for dtype in (torch.float32, torch.bfloat16):
        ulps = 0 if dtype == torch.float32 else BF16_ULPS
        tol = f"{REL_TOL:g} x scale" if ulps == 0 else BF16_TOL_TEXT
        for g in (7, 12):
            for mode in ("plain", "plan+self"):
                plan_mode = mode != "plain"
                q, k, v, pos, cent = decode_inputs(
                    gen, b, 2, g, s5, 128, bk, dtype, dev,
                    holes=0.2 if plan_mode else 0.0)
                ks = torch.randn((b, 2, 128), generator=gen,
                                 device=dev).to(dtype)
                vs = torch.randn((b, 2, 128), generator=gen,
                                 device=dev).to(dtype)
                kw = dict(n_sel=n_sel, bk=bk, plan_mode=plan_mode,
                          has_self=plan_mode, window=bk)
                sel = torch.zeros((b, 2, n_sel), dtype=torch.int32,
                                  device=dev)
                got = k_da.decode_attend_fused(
                    q, k, v, pos, cent, qpos, ks, vs,
                    sel_out=None if rehearse else sel, **kw)
                err, scale = check_close(
                    f"decode_attend {dtype} dh=128 g={g} {mode}",
                    got.float(), k_da.decode_attend_plain(
                        q, k, v, pos, cent, qpos, ks, vs, **kw).float(),
                    bf16_ulps=ulps)
                if plan_mode:
                    want_sel = plan_select(q, pos, cent, qpos, n_sel=n_sel,
                                           bk=bk, window=bk)
                else:
                    want_sel = decode_select(q.float(), cent, n_sel)
                if not rehearse and not torch.equal(
                        sel.long().sort(-1).values,
                        want_sel.long().sort(-1).values):
                    raise AssertionError(f"decode_attend {dtype} dh=128 "
                                         f"g={g} {mode}: tile selection "
                                         "differs")
                cases.append({"kernel": "decode_attend_fused",
                              "dtype": str(dtype), "S": s5, "B": b, "g": g,
                              "dh": 128, "mode": mode, "n_sel": n_sel,
                              "max_abs_err": err, "scale": scale,
                              "tolerance": tol, "selection_equal": True})
                say(f"  B5 {str(dtype):14s} B={b} S={s5} dh=128 g={g} "
                    f"{mode:9s}: err {err:.2e} (scale {scale:.2f}, "
                    f"tolerance {tol}), selected tiles equal")
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


def check_b6_backward(args, dev, rehearse, cases):
    """Phase 2, B6's backward: ``ops.block_attention`` under autograd (B6's
    forward with its statistics, then the key-tile lists, dQ and dK/dV
    kernels) against the plain backward at every shape the forward
    supports, both dtypes, causal and not (GQA g = 3, one duplicate tile
    id), within ``B6_BWD_REL_TOL`` x scale (+ one bf16 spacing); the lists
    and their order bit-equal to their plain versions with ids outside the
    cache; S of one tile pair by the backward's wgmma against the forward's
    mma.sync (printed: whether the recomputed S is bit for bit the
    forward's)."""
    from repro_torch.kernels import block_attention as k_ba
    from repro_torch.kernels import ops

    gen = torch.Generator(device=dev).manual_seed(args.seed + 23)
    for dtype, shapes in ((torch.float32, k_ba.SUPPORTED_F32),
                          (torch.bfloat16, k_ba.SUPPORTED)):
        ulps = BF16_ULPS if dtype == torch.bfloat16 else 0
        for bq, dh, dv in sorted(shapes):
            for causal in (True, False):
                q, k, _, kpos, qpos, idx = attention_inputs(
                    gen, 1, 6, 2, 4 * bq, dh, bq, 3, dtype, dev)
                v = torch.randn((1, 2, 4 * bq, dv), generator=gen,
                                device=dev).to(dtype)
                idx[0, 1, 2, 1] = idx[0, 1, 2, 0]
                live = [t.clone().requires_grad_() for t in (q, k, v)]
                out = ops.block_attention(*live, kpos, qpos, idx, bq=bq,
                                          bk=bq, causal=causal)
                dout = torch.randn(tuple(out.shape), generator=gen,
                                   device=dev).to(dtype)
                got = torch.autograd.grad(out, live, dout)
                want = k_ba.block_attention_backward_plain(
                    q, k, v, kpos, qpos, idx, out.detach(), None, dout,
                    bq=bq, bk=bq, causal=causal)
                errs = [check_close(
                    f"B6 backward {dtype} bq={bq} dh={dh} dv={dv} "
                    f"causal={causal} {name}", g_.float(), w.float(),
                    rel_tol=B6_BWD_REL_TOL, bf16_ulps=ulps)[0]
                    for name, g_, w in zip(("dq", "dk", "dv"), got, want)]
                cases.append({"kernel": "block_attention_backward",
                              "dtype": str(dtype), "S": 4 * bq, "g": 3,
                              "dh": dh, "dv": dv, "bq": bq, "n_sel": 3,
                              "causal": causal, "max_abs_err": max(errs),
                              "errs": errs,
                              "tolerance": f"{B6_BWD_REL_TOL:g} x scale"
                              + (f" + {ulps} bf16 spacing" if ulps else "")})
        worst = max(c["max_abs_err"] for c in cases
                    if c["kernel"] == "block_attention_backward"
                    and c["dtype"] == str(dtype))
        say(f"  B6 backward {str(dtype):14s} at {sorted(shapes)}, causal "
            f"and not: largest dq/dk/dv err {worst:.2e} (tolerance "
            f"{B6_BWD_REL_TOL:g} x scale"
            + (f" + {ulps} bf16 spacing)" if ulps else ")"))
    idx = torch.randint(-1, 9, (2, 3, 6, 4), generator=gen, device=dev,
                        dtype=torch.int32)
    got, want = k_ba.key_tile_lists(idx, 8), k_ba.key_tile_lists_plain(idx, 8)
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        raise AssertionError("the key-tile lists differ from their plain "
                             "version")
    if not torch.equal(k_ba.key_tile_order(got[0]),
                       k_ba.key_tile_order_plain(want[0])):
        raise AssertionError("the key-tile order differs from its plain "
                             "version")
    say("  key-tile lists (2 x 3 kv heads, 6 x 4 ids in [-1, 8], 8 tiles) "
        "and their order: bit-equal to their plain versions")
    if rehearse:
        return
    # the backward recomputes S by wgmma; the forward computed it by
    # mma.sync: the two on one tile pair, each held against float64 (its
    # bf16 products are exact, its float32 sums of 64 within 64 x 2^-24 of
    # the sum of |q k|)
    qt = torch.randn((128, 64), generator=gen, device=dev).bfloat16()
    kt = torch.randn((128, 64), generator=gen, device=dev).bfloat16()
    s_mma, s_wgmma = k_ba.logits_two_ways(qt, kt)
    exact = qt.double() @ kt.double().T
    bound = 64 * 2.0 ** -24 * (qt.double().abs() @ kt.double().abs().T)
    for name, got in (("mma.sync", s_mma), ("wgmma", s_wgmma)):
        if bool(((got.double() - exact).abs() > bound).any()):
            raise AssertionError(f"S by {name} is off the float64 product")
    differ = int((s_mma != s_wgmma).sum())
    gap = float((s_mma - s_wgmma).abs().max())
    cases.append({"kernel": "block_attention_backward",
                  "check": "S by wgmma against the forward's mma.sync",
                  "elements": s_mma.numel(), "differ": differ,
                  "max_abs_diff": gap})
    say(f"  S of one 128 x 128 tile pair (dh 64, bf16) by the backward's "
        f"wgmma against the forward's mma.sync: {differ} of "
        f"{s_mma.numel()} elements differ, largest gap {gap:.3e} "
        f"({'bit-equal' if differ == 0 else 'not bit-equal'}; both within "
        "float32 summation of the float64 product)")


def cluster_order_bound(n_sets: int, s: int, dh: int, esz: int, d: int,
                        iters: int):
    """Least time for ClusterKV's key ordering: the keys read once and the
    codes written once at the memory rate, or the products with the keys
    (``library.cluster_codes_flops``) at the float32 peak of the CUDA
    cores, whichever is longer."""
    from repro_torch.kernels.library import cluster_codes_flops
    byts = n_sets * s * (dh * esz + 8)
    ops = cluster_codes_flops((1, n_sets, s, dh), d, 10, iters)
    t_b, t_o = byts / HBM_BYTES_PER_S * 1e3, ops / FP32_FLOP_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def check_cluster_order(args, dev, timer, rehearse):
    """Phase 2, ClusterKV's key ordering: ``ops.cluster_codes`` against its
    plain version (``pca_project_det`` + ``morton_codes``) on the same
    keys, by ``cluster_order.check_against_plain``, at both training
    shapes of minicpm3-4b in bf16 and one float32 shape too large for a
    cluster's shared memory (streamed); the same codes run to run; timed
    beside the plain version and the bound. Returns the ``kernels`` row."""
    from repro_torch.kernels import cluster_order as k_co
    from repro_torch.kernels import ops

    gen = torch.Generator(device=dev).manual_seed(args.seed + 25)
    it_fast, it_slow = (2, 1) if rehearse else (20, 3)
    d, iters = 3, 4
    shapes = ((("train8k", (1, 40, 8192, 96), torch.bfloat16),
               ("train2k", (4, 40, 2048, 96), torch.bfloat16),
               ("streamed", (1, 4, 16384, 96), torch.float32))
              if not rehearse else
              (("train8k", (1, 4, 512, 96), torch.bfloat16),
               ("train2k", (4, 4, 128, 96), torch.bfloat16),
               ("streamed", (1, 2, 600, 96), torch.float32)))
    rows = []
    for what, (b, h, s, dh), dtype in shapes:
        # clustered keys with a nonzero mean, as attention keys come
        centers = torch.randn((b, h, 16, dh), generator=gen, device=dev) * 3
        pick = torch.randint(0, 16, (b, h, s, 1), generator=gen, device=dev)
        k = (torch.gather(centers, 2, pick.expand(b, h, s, dh)) + 1.5
             + 0.3 * torch.randn((b, h, s, dh), generator=gen, device=dev)
             ).to(dtype)
        codes, y = k_co.embed_and_code(k, d)
        again = ops.cluster_codes(k, d)
        if not torch.equal(codes, again):
            raise AssertionError("cluster_codes is not reproducible run to "
                                 f"run ({what})")
        got = k_co.check_against_plain(k, codes, y, d)
        ms = timer(lambda: ops.cluster_codes(k, d), it_fast)
        plain_ms = timer(lambda: k_co.cluster_codes_plain(k, d, 10, iters),
                         it_slow)
        esz = k.element_size()
        bound, by = cluster_order_bound(b * h, s, dh, esz, d, iters)
        lay = (None if rehearse else
               k_co.layout(b * h, s, dh, dtype)._asdict())
        rows.append({"case": what, "shape": [b, h, s, dh],
                     "dtype": str(dtype).replace("torch.", ""), **got,
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                     "bound_by": by, "layout": lay})
        say(f"  cluster_codes {what} ({b}, {h}, {s}, {dh}) {dtype}: y gap "
            f"{got['y_gap']:.2e} of scale, {got['codes_differ']:.2e} of "
            f"codes at cell edges, reproducible; kernel {ms:.4f} ms  plain "
            f"{plain_ms:.3f} ms  bound {bound:.4f} ms ({by}); layout {lay}")
        del k, codes, y, again
    head = rows[0]
    return {
        "name": "cluster_codes", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/cluster_order.cu",
        "replaces": "src/repro/core/clusterkv.py:147",
        "shape": (f"k {tuple(head['shape'])} {head['dtype']}, d={d}, "
                  f"bits=10, iters={iters}"),
        "y_gap": head["y_gap"],
        "codes_differ": head["codes_differ"], "ms": head["ms"],
        "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"], "library_ms": None, "cases": rows}


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
            "err_plan_prefill": err_pf, "launches": launches,
            "_keys": keys}


def serve_traffic(args, cfg, rehearse):
    """The serving traffic of phases 10 and 12: the sizes, and the requests
    drawn from ``--seed`` (the same prompts for both engines), with the
    generator they were drawn from."""
    from repro_torch.train.serve_loop import Request

    if rehearse:
        slots, max_seq, bucket, n_req, max_new = 2, 256, 64, 4, 6
        lo, hi = 16, 120
    else:
        slots, max_seq, bucket, n_req, max_new = 4, 8192, 1024, 8, 32
        lo, hi = 2048, 6144
    rng = np.random.default_rng(args.seed + 10)
    reqs = [Request(rid=i, tokens=rng.integers(0, cfg.vocab, int(
        rng.integers(lo, hi + 1))).astype(np.int64), max_new=max_new)
        for i in range(n_req)]
    return (slots, max_seq, bucket, n_req, max_new, lo, hi), reqs, rng


def phase_serve(args, dev, sync, cfg, params, rehearse, reset_counts,
                collect_counts):
    """Phase 10: serving Qwen2-0.5B through ``Engine(backend="clusterkv")``."""
    import dataclasses
    from repro_torch.models import model_api
    from repro_torch.models import transformer as tf
    from repro_torch.train.serve_loop import Engine, Request

    sizes, reqs, rng = serve_traffic(args, cfg, rehearse)
    slots, max_seq, bucket, n_req, max_new, lo, hi = sizes
    say(f"== phase 10: serving {cfg.name} ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.dtype}) through Engine(backend='clusterkv'): "
        f"slots={slots}, max_seq={max_seq}, bucket={bucket}, {n_req} "
        f"requests of {lo}-{hi} tokens, max_new={max_new}")
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


COUNTERS = ("launches", "plain_mode_launches", "plan_mode_launches")


@contextmanager
def uncounted(*wrappers):
    """Launches inside the block leave the wrappers' counts (B5's per
    contract too) as they were: a check of a path's result (a kernel
    against itself, a member against the batch) or a timing is not the
    path's launch."""
    saved = [{a: getattr(w, a) for a in COUNTERS if hasattr(w, a)}
             for w in wrappers]
    try:
        yield
    finally:
        for w, counts in zip(wrappers, saved):
            for a, n in counts.items():
                setattr(w, a, n)


def disk_bytes(path: Path) -> int:
    """Bytes of every file under ``path``."""
    return sum(p.stat().st_size for p in Path(path).rglob("*") if p.is_file())


def phase_service(args, dev, sync, cfg, params, rehearse, reset_counts,
                  collect_counts, serve):
    """Phase 12: the ClusterKV decode service (``ClusterKVEngine``, plan
    mode, ``plan_prefill``) on phase 10's traffic, then a covering-budget
    float32 check with snapshot/resume. ``serve`` is phase 10's result (the
    per-call baseline of the same call)."""
    import dataclasses
    from repro_torch.core.clusterkv import plan_decode_plain, plan_select
    from repro_torch.kernels import block_attention as k_ba
    from repro_torch.kernels import decode_attend as k_da
    from repro_torch.models import attention as attn
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.serve import ClusterKVEngine
    from repro_torch.train.serve_loop import Engine, Request

    t_phase = time.perf_counter()
    sizes, reqs, rng = serve_traffic(args, cfg, rehearse)
    slots, max_seq, bucket, n_req, max_new, lo, hi = sizes
    knn, surgery_tick = 8, (2 if rehearse else 8)
    ck = cfg.clusterkv
    say(f"== phase 12: the decode service, ClusterKVEngine(mode='plan', "
        f"knn={knn}, plan_prefill=True), serving {cfg.name} on phase 10's "
        f"traffic: slots={slots}, max_seq={max_seq}, bucket={bucket}, "
        f"{n_req} requests of {lo}-{hi} tokens, max_new={max_new}; tiles "
        f"{ck.block_k}, {ck.blocks_per_query} blocks per query tile, "
        f"{ck.decode_clusters} decode clusters, window "
        f"{ck.local_window_blocks} tile, embed_dim {ck.embed_dim}")
    eng = ClusterKVEngine(cfg, params, slots=slots, max_seq=max_seq,
                          prefill_bucket=bucket, mode="plan", knn=knn,
                          plan_prefill=True, device=dev)
    for r in reqs:
        eng.submit(r)
    sync()
    seen = []
    real_decode = attn.clusterkv_plan_decode

    def record(q, ks, vs, ps, cent, qpos, ccfg, *, k_self=None,
               v_self=None):
        # one tick's real state, every layer: the inputs B5 is called with
        seen.append(tuple(a.clone() for a in (q, ks, vs, ps, cent, qpos,
                                              k_self, v_self)))
        return real_decode(q, ks, vs, ps, cent, qpos, ccfg, k_self=k_self,
                           v_self=v_self)

    reset_counts()
    t0 = time.perf_counter()
    surgery = None
    while eng.queue or any(r is not None for r in eng.slot_req):
        if eng.ticks == surgery_tick - 1:
            attn.clusterkv_plan_decode = record
        try:
            eng.step()
        finally:
            attn.clusterkv_plan_decode = real_decode
        eng._retire()
        if eng.ticks == surgery_tick and surgery is None:
            # trim one prompt position and one generated position of the
            # session in slot 0, rebucket the session in slot 1
            live = [eng._slot_sess[s] for s in range(2)]
            if any(x is None for x in live):
                raise AssertionError("slots 0 and 1 are not both live at "
                                     f"tick {surgery_tick}")
            gen_pos = sorted(live[0].phys_hist)[0]
            c0 = dict(eng.store.counters)
            t_s = time.perf_counter()
            eng.trim(live[0].rid, [3, gen_pos])
            sync()
            trim_s = time.perf_counter() - t_s
            t_s = time.perf_counter()
            eng.rebucket(live[1].rid)
            sync()
            surgery = {"trim_s": trim_s,
                       "rebucket_s": time.perf_counter() - t_s,
                       "trimmed": [3, gen_pos],
                       "trim_rid": live[0].rid, "rebucket_rid": live[1].rid}
            c1 = eng.store.counters
            if (c1["deletes"] - c0["deletes"], c1["rebuckets"]
                    - c0["rebuckets"]) != (2, 1):
                raise AssertionError(f"trim/rebucket counters {c0} -> {c1}")
            ps = eng.pstate["ps"][:, live[0].slot]
            if bool(((ps == 3) | (ps == gen_pos)).any()):
                raise AssertionError("trimmed positions still in the cache")
    sync()
    wall = time.perf_counter() - t0
    launches = collect_counts("decode service")
    ticks = eng.ticks
    if surgery is None:
        raise AssertionError(f"the run ended before tick {surgery_tick}")
    n_layers = cfg.n_layers
    plan_mode = launches["decode_attend_fused.plan_mode"]
    if not rehearse:
        if plan_mode != n_layers * ticks or \
                launches["decode_attend_fused"] != plan_mode:
            raise AssertionError(f"{ticks} service ticks launched the "
                                 f"plan-mode decode kernel {plan_mode} times "
                                 f"({launches['decode_attend_fused']} in "
                                 "all)")
        if launches["block_attention"] != n_layers * n_req:
            raise AssertionError(f"{n_req} plan prefills launched "
                                 f"block_attention "
                                 f"{launches['block_attention']} times")
        if launches["bsr_spmv_batched"] or launches["bsr_spmv"]:
            raise AssertionError(f"the service launched the SpMV kernels: "
                                 f"{launches}")
    for r in reqs:
        if len(r.output) != max_new or not all(0 <= t < cfg.vocab
                                               for t in r.output):
            raise AssertionError(f"service request {r.rid}: output "
                                 f"{r.output}")
    for rid, lg in eng.first_logits.items():
        if not torch.isfinite(lg).all():
            raise AssertionError(f"service request {rid}: non-finite "
                                 "first-token logits")
    rep = eng.report()
    if rep["decode_traces"] != 1 or rep["specs_seen"] != 1:
        raise AssertionError(f"decode_traces {rep['decode_traces']}, "
                             f"specs_seen {rep['specs_seen']}")
    members = n_layers * cfg.n_kv_heads
    inserts = rep["counters"]["inserts"]
    appends = rep["insert_tiers"]["appends"]
    if inserts != sum(len(r.output) - 1 for r in reqs) or \
            appends != inserts * members or \
            rep["counters"]["flushed_edges"] != appends * knn:
        raise AssertionError(f"insert telemetry: {rep['counters']}, "
                             f"{rep['insert_tiers']}")
    if rep["insert_tiers"]["tombstones"] != members or \
            rep["insert_tiers"]["rebuckets"] != members:
        raise AssertionError(f"tiers taken: {rep['insert_tiers']}")

    # B5 through the cuda backend against plan_decode_plain on the
    # recorded tick's state (uncounted): C10 bound, the same tiles
    n_sel = min(ck.decode_clusters, max_seq // eng.bk)
    window = ck.local_window_blocks * eng.bk
    if len(seen) != n_layers:
        raise AssertionError(f"recorded {len(seen)} layers of a tick")
    b5_err, b5_scale, same_tiles = 0.0, 0.0, True
    with uncounted(k_da.decode_attend_fused):
        for q, ks, vs, ps, cent, qpos, k1, v1 in seen:
            sel = (torch.empty((slots, cfg.n_kv_heads, n_sel),
                               dtype=torch.int32, device=dev)
                   if not rehearse else None)
            got = k_da.decode_attend_fused(
                q, ks, vs, ps, cent, qpos, k1, v1, n_sel=n_sel, bk=eng.bk,
                plan_mode=True, has_self=True, window=window, sel_out=sel)
            want = plan_decode_plain(q, ks, vs, ps, cent, qpos, n_sel=n_sel,
                                     bk=eng.bk, window=window, k_self=k1,
                                     v_self=v1)
            err, scale = check_close(
                "B5 on a service tick vs plan_decode_plain", got.float(),
                want.float(), bf16_ulps=BF16_ULPS
                if got.dtype == torch.bfloat16 else 0)
            b5_err, b5_scale = max(b5_err, err), max(b5_scale, scale)
            if sel is not None:
                want_sel = plan_select(q, ps, cent, qpos, n_sel=n_sel,
                                       bk=eng.bk, window=window)
                same_tiles &= torch.equal(sel.long().sort(-1).values,
                                          want_sel.sort(-1).values)
    if not same_tiles:
        raise AssertionError("B5 selected other tiles than plan_select on "
                             "the service's state")
    del seen

    generated = sum(len(r.output) for r in reqs)
    t = eng.timings
    builds, stages, pps = t["plan_build_s"], t["stage_s"], t["plan_prefill_s"]
    flash = [a - b - c - d for a, b, c, d in zip(t["prefill_s"], builds,
                                                  stages, pps)]
    tick = [x * 1e3 for x in t["tick_s"]]
    say(f"  {n_req} requests, {generated} tokens in {wall:.2f} s: "
        f"{generated / wall:.1f} tokens/s; {ticks} ticks (phase 10, "
        f"per-call, same traffic: {serve['tokens_per_s']:.1f} tokens/s, "
        f"{serve['ticks']} ticks)")
    say(f"  admission s (prompt -> flash prefill + {n_layers} "
        "kv_plan_batch + stage and attach + plan prefill = total): "
        + "; ".join(
            f"{len(r.tokens)} -> {f:.3f} + {b:.3f} + {s_:.3f} + {p:.3f} = "
            f"{a:.3f}" for r, f, b, s_, p, a in zip(
                reqs, flash, builds, stages, pps, t["prefill_s"])))
    say(f"  tick ms: median {float(np.median(tick)):.2f}, min "
        f"{min(tick):.2f}, max {max(tick):.2f} (phase 10 per-call: median "
        f"{serve['tick_ms_median']:.2f}, min {min(serve['tick_ms']):.2f}, "
        f"max {max(serve['tick_ms']):.2f})")
    say(f"  host claim {rep['host_claim_s']:.3f} s against decode step "
        f"{rep['device_tick_s']:.3f} s over {ticks} ticks "
        f"({rep['host_claim_s'] / ticks * 1e3:.2f} / "
        f"{rep['device_tick_s'] / ticks * 1e3:.2f} ms a tick)")
    say(f"  trim of positions {surgery['trimmed']} of request "
        f"{surgery['trim_rid']} {surgery['trim_s']:.3f} s, rebucket of "
        f"request {surgery['rebucket_rid']} {surgery['rebucket_s']:.3f} s; "
        f"decode went on, decode_traces {rep['decode_traces']}, specs_seen "
        f"{rep['specs_seen']}; counters {rep['counters']}; tiers "
        f"{rep['insert_tiers']}")
    say(f"  B5 on tick {surgery_tick}'s state, {n_layers} layers, self "
        f"column: max-abs {b5_err:.2e} (scale {b5_scale:.2f}) against "
        f"plan_decode_plain, tolerance {BF16_TOL_TEXT}; the same tiles")
    del eng
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # covering budgets, float32: exact attention, so the service gives the
    # flash engine's tokens; snapshot after 3 ticks and resume in a fresh
    # engine gives the uninterrupted run's tokens
    cover = max_seq // ck.block_k
    cfgc = cfg.with_(dtype="float32", clusterkv=dataclasses.replace(
        ck, blocks_per_query=cover, decode_clusters=cover))
    rng_c = np.random.default_rng(args.seed + 12)
    new_chk = 8
    chk = [rng_c.integers(0, cfg.vocab, int(n)).astype(np.int64)
           for n in ((40, 70) if rehearse else (2048, 3000))]

    def run(e, steps=None):
        rs = [Request(rid=i, tokens=p, max_new=new_chk)
              for i, p in enumerate(chk)]
        for r in rs:
            e.submit(r)
        if steps is None:
            e.run()
        else:
            for _ in range(steps):
                e.step()
                e._retire()
        return rs

    def service():
        return ClusterKVEngine(cfgc, params, slots=len(chk),
                               max_seq=max_seq, prefill_bucket=bucket,
                               knn=knn, plan_prefill=True, device=dev)

    reset_counts()
    fl = Engine(cfgc, params, slots=len(chk), max_seq=max_seq,
                prefill_bucket=bucket, backend="flash", device=dev)
    want = [r.output for r in run(fl)]
    full = service()
    got = [r.output for r in run(full)]
    if got != want:
        raise AssertionError(f"service tokens {got} != flash engine tokens "
                             f"{want}")
    errs = [check_close(f"service first-token logits request {i}",
                        full.first_logits[i], fl.first_logits[i],
                        rel_tol=SERVE_TOL) for i in range(len(chk))]
    if full.report()["decode_traces"] != 1:
        raise AssertionError("the covering service changed its signature")
    del fl, full
    part = service()
    run(part, steps=3)
    # the snapshot goes to disk and back through the Checkpointer
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_ckpt_"))
    try:
        ckpt = Checkpointer(tmp)
        t0 = time.perf_counter()
        part.snapshot(ckpt, step=3)
        snap_s = time.perf_counter() - t0
        snap_bytes = disk_bytes(tmp)
        del part
        t0 = time.perf_counter()
        store, step = ckpt.restore_plan(name="sessions", device=dev)
        sync()
        restore_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    resumed = service()
    resumed.resume(store)
    rs = {r.rid: r for r in resumed.slot_req if r is not None}
    resumed.run()
    back = [rs[i].output for i in range(len(chk))]
    if step != 3 or back != want:
        raise AssertionError(f"resumed tokens {back} != {want}")
    launches_c = collect_counts("covering-budget check (service)")
    del resumed, store, ckpt
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    say(f"  covering budgets (blocks_per_query = decode_clusters = {cover}), "
        f"float32, plan_prefill: {len(chk)} requests x {new_chk} tokens "
        f"equal the flash engine's token for token; first-token logits "
        f"max-abs " + ", ".join(f"{e:.2e} (scale {s_:.2f})" for e, s_ in errs)
        + f", tolerance {SERVE_TOL:g} x scale; snapshot after 3 ticks -> "
        f"Checkpointer on disk ({snap_bytes / 1e6:.1f} MB, snapshot "
        f"{snap_s:.3f} s, restore {restore_s:.3f} s) -> resume in a fresh "
        f"engine: the same tokens")
    phase_s = time.perf_counter() - t_phase
    say(f"  phase 12 took {phase_s:.1f} s")
    return {"slots": slots, "max_seq": max_seq, "bucket": bucket,
            "requests": n_req, "max_new": max_new, "knn": knn,
            "prompt_tokens": [len(r.tokens) for r in reqs],
            "generated": generated, "wall_s": wall,
            "tokens_per_s": generated / wall, "ticks": ticks,
            "admission_s": t["prefill_s"], "flash_prefill_s": flash,
            "plan_build_s": builds, "stage_s": stages,
            "plan_prefill_s": pps, "tick_ms": tick,
            "tick_ms_median": float(np.median(tick)),
            "host_claim_s": rep["host_claim_s"],
            "device_tick_s": rep["device_tick_s"], "report": rep,
            "surgery": surgery, "b5_tick_err": b5_err,
            "b5_tick_scale": b5_scale, "launches": launches,
            "covering_launches": launches_c, "check_tokens": got,
            "snapshot": {"save_s": snap_s, "restore_s": restore_s,
                         "bytes": snap_bytes},
            "check_logit_err": [e for e, _ in errs],
            "percall_tick_ms_median": serve["tick_ms_median"],
            "percall_tokens_per_s": serve["tokens_per_s"],
            "phase_s": phase_s}


def phase_stream(args, dev, timer, sync, rehearse, reset_counts,
                 collect_counts, k_bsr):
    """Phase 11: streaming at the paper's widths (the SIFT plan of phases
    3-5 built with 10 % spare capacity), then a lockstep batch."""
    from repro_torch import api
    from repro_torch.core.doublebuf import DoubleBufferedPlan
    from repro_torch.data.pipeline import feature_mixture
    from repro_torch.kernels import ops

    n = 2048 if rehearse else args.n
    k, bs, sb = (8 if rehearse else 30), 32, 8
    m = max(n // 100, 1)                        # 1 % replaced per step
    churn_steps = 2                 # cut from 3 to keep the phase ~90 s
    n_clusters = max(8, n // 256)
    t_phase = time.perf_counter()
    say(f"== phase 11: streaming at n={n}, D=128, k={k}, bs {bs}, sb {sb}, "
        f"capacity 1.1 n, ell_slack 4; {churn_steps} steps of {m} deletes "
        f"+ {m} inserts, one delete-only step, one deferred step through "
        f"the double buffer, compact")
    t0 = time.perf_counter()
    n_pool = n + (churn_steps + 2) * m
    pool = feature_mixture(n_pool, 128, n_clusters=n_clusters,
                           seed=args.seed + 11)
    say(f"  data: {pool.shape} float32 mixture, the arrivals drawn from "
        f"the same mixture ({time.perf_counter() - t0:.1f} s on the host)")
    rng = np.random.default_rng(args.seed + 11)
    wrappers = (k_bsr.bsr_spmv_batched, k_bsr.bsr_spmv)
    b1 = k_bsr.bsr_spmv_batched

    reset_counts()
    t0 = time.perf_counter()
    plan = api.build_plan(pool[:n], k=k, bs=bs, sb=sb, d=3, bits=10,
                          leaf_size=64, backend="auto", ell_slack=4,
                          capacity=int(1.1 * n), device=dev)
    _ = plan.gamma                            # arms the γ-drift guard
    sync()
    build_s = time.perf_counter() - t0
    say(f"  build_plan(capacity={plan.capacity}) {build_s:.2f} s: {plan}, "
        f"ELL width {plan.bsr.max_nbr}")

    def charges(p):
        return torch.from_numpy(rng.standard_normal(
            (p.n, 2)).astype(np.float32)).to(dev)

    def check(p, ch, what):
        """B1 (``plan.matvec``, cuda backend) against the plain blockwise
        path and the maintained COO; B2 on the plan's storage against the
        plain path; dead rows exactly 0. Returns B1's result."""
        y = p.matvec(ch)
        sync()
        err_bsr, scale = check_close(f"{what}: matvec cuda vs bsr", y,
                                     p.matvec(ch, backend="bsr"),
                                     rel_tol=BACKEND_TOL)
        err_csr, _ = check_close(f"{what}: matvec cuda vs COO", y,
                                 p.matvec(ch, backend="csr"),
                                 rel_tol=BACKEND_TOL)
        b = p.bsr
        xs = p.permute(ch)
        y2 = ops.bsr_spmv(b.vals, b.col_idx, xs, p.n, nbr_mask=b.nbr_mask)
        err_b2, _ = check_close(f"{what}: ops.bsr_spmv vs bsr", y2,
                                p.apply(xs, backend="bsr"),
                                rel_tol=BACKEND_TOL)
        dead = torch.from_numpy(~p.alive).to(dev)
        if bool(y[dead].any()):
            raise AssertionError(f"{what}: a dead row is not exactly 0")
        return y, {"err_bsr": err_bsr, "err_coo": err_csr,
                   "err_b2": err_b2, "scale": scale,
                   "dead_rows": int(dead.sum())}

    ch = charges(plan)
    y, _ = check(plan, ch, "build")
    feed, rows = n, []

    def advance(plan, ch, y, fn, label):
        """One step: ``fn(plan)`` timed on the host, then :func:`record`."""
        t0 = time.perf_counter()
        new = fn(plan)
        sync()
        return record(plan, ch, y, new, time.perf_counter() - t0, label)

    def record(plan, ch, y, new, host_s, label):
        """The successor ``new`` of a step checked on the card, and the
        previous generation's matvec held bit-equal to what it gave before
        the step (ROADMAP C6)."""
        ch2 = charges(new)
        y2, errs = check(new, ch2, label)
        with uncounted(*wrappers):
            same = torch.equal(plan.matvec(ch), y)
        if not same:
            raise AssertionError(f"{label}: the input plan's matvec "
                                 "changed (copy-on-write broken)")
        st = new.refresh_stats
        row = {"step": label, "tier": st.last_action, "host_s": host_s,
               "n_alive": new.n_alive, "capacity": new.capacity,
               "max_nbr": new.bsr.max_nbr, "fill": new.fill,
               "pending": new.host.pending_layout, **errs}
        rows.append(row)
        say(f"  {label:10s} {st.last_action:9s} {host_s:6.2f} s host  "
            f"n={new.n_alive}/cap={new.capacity} ELL width "
            f"{new.bsr.max_nbr} pending {new.host.pending_layout}; "
            f"cuda vs bsr {errs['err_bsr']:.2e}, vs COO "
            f"{errs['err_coo']:.2e}, B2 {errs['err_b2']:.2e} (scale "
            f"{errs['scale']:.2f}); previous generation bit-equal")
        return new, ch2, y2

    def stream_step(plan, ch, y, n_del, n_ins, label, defer=False):
        nonlocal feed
        live = np.nonzero(plan.alive)[0]
        kill = rng.choice(live, n_del, replace=False)
        xin = pool[feed:feed + n_ins] if n_ins else None
        feed += n_ins
        return advance(plan, ch, y,
                       lambda p: api.update_plan(p, insert=xin, delete=kill,
                                                 defer_layout=defer), label)

    for i in range(churn_steps):
        plan, ch, y = stream_step(plan, ch, y, m, m, f"churn {i}")
    plan, ch, y = stream_step(plan, ch, y, m, 0, "delete")
    st = plan.refresh_stats
    if st.last_action != "tombstone" or st.appends < churn_steps:
        raise AssertionError(f"the steps did not stream: {st}")

    survivors = plan.host.x[plan.alive]
    t0 = time.perf_counter()
    fresh = api.build_plan(survivors, config=plan.config, device=dev)
    _ = fresh.gamma
    sync()
    fresh_s = time.perf_counter() - t0
    gamma_ratio = plan.gamma / fresh.gamma
    say(f"  fresh build on the {len(survivors)} survivors {fresh_s:.2f} s; "
        f"gamma streamed {plan.gamma:.4f} / fresh {fresh.gamma:.4f} = "
        f"{gamma_ratio:.4f}")
    if not 0.9 <= gamma_ratio <= 1.1:
        raise AssertionError(f"streamed locality decayed: {gamma_ratio}")

    # a deferred step through the double buffer: the fewest deletes that
    # take the debris (live points lost since the peak, over the capacity)
    # past max_dead_frac, and 1 % inserts, stay on the in-place tiers; the
    # compaction they leave pending builds on a background thread while
    # dbp.matvec serves the old generation through B1 and a 1 % churn is
    # queued, to be remapped through compact_map and replayed at the swap
    streamed, ch_s, y_s = plan, ch, y
    peak = plan.host.peak_alive
    n_big = int(plan.config.max_dead_frac * plan.capacity) + 1 + m \
        - (peak - plan.n_alive)
    kill = rng.choice(np.nonzero(plan.alive)[0], n_big, replace=False)
    xin, churn_ins = pool[feed:feed + m], pool[feed + m:feed + 2 * m]
    feed += 2 * m
    dbp = DoubleBufferedPlan(streamed)
    t0 = time.perf_counter()
    state = dbp.update(insert=xin, delete=kill)
    t_launch = time.perf_counter()
    step_s = t_launch - t0
    snap = dbp.plan
    if state != "applied" or not dbp.building or \
            snap.host.pending_layout != "compact" or \
            snap.capacity != streamed.capacity:
        raise AssertionError(f"the deferred step did not stay in place with "
                             f"a compaction building: {state}, building "
                             f"{dbp.building}, pending "
                             f"{snap.host.pending_layout}")
    churn_del = rng.choice(np.nonzero(snap.alive)[0], m, replace=False)
    if dbp.update(insert=churn_ins, delete=churn_del) != "queued":
        raise AssertionError("a churn update mid-build was not queued")
    ch_d = charges(snap)
    y_pre = dbp.matvec(ch_d)
    sync()
    n0, mid_ms = b1.launches, []
    while dbp.building:
        t0 = time.perf_counter()
        y_mid = dbp.matvec(ch_d)
        sync()
        mid_ms.append((time.perf_counter() - t0) * 1e3)
        if not torch.equal(y_mid, y_pre):
            raise AssertionError("a mid-build matvec differs from the old "
                                 "generation's")
    build_bg_s = time.perf_counter() - t_launch
    if not mid_ms:
        raise AssertionError("the build ended before a mid-build matvec")
    if not rehearse and b1.launches - n0 != len(mid_ms):
        raise AssertionError("the mid-build matvecs did not go through B1")
    replay_s = []
    real_update = api.update_plan

    def timed_update(*a, **kw):
        t0 = time.perf_counter()
        out = real_update(*a, **kw)
        sync()
        replay_s.append(time.perf_counter() - t0)
        return out

    api.update_plan = timed_update
    try:
        t0 = time.perf_counter()
        dbp.wait()
        sync()
        wait_s = time.perf_counter() - t0
    finally:
        api.update_plan = real_update
    swap_ms = (wait_s - sum(replay_s)) * 1e3
    snapshot, successor, kind = dbp.last_swap
    final = dbp.plan
    if dbp.generation != 1 or kind != "compact" or snapshot is not snap \
            or dbp.queued or len(replay_s) != 1:
        raise AssertionError(f"swap: generation {dbp.generation}, kind "
                             f"{kind}, queued {dbp.queued}, replays "
                             f"{len(replay_s)}")
    if dbp.events[-2][:2] != ("swap", "compact") or \
            dbp.events[-1][0] != "apply":
        raise AssertionError(f"events {[e[:2] for e in dbp.events[-3:]]}")
    # every queued delete maps to a live slot of the successor, and after
    # the replay that slot is dead or holds one of the queued arrivals
    remapped = successor.host.compact_map[churn_del]
    landed = final.host.last_inserted_idx
    if (remapped < 0).any() or not successor.alive[remapped].all() or \
            (final.alive[remapped] & ~np.isin(remapped, landed)).any() or \
            final.n_alive != successor.n_alive or len(landed) != m:
        raise AssertionError("the queued deletes were not remapped through "
                             "compact_map and replayed")
    record(streamed, ch_s, y_s, snap, step_s, "deferred")
    rec_succ = record(snap, ch_d, y_pre, successor, build_bg_s,
                      "background")
    if rows[-1]["tier"] != "compact" or rows[-1]["pending"] is not None:
        raise AssertionError(f"the background repair ran {rows[-1]}")
    record(successor, rec_succ[1], rec_succ[2], final, sum(replay_s),
           "replayed")
    with uncounted(*wrappers):
        redo = api.apply_pending_layout(snapshot)
        db_equal = {"pi": bool(torch.equal(successor.pi, redo.pi))}
        db_equal.update({f: bool(torch.equal(getattr(successor.bsr, f),
                                             getattr(redo.bsr, f)))
                         for f in ("col_idx", "nbr_mask", "vals")})
        if not all(db_equal.values()):
            raise AssertionError(f"the swapped successor differs from the "
                                 f"repair run inline: {db_equal}")
        idle_ms = []
        for _ in range(max(len(mid_ms), 5)):
            t0 = time.perf_counter()
            snap.matvec(ch_d)
            sync()
            idle_ms.append((time.perf_counter() - t0) * 1e3)
    say(f"  double buffer: {n_big} deletes + {m} inserts applied in place "
        f"in {step_s:.2f} s, compaction in the background "
        f"{build_bg_s:.2f} s; {len(mid_ms)} mid-build dbp.matvec "
        f"torch.equal to the old generation, "
        f"{float(np.median(mid_ms)):.3f} ms median (no build in flight "
        f"{float(np.median(idle_ms)):.3f} ms); a 1 % churn ({m} + {m}) "
        f"queued; swap {swap_ms:.2f} ms + the queued churn replayed "
        f"{sum(replay_s):.2f} s; generation 1, deletes remapped through "
        f"compact_map; successor torch.equal to the inline repair "
        f"{db_equal}")
    del redo, final
    doublebuf = {"deletes": n_big, "inserts": m, "step_s": step_s,
                 "build_s": build_bg_s, "swap_ms": swap_ms,
                 "replay_s": sum(replay_s),
                 "mid_build_matvecs": len(mid_ms),
                 "matvec_ms_mid_build": mid_ms, "matvec_ms_idle": idle_ms,
                 "equal": db_equal}
    comp, ch, y = advance(streamed, ch_s, y_s, lambda p: p.compact(),
                          "compact")
    with uncounted(*wrappers):
        y_fresh = fresh.matvec(ch)
    equal = {name: bool(torch.equal(getattr(comp.bsr, name),
                                    getattr(fresh.bsr, name)))
             for name in ("col_idx", "nbr_mask", "vals")}
    equal["pi"] = bool(torch.equal(comp.pi, fresh.pi))
    equal["matvec"] = bool(torch.equal(y, y_fresh))
    say(f"  compact vs fresh build on the survivors, torch.equal: {equal}")
    if not all(equal.values()):
        diff = float((y - y_fresh).abs().max()) if y.shape == \
            y_fresh.shape else float("nan")
        raise AssertionError(f"compact is not bit-equal to a fresh build: "
                             f"{equal}, matvec max-abs {diff:.3e}")

    # the lockstep batch: 8 members of 24 000-32 768 points (D = 128,
    # k = 30), capacity the pow2 of the largest; two updates, each
    # followed by ONE batched launch of B1 for the whole batch
    n_mem = 4 if rehearse else 8
    lo, hi = (300, 512) if rehearse else (24000, 32768)
    sizes = rng.integers(lo, hi + 1, n_mem)
    sizes[0] = hi
    m_b = [max(int(s) // 100, 1) for s in sizes]
    mem_pool = [feature_mixture(int(s) + 2 * mb, 128, n_clusters=32,
                                seed=args.seed + 100 + i)
                for i, (s, mb) in enumerate(zip(sizes, m_b))]
    t0 = time.perf_counter()
    batch = api.build_plan_batch([p[:int(s)] for p, s in
                                  zip(mem_pool, sizes)], k=k, bs=bs, sb=sb,
                                 backend="auto", ell_slack=4, device=dev)
    sync()
    batch_build_s = time.perf_counter() - t0
    if batch.capacity != (512 if rehearse else 32768):
        raise AssertionError(f"batch capacity {batch.capacity}")
    say(f"  build_plan_batch over {n_mem} members of {sizes.tolist()} "
        f"points: capacity {batch.capacity}, ELL width "
        f"{batch.spec.max_nbr}, {batch_build_s:.2f} s")
    xs = torch.from_numpy(rng.standard_normal(
        (n_mem, batch.capacity)).astype(np.float32)).to(dev)
    ys = batch.matvec(xs)
    batch_rows = []
    for step in range(2):
        kills, ins = [], []
        for i, p in enumerate(batch.members()):
            live = np.nonzero(p.alive)[0]
            kills.append(rng.choice(live, m_b[i], replace=False)
                         if step == 0 else None)
            s0 = int(sizes[i]) + step * m_b[i]
            ins.append(None if step == 1 and i == n_mem - 1
                       else mem_pool[i][s0:s0 + m_b[i]])
        t0 = time.perf_counter()
        new = batch.update(insert=ins, delete=kills)
        sync()
        host_s = time.perf_counter() - t0
        # a member without free slots grows, and the batch re-unifies at
        # the next pow2 capacity: new charges of the new shape then
        xs_new = xs if new.capacity == batch.capacity else \
            torch.from_numpy(rng.standard_normal(
                (n_mem, new.capacity)).astype(np.float32)).to(dev)
        n0 = k_bsr.bsr_spmv_batched.launches
        ys_new = new.matvec(xs_new)
        sync()
        if not rehearse and k_bsr.bsr_spmv_batched.launches != n0 + 1:
            raise AssertionError("batch.matvec was not one B1 launch")
        with uncounted(*wrappers):
            if not torch.equal(batch.matvec(xs), ys):
                raise AssertionError("the input batch's matvec changed")
            # B1 against the plain batched path on the same stacked
            # (padded, grown, widened) storage
            err_plain, scale = check_close(
                f"batch.update {step}: matvec cuda vs bsr", ys_new,
                new.matvec(xs_new, backend="bsr"), rel_tol=BACKEND_TOL)
            errs = [check_close(f"batch member {i}", ys_new[i],
                                mem.matvec(xs_new[i]),
                                rel_tol=BACKEND_TOL)[0]
                    for i, mem in enumerate(new.members())]
        # on the card both are B1, at B = 8 and at B = 1 on a member
        # view of the same stacked tensors: the same bits
        if not rehearse and max(errs) != 0.0:
            raise AssertionError(f"batch.update {step}: the batched launch "
                                 f"differs from the members' own: {errs}")
        row = {"step": step, "host_s": host_s,
               "tiers": [h.refresh.last_action for h in new.hosts],
               "n_alive": new.n_alive.tolist(),
               "capacity": new.capacity, "max_nbr": new.spec.max_nbr,
               "err_vs_plain": err_plain, "scale": scale,
               "max_err_vs_members": max(errs)}
        batch_rows.append(row)
        say(f"  batch.update {step}: {host_s:.2f} s host, tiers "
            f"{row['tiers']}, capacity {new.capacity}, ELL width "
            f"{new.spec.max_nbr}; one B1 launch, vs the plain batched "
            f"path max-abs {err_plain:.2e} (scale {scale:.2f}), vs each "
            f"member's own matvec {max(errs):.2e}; input batch bit-equal")
        batch, xs, ys = new, xs_new, ys_new
    launches = collect_counts("streaming")
    if not rehearse:
        for name in ("bsr_spmv_batched", "bsr_spmv"):
            if launches[name] <= 0:
                raise AssertionError(f"kernel {name} was never launched by "
                                     "the streaming path")

    # matvec on the streamed plan (before compaction) against a fresh
    # build on the same survivors: time per call, CUDA events
    it = 2 if rehearse else 20
    ch1 = ch_s[:, :1].contiguous()
    ch1_f = ch[:, :1].contiguous()
    ms = {"streamed": timer(lambda: streamed.matvec(ch_s), it),
          "fresh": timer(lambda: fresh.matvec(ch), it),
          "streamed_f1": timer(lambda: streamed.matvec(ch1), it),
          "fresh_f1": timer(lambda: fresh.matvec(ch1_f), it)}
    reset_counts()
    kept = {"streamed": int(streamed.bsr.nbr_mask.sum()),
            "fresh": int(fresh.bsr.nbr_mask.sum())}
    say(f"  plan.matvec (n, 2): streamed {ms['streamed']:.3f} ms (capacity "
        f"{streamed.capacity}, ELL width {streamed.bsr.max_nbr}, "
        f"{kept['streamed']} kept tiles) vs fresh build "
        f"{ms['fresh']:.3f} ms (n {fresh.n}, ELL width "
        f"{fresh.bsr.max_nbr}, {kept['fresh']} kept tiles); (n, 1) "
        f"{ms['streamed_f1']:.3f} vs {ms['fresh_f1']:.3f} ms")
    phase_s = time.perf_counter() - t_phase
    say(f"  phase 11 took {phase_s:.1f} s")
    return {"n": n, "k": k, "m": m, "phase_s": phase_s,
            "build_s": build_s, "steps": rows,
            "fresh_build_s": fresh_s, "gamma_streamed": streamed.gamma,
            "gamma_fresh": fresh.gamma, "gamma_ratio": gamma_ratio,
            "compact_equal": equal, "matvec_ms": ms, "kept_tiles": kept,
            "doublebuf": doublebuf,
            "batch": {"sizes": sizes.tolist(), "capacity": batch.capacity,
                      "build_s": batch_build_s, "steps": batch_rows},
            "launches": launches}


def cg_trips(iters_max: int, check_every: int, maxiter: int) -> int:
    """Loop trips of ``solvers.cg`` (one operator call each): it stops at
    the first multiple of ``check_every`` where no lane is active, so it
    runs the most iterations any lane ran, rounded up to that multiple,
    and at most ``maxiter``."""
    return min(maxiter, -(-iters_max // check_every) * check_every)


def phase_solvers(args, dev, timer, sync, rehearse, reset_counts,
                  collect_counts, k_bsr):
    """Phase 13: the iterative solvers at the paper's widths, B1 under
    every solver iteration."""
    from repro_torch import api
    from repro_torch.core.registry import get_preconditioner
    from repro_torch.data.pipeline import feature_mixture
    from repro_torch.solvers import (RBFValues, cg, krr_fit, krr_fit_batch,
                                     normalized_operator,
                                     spectral_embedding)
    from repro_torch.solvers.cg import CHECK_EVERY
    from repro_torch.solvers.krr import _plan_backend

    n = 2048 if rehearse else args.n
    # the paper's k in the rehearsal too: at k = 8 the small graph's
    # components join, and the spectral Ritz pairs need more than m
    # iterations
    k, bs, sb = 30, 32, 8
    n_test = 128 if rehearse else 1024
    n_clusters = max(8, n // 256)
    lam, m_lanczos = 0.5, 32
    wrappers = (k_bsr.bsr_spmv_batched, k_bsr.bsr_spmv)
    b1 = k_bsr.bsr_spmv_batched
    t_phase = time.perf_counter()
    say(f"== phase 13: solvers at n={n}, D=128, "
        f"k={k}, bs {bs}, sb {sb}, symmetrized, RBF values")
    x = feature_mixture(n + n_test, 128, n_clusters=n_clusters,
                        seed=args.seed + 13)
    x_train, x_test = x[:n], x[n:]
    rng = np.random.default_rng(args.seed + 13)
    w_true = rng.standard_normal(128).astype(np.float32)
    y = np.tanh(x_train @ w_true).astype(np.float32)
    y_dev = torch.from_numpy(y).to(dev)

    t0 = time.perf_counter()
    plan = api.build_plan(x_train, k=k, bs=bs, sb=sb, d=3, bits=10,
                          leaf_size=64, backend="auto", symmetrize=True,
                          values=RBFValues(), device=dev)
    sync()
    build_s = time.perf_counter() - t0
    b = plan.bsr
    kept = int(b.nbr_mask.sum())
    cfg = plan.config
    say(f"  build_plan(symmetrize=True, values=RBFValues()) {build_s:.2f} s:"
        f" {b.n_rb} row blocks, ELL width {b.max_nbr}, {kept} kept tiles, "
        f"tile tensor {b.vals.numel() * 4 / 1e9:.3f} GB; RBF bandwidth "
        f"{plan.host.values_fn.bandwidth:.4f}")
    got = _plan_backend(plan, None)
    if (got != "cuda") if not rehearse else (got == "cuda"):
        raise AssertionError(f"the solvers resolved backend {got!r}")

    # -- KRR: block-Jacobi CG, B1 once per iteration + the Gershgorin apply
    reset_counts()
    t0 = time.perf_counter()
    model = krr_fit(plan, y_dev, lam=lam, precond="block_jacobi")
    sync()
    fit_s = time.perf_counter() - t0
    res = model.result
    iters = int(res.iters)
    trips = cg_trips(iters, CHECK_EVERY, cfg.cg_maxiter)
    launches_fit = collect_counts("KRR fit")
    if not bool(res.converged.all()):
        raise AssertionError(f"KRR did not converge in {iters} iterations")
    if not rehearse and launches_fit["bsr_spmv_batched"] != trips + 1:
        raise AssertionError(
            f"KRR fit launched B1 {launches_fit['bsr_spmv_batched']} times "
            f"for {trips} CG iterations + 1 Gershgorin apply")
    shift = float(model.self_weight) + lam
    with uncounted(*wrappers):
        # B1 on this plan (what every iteration runs) against the plain
        # path on the same input
        v = torch.from_numpy(rng.standard_normal(plan.n).astype(
            np.float32)).to(dev)
        err_apply, _ = check_close("plan.apply cuda vs bsr", plan.apply(v),
                                   plan.apply(v, backend="bsr"),
                                   rel_tol=BACKEND_TOL)
        a_cl = plan.permute(model.alpha)
        y_cl = plan.permute(y_dev)
        r_true = y_cl - (plan.apply(a_cl, backend="bsr") + shift * a_cl)
        true_rel = float(torch.linalg.vector_norm(r_true)
                         / torch.linalg.vector_norm(y_cl))
        if true_rel > 10 * cfg.cg_tol:
            raise AssertionError(f"true relative residual {true_rel:.3e} "
                                 f"> 10 x cg_tol {cfg.cg_tol:g}")
        model_b = krr_fit(plan, y_dev, lam=lam, precond="block_jacobi",
                          backend="bsr")
        err_b, scale_a = check_close("KRR alpha cuda vs bsr", model.alpha,
                                     model_b.alpha, rel_tol=1e-3)
        iters_b = int(model_b.result.iters)
        if abs(iters_b - iters) > 2:
            raise AssertionError(f"KRR iterations cuda {iters} vs bsr "
                                 f"{iters_b}")
        pred = model.predict(x_test)
        if tuple(pred.shape) != (n_test,) or \
                not bool(torch.isfinite(pred).all()):
            raise AssertionError("predict(x_new) is not finite of shape "
                                 f"({n_test},)")
        test_mse = float(((pred.cpu().numpy()
                           - np.tanh(x_test @ w_true)) ** 2).mean())
        res_id = krr_fit(plan, y_dev, lam=lam, precond="identity").result
        iters_id = int(res_id.iters)
    # the Gershgorin shift makes this system well conditioned (a handful
    # of iterations either way), so block-Jacobi may tie identity in
    # iterations; it must not take more, and its residual after each
    # iteration must be the lower one
    hist_bj = res.history[1:min(iters, iters_id) + 1].cpu()
    hist_id = res_id.history[1:min(iters, iters_id) + 1].cpu()
    if iters > iters_id or not bool((hist_bj < hist_id).all()):
        raise AssertionError(
            f"block-Jacobi took {iters} iterations, identity {iters_id}; "
            f"residuals {hist_bj.tolist()} vs {hist_id.tolist()}")
    say(f"  krr_fit (lam {lam}, block_jacobi, tol {cfg.cg_tol:g}): "
        f"{fit_s:.3f} s, {iters} CG iterations, B1 launches "
        f"{launches_fit['bsr_spmv_batched']} (= iterations + 1; plan.apply"
        f" vs bsr {err_apply:.2e}), self "
        f"weight {shift - lam:.4f}; true relative residual (plain path) "
        f"{true_rel:.2e}; alpha vs the bsr fit {err_b:.2e} (scale "
        f"{scale_a:.3f}), bsr {iters_b} iterations; identity "
        f"{iters_id} iterations (residual after each iteration, "
        f"block-Jacobi / identity: "
        f"{[f'{a:.2e}/{b:.2e}' for a, b in zip(hist_bj.tolist(), hist_id.tolist())]}"
        f"); predict({n_test} held-out) mse {test_mse:.4f}")

    # -- where a solve's time goes: the block-Jacobi factorization, then
    # the CG loop (check_every 1 against 8: the same bits), B1's share of
    # an iteration, and the card's busy share of a whole solve and of the
    # loop alone (torch.profiler)
    shift_t = model.self_weight + lam
    factor = get_preconditioner("block_jacobi")

    solve_backend = _plan_backend(plan, None)

    def A(v):                            # what plan.solve iterates on
        return plan.apply(v, backend=solve_backend) + shift_t * v

    def host_ms(fn, reps=3):
        out = []
        for _ in range(reps):
            sync()
            t0 = time.perf_counter()
            fn()
            sync()
            out.append((time.perf_counter() - t0) * 1e3)
        return sorted(out)[reps // 2]

    with uncounted(*wrappers):
        M = factor(plan.spec, plan.data, shift_t)
        factor_ms = host_ms(lambda: factor(plan.spec, plan.data, shift_t))
        solve_ms = host_ms(lambda: plan.solve(y_dev, shift=shift_t))
        loop_s, loops = {1: [], 8: []}, {}
        for every in (1, 8, 8, 1):
            sync()
            t0 = time.perf_counter()
            loops[every] = cg(A, y_cl, M=M, tol=cfg.cg_tol,
                              maxiter=cfg.cg_maxiter, check_every=every)
            sync()
            loop_s[every].append(time.perf_counter() - t0)
        r1, r8 = loops[1], loops[8]
        same = all(torch.equal(getattr(r1, f), getattr(r8, f))
                   for f in ("x", "iters", "resid", "bnorm", "converged"))
        same = same and torch.equal(torch.nan_to_num(r1.history, 7.0),
                                    torch.nan_to_num(r8.history, 7.0))
        if not same or not torch.equal(plan.unpermute(r1.x), res.x):
            raise AssertionError("check_every 1 and 8 differ, or the loop "
                                 "is not krr_fit's")
        xs1 = torch.from_numpy(rng.standard_normal(
            (1, b.n_cb * bs, 1)).astype(np.float32)).to(dev)
        b1_ms = timer(lambda: b1(b.vals[None], b.col_idx[None], xs1,
                                 b.nbr_mask[None], indices_checked=True),
                      2 if rehearse else 20)
    loop_ms = {e: sorted(v)[0] * 1e3 for e, v in loop_s.items()}
    iter_ms = {e: loop_ms[e] / cg_trips(iters, e, cfg.cg_maxiter)
               for e in loop_ms}
    b1_share = b1_ms / iter_ms[CHECK_EVERY]
    say(f"  plan.solve {solve_ms:.3f} ms: block-Jacobi factorization "
        f"{factor_ms:.3f} ms; the CG loop with check_every 1 "
        f"{loop_ms[1]:.3f} ms ({iter_ms[1]:.3f} ms an iteration), with 8 "
        f"{loop_ms[8]:.3f} ms ({iter_ms[8]:.3f} ms a trip, "
        f"{cg_trips(iters, 8, cfg.cg_maxiter)} trips); results torch.equal;"
        f" B1 at this plan {b1_ms:.4f} ms = {b1_share:.3f} of an iteration")
    busy = None
    if not rehearse:
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        busy = {}
        for what, fn in (
                ("solve", lambda: plan.solve(y_dev, shift=shift_t)),
                ("loop", lambda: cg(A, y_cl, M=M, tol=cfg.cg_tol,
                                    maxiter=cfg.cg_maxiter))):
            with uncounted(*wrappers):
                sync()
                with torch.profiler.profile(activities=acts) as prof:
                    t0 = time.perf_counter()
                    fn()
                    sync()
                    wall_p = time.perf_counter() - t0
            rows = sorted(((e.self_device_time_total, e.key, e.count)
                           for e in prof.key_averages()
                           if e.device_type ==
                           torch.autograd.DeviceType.CUDA), reverse=True)
            busy_ms = sum(us for us, _, _ in rows) / 1e3
            busy[what] = {"wall_ms": wall_p * 1e3, "busy_ms": busy_ms,
                          "share": busy_ms / (wall_p * 1e3),
                          "top": [{"kernel": key[:80], "ms": us / 1e3,
                                   "count": n_}
                                  for us, key, n_ in rows[:6]]}
            say(f"  one {what} under torch.profiler: {wall_p * 1e3:.2f} ms,"
                f" the card busy {busy_ms:.3f} ms = "
                f"{busy[what]['share']:.3f}; top: "
                + "; ".join(f"{r['kernel'][:40]} {r['ms']:.3f} ms "
                            f"x{r['count']}" for r in busy[what]["top"][:4]))

    # -- batched KRR: ONE batched B1 launch per iteration for all members
    n_mem = 4 if rehearse else 8
    lo, hi = (300, 512) if rehearse else (24000, 32768)
    sizes = rng.integers(lo, hi + 1, n_mem)
    sizes[0] = hi
    mem_x = [feature_mixture(int(s), 128, n_clusters=32,
                             seed=args.seed + 130 + i)
             for i, s in enumerate(sizes)]
    t0 = time.perf_counter()
    batch = api.build_plan_batch(mem_x, k=k, bs=bs, sb=sb, backend="auto",
                                 symmetrize=True, values=RBFValues(),
                                 device=dev)
    sync()
    batch_build_s = time.perf_counter() - t0
    if batch.capacity != hi:
        raise AssertionError(f"batch capacity {batch.capacity}")
    ys = batch.pad_charges([np.tanh(xm @ w_true) for xm in mem_x])
    reset_counts()
    t0 = time.perf_counter()
    mb = krr_fit_batch(batch, ys, lam=lam)
    sync()
    batch_fit_s = time.perf_counter() - t0
    launches_batch = collect_counts("batched KRR fit")
    iters_lanes = mb.result.iters.cpu().tolist()
    trips_b = cg_trips(max(iters_lanes), CHECK_EVERY, cfg.cg_maxiter)
    if not bool(mb.result.converged.all()):
        raise AssertionError(f"batched KRR lanes did not converge: "
                             f"{iters_lanes}")
    if not rehearse and launches_batch["bsr_spmv_batched"] != trips_b + 1:
        raise AssertionError(
            f"batched KRR launched B1 {launches_batch['bsr_spmv_batched']} "
            f"times for {trips_b} iterations + 1")
    lane_errs = []
    with uncounted(*wrappers):
        # the batched B1 launch at these shapes against the plain batched
        # path on the same input
        v = torch.from_numpy(rng.standard_normal(
            (n_mem, batch.capacity)).astype(np.float32)).to(dev)
        err_batch_apply, _ = check_close(
            "batch.apply cuda vs bsr", batch.apply(v),
            batch.apply(v, backend="bsr"), rel_tol=BACKEND_TOL)
        for i, mem in enumerate(batch.members()):
            own = krr_fit(mem, ys[i], lam=lam)
            lane_errs.append(check_close(f"batch lane {i} vs its own fit",
                                         mb.alpha[i], own.alpha,
                                         rel_tol=BACKEND_TOL)[0])
    say(f"  krr_fit_batch over {n_mem} members of {sizes.tolist()} points "
        f"(capacity {batch.capacity}, ELL width {batch.spec.max_nbr}, built "
        f"in {batch_build_s:.2f} s): {batch_fit_s:.3f} s, lane iterations "
        f"{iters_lanes}, B1 launches {launches_batch['bsr_spmv_batched']} "
        f"(one per iteration + 1; batch.apply vs bsr "
        f"{err_batch_apply:.2e}); each lane vs its member's own fit "
        f"max-abs {max(lane_errs):.2e}")

    # -- Lanczos: plan.eigs and the spectral embedding, B1 per iteration
    gen = torch.Generator(device=dev).manual_seed(args.seed + 13)
    v0 = torch.randn(plan.n, generator=gen, device=dev)
    reset_counts()
    t0 = time.perf_counter()
    w, U = plan.eigs(k=6, m=m_lanczos, v0=v0)
    sync()
    eigs_s = time.perf_counter() - t0
    launches_eigs = collect_counts("Lanczos (plan.eigs)")
    if not rehearse and launches_eigs["bsr_spmv_batched"] != m_lanczos:
        raise AssertionError(f"plan.eigs launched B1 "
                             f"{launches_eigs['bsr_spmv_batched']} times "
                             f"in {m_lanczos} iterations")
    reset_counts()
    t0 = time.perf_counter()
    ws, Y = spectral_embedding(plan=plan, bandwidth=0, m=m_lanczos,
                               seed=args.seed + 13)
    sync()
    spec_s = time.perf_counter() - t0
    launches_spec = collect_counts("spectral embedding")
    if not rehearse and \
            launches_spec["bsr_spmv_batched"] != m_lanczos + 1:
        raise AssertionError(f"spectral_embedding launched B1 "
                             f"{launches_spec['bsr_spmv_batched']} times")
    with uncounted(*wrappers):
        w_b, _ = plan.eigs(k=6, m=m_lanczos, v0=v0, backend="bsr")
        err_w, scale_w = check_close("eigs cuda vs bsr", w, w_b,
                                     rel_tol=BACKEND_TOL)
        n_plain, _ = normalized_operator(plan, backend="bsr")
        Yc = plan.permute(Y)
        ritz = [float(torch.linalg.vector_norm(
            n_plain(Yc[:, j].contiguous()) - ws[j] * Yc[:, j]))
            for j in range(Yc.shape[1])]
        eye = torch.eye(6, device=dev)
        ortho = {"eigs": float((U.T @ U - eye).abs().max()),
                 "spectral": float((Y.T @ Y - eye[:2, :2]).abs().max())}
        ritz_w = [float(torch.linalg.vector_norm(c)) for c in
                  (plan.matvec(U, backend="bsr") - U * w).T]
        g2 = torch.Generator(device=dev).manual_seed(args.seed + 13)
        v0s = torch.randn(plan.n, generator=g2, device=dev)
        ws_b, _ = spectral_embedding(plan=plan, bandwidth=0, m=m_lanczos,
                                     v0=v0s, backend="bsr")
        err_s, _ = check_close("spectral eigenvalues cuda vs bsr", ws, ws_b,
                               rel_tol=BACKEND_TOL)
    if max(ritz) > 1e-3 or max(ortho.values()) > 1e-4:
        raise AssertionError(f"spectral Ritz residuals {ritz}, U^T U - I "
                             f"{ortho}")
    say(f"  plan.eigs(k=6, m={m_lanczos}): {eigs_s:.3f} s "
        f"({eigs_s * 1e3 / m_lanczos:.3f} ms an iteration), B1 launches "
        f"{launches_eigs['bsr_spmv_batched']}; w {[round(v, 4) for v in w.tolist()]}"
        f", cuda vs bsr (same v0) {err_w:.2e} (scale {scale_w:.3f}); "
        f"|A u - w u| (plain) {[f'{r:.1e}' for r in ritz_w]}; |U^T U - I| "
        f"{ortho['eigs']:.1e}")
    say(f"  spectral_embedding(plan, bandwidth=0, m={m_lanczos}): "
        f"{spec_s:.3f} s, B1 launches {launches_spec['bsr_spmv_batched']}; "
        f"w {[round(v, 6) for v in ws.tolist()]}, cuda vs bsr {err_s:.2e}; "
        f"|N u - w u| (plain) {[f'{r:.1e}' for r in ritz]}; |U^T U - I| "
        f"{ortho['spectral']:.1e}")
    solver_plan = {"max_nbr": b.max_nbr, "kept_tiles": kept,
                   "bandwidth": plan.host.values_fn.bandwidth}
    phase_s = time.perf_counter() - t_phase
    say(f"  phase 13 took {phase_s:.1f} s")
    launches = {name: launches_fit[name] + launches_batch[name]
                + launches_eigs[name] + launches_spec[name]
                for name in launches_fit}
    return {"n": n, "k": k, "build_s": build_s, **solver_plan,
            "krr": {"fit_s": fit_s, "iters": iters,
                    "apply_vs_bsr": err_apply,
                    "b1_launches": launches_fit["bsr_spmv_batched"],
                    "self_weight": shift - lam, "true_rel_resid": true_rel,
                    "alpha_vs_bsr": err_b, "iters_bsr": iters_b,
                    "iters_identity": iters_id, "test_mse": test_mse,
                    "history_bj": res.history[:iters + 1].tolist(),
                    "history_identity": res_id.history[
                        :iters_id + 1].tolist(),
                    "solve_ms": solve_ms, "factor_ms": factor_ms,
                    "loop_ms": loop_ms, "iter_ms": iter_ms,
                    "check_every": CHECK_EVERY, "b1_ms": b1_ms,
                    "b1_share": b1_share, "profile": busy},
            "batch": {"sizes": sizes.tolist(), "build_s": batch_build_s,
                      "apply_vs_bsr": err_batch_apply,
                      "fit_s": batch_fit_s, "iters": iters_lanes,
                      "b1_launches": launches_batch["bsr_spmv_batched"],
                      "max_err_vs_members": max(lane_errs)},
            "lanczos": {"eigs_s": eigs_s, "w": w.tolist(),
                        "ms_per_iter": eigs_s * 1e3 / m_lanczos,
                        "cuda_vs_bsr": err_w, "ritz_eigs": ritz_w,
                        "spectral_s": spec_s, "w_spectral": ws.tolist(),
                        "ritz_spectral": ritz, "ortho": ortho},
            "phase_s": phase_s, "launches": launches, "_batch": batch,
            "_krr": {"plan": plan, "y": y_dev, "alpha": model.alpha,
                     "iters": iters, "lam": lam}}


def probe_knobs(dev, timer, plan, rehearse):
    """The cost model's probed knobs on this card (phase 14): the achieved
    HBM rate of a device copy, host seconds per dispatched kernel back to
    back, a contiguous copy's rate over the SpMV segment gather's (both
    counting bytes read and written), and seconds per scattered COO edge of
    ``index_add_`` (the csr path's scatter), at the SIFT plan's shapes."""
    from repro_torch.core import costmodel

    sync_ = (lambda: torch.cuda.synchronize()) if dev.type == "cuda" \
        else (lambda: None)
    it = 2 if rehearse else 20
    nbytes = (1 << 24) if rehearse else (1 << 30)
    src = torch.empty(nbytes // 4, dtype=torch.float32, device=dev)
    src.uniform_()
    dst = torch.empty_like(src)
    copy_ms = timer(lambda: dst.copy_(src), it)
    hbm_bw = 2 * nbytes / (copy_ms * 1e-3)
    del src, dst
    one = torch.zeros(1, device=dev)
    n_launch = 200 if rehearse else 5000
    one.add_(1.0)
    sync_()
    t0 = time.perf_counter()
    for _ in range(n_launch):
        one.add_(1.0)
    sync_()
    launch_s = (time.perf_counter() - t0) / n_launch
    b = plan.bsr
    x = torch.randn(b.n_cb * b.bs, device=dev).reshape(b.n_cb, b.bs)
    col = b.col_idx.long()
    seg_ms = timer(lambda: x[col], it)
    seg_bytes = 2 * col.numel() * b.bs * 4
    gather_penalty = hbm_bw / (seg_bytes / (seg_ms * 1e-3))
    rows, cols, vals = plan.coo_device()
    contrib = vals * torch.randn(plan.n, device=dev)[cols]
    y = torch.zeros(plan.n, device=dev)
    scatter_ms = timer(lambda: y.index_add_(0, rows, contrib), it)
    edge_cost = scatter_ms * 1e-3 / rows.numel()
    del x, col, contrib, y
    props = (torch.cuda.get_device_properties(0) if dev.type == "cuda"
             else None)
    base = costmodel.HardwareConfig()
    hw = dataclasses.replace(
        base, hbm_bw=hbm_bw, launch_overhead=launch_s,
        gather_penalty=gather_penalty, edge_cost=edge_cost,
        sm_count=props.multi_processor_count if props else base.sm_count)
    return hw, {"copy_ms": copy_ms, "copy_bytes": 2 * nbytes,
                "launches_timed": n_launch, "segment_gather_ms": seg_ms,
                "segment_bytes": seg_bytes, "scatter_ms": scatter_ms,
                "scatter_edges": int(rows.numel())}


def phase_persist(args, dev, timer, sync, rehearse, reset_counts,
                  collect_counts, k_bsr, plan, x, build_s, batch, serve_shape,
                  layer_keys, cfg, tmp):
    """Phase 14: the cost model and autotune with probed H100 knobs, and
    plan persistence through the Checkpointer, on phase 3's SIFT plan,
    phase 13's 8-member batch, phase 10's tick shape and phase 9's keys.
    The checkpoints stay in ``tmp`` for phase 15 (the caller removes it)."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.core import autotune, costmodel
    from repro_torch.kernels import ops

    t_phase = time.perf_counter()
    b = plan.bsr
    kept = int(b.nbr_mask.sum())
    say(f"== phase 14: cost model, autotune and persistence on the SIFT plan "
        f"(n={plan.n}, {kept} kept tiles), phase 13's {batch.batch}-member "
        f"batch and phase 10's tick shape")
    hw, probe = probe_knobs(dev, timer, plan, rehearse)
    try:
        knob_file = tmp / "hw.json"
        hw.to_json(str(knob_file))
        say(f"  probed knobs ({probe}): {json.dumps(hw.to_dict())}")
        costmodel.set_hardware(str(knob_file))
        reset_counts()

        # -- the autotune: probes (calibration) and the model's ranking
        autotune.clear_tune_memo()
        autotune.clear_calibration()
        rng = np.random.default_rng(args.seed + 14)
        tuned = {}
        for f in (1, 8):
            shape = (plan.n,) if f == 1 else (plan.n, f)
            xs = torch.from_numpy(rng.standard_normal(shape).astype(
                np.float32)).to(dev)
            n0 = k_bsr.bsr_spmv_batched.launches
            name, pred = autotune.tune_backend(plan, plan.permute(xs))
            sync()
            grew = k_bsr.bsr_spmv_batched.launches - n0
            rep = next(r for key, r in autotune._TUNE_MEMO.items()
                       if key[2] == len(shape) and key[0] ==
                       plan.spec.shape_key)
            cuda_bytes = rep["costs"]["cuda"]["hbm_bytes"] \
                if "cuda" in rep["costs"] else None
            bound_bytes = spmv_bytes(kept, b.bs, b.col_idx.numel(),
                                     b.n_cb * b.bs * f, b.n_rb * b.bs * f)
            say(f"  tune_backend f={f}: winner {name!r}, the model's ranking "
                f"{rep['ranking']}, predicted s {pred}, calibration "
                f"{rep['calibration']}; B1 launches by the probes {grew}; "
                f"model B1 bytes {cuda_bytes} vs spmv_bytes' {bound_bytes}")
            if not rehearse:
                if name != "cuda":
                    raise AssertionError(f"tune_backend f={f} picked {name!r}")
                # f = 1 calibrates (the probes launch B1 and check it
                # against bsr); f = 8 is then model arithmetic
                if (grew <= 0) if f == 1 else (grew != 0):
                    raise AssertionError(f"tune_backend f={f} launched B1 "
                                         f"{grew} times")
                if cuda_bytes != bound_bytes:
                    raise AssertionError("the model's B1 bytes differ from "
                                         "spmv_bytes'")
            tuned[f"f{f}"] = {"winner": name, "report": rep,
                              "model_first": rep["ranking"][0],
                              "probe_b1_launches": grew}
        n0 = k_bsr.bsr_spmv_batched.launches
        bname, bpred = autotune.tune_batch_backend(batch)
        sync()
        grew = k_bsr.bsr_spmv_batched.launches - n0
        brep = next(r for key, r in autotune._TUNE_MEMO.items()
                    if key[0] == "batch")
        say(f"  tune_batch_backend B={batch.batch}: winner {bname!r}, "
            f"the model's ranking {brep['ranking']}, predicted s {bpred}, calibration "
            f"{brep['calibration']}; B1 launches by the probes {grew}")
        if not rehearse and (bname != "cuda" or grew <= 0):
            raise AssertionError(f"tune_batch_backend picked {bname!r} "
                                 f"({grew} B1 launches)")
        tuned["batch"] = {"winner": bname, "report": brep,
                          "probe_b1_launches": grew}
        feat = costmodel.DecodeFeatures(**serve_shape)
        dname = costmodel.choose_decode_backend(feat,
                                                on_cpu=dev.type != "cuda")
        drep = costmodel.rank_decode_backends(feat,
                                              on_cpu=dev.type != "cuda")
        say(f"  choose_decode_backend {serve_shape}: {dname!r}; ranking "
            f"{drep['ranking']}, predicted s {drep['predicted_s']}")
        if not rehearse and dname != "cuda":
            raise AssertionError(f"choose_decode_backend picked {dname!r}")
        tuned["decode"] = {"winner": dname, "report": drep}
        budgets = []
        for layer in range(layer_keys.shape[0]):
            k_l = layer_keys[layer]                   # (1, Hkv, S, dh)
            q_l = k_l.repeat_interleave(cfg.n_heads // cfg.n_kv_heads, 1)
            c_l, cov = autotune.tune_blocks_per_query(q_l, k_l, cfg.clusterkv)
            budgets.append((c_l.blocks_per_query, cov))
        say(f"  tune_blocks_per_query over {len(budgets)} layers of "
            f"{cfg.name} (keys as queries, S={layer_keys.shape[-2]}, target "
            f"0.95): blocks_per_query {[bq for bq, _ in budgets]}, coverage "
            f"{min(c for _, c in budgets):.3f}-"
            f"{max(c for _, c in budgets):.3f} (config default "
            f"{cfg.clusterkv.blocks_per_query})")
        tuned["blocks_per_query"] = budgets

        # -- the plan round trip: blocking, then async, restored on the card
        ck = Checkpointer(tmp / "ckpt")
        t0 = time.perf_counter()
        ck.save_plan(1, plan, name="sift", blocking=True)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ck.save_plan(2, plan, name="sift")
        async_return_s = time.perf_counter() - t0
        ck.wait()
        async_s = time.perf_counter() - t0
        plan_bytes = disk_bytes(tmp / "ckpt" / "step_2")
        t0 = time.perf_counter()
        back, step = ck.restore_plan(name="sift", device=dev)
        sync()
        restore_s = time.perf_counter() - t0
        if step != 2:
            raise AssertionError(f"restored step {step}")
        bb = back.bsr
        for what, got, want in (("pi", back.pi, plan.pi),
                                ("inv", back.inv, plan.inv),
                                ("col_idx", bb.col_idx, b.col_idx),
                                ("nbr_mask", bb.nbr_mask, b.nbr_mask),
                                ("vals", bb.vals, b.vals)):
            if not torch.equal(got, want):
                raise AssertionError(f"restored {what} differs")
        for f in (1, 8):
            shape = (plan.n,) if f == 1 else (plan.n, f)
            ch = torch.from_numpy(rng.standard_normal(shape).astype(
                np.float32)).to(dev)
            n0 = k_bsr.bsr_spmv_batched.launches
            y_back = back.matvec(ch)
            sync()
            if not rehearse and k_bsr.bsr_spmv_batched.launches != n0 + 1:
                raise AssertionError("the restored plan's matvec was not one "
                                     "B1 launch")
            xs_sorted = back.permute(ch)
            y2 = ops.bsr_spmv(bb.vals, bb.col_idx, xs_sorted, back.n,
                              nbr_mask=bb.nbr_mask)
            with uncounted(k_bsr.bsr_spmv_batched, k_bsr.bsr_spmv):
                if not torch.equal(y_back, plan.matvec(ch)):
                    raise AssertionError(f"restored matvec f={f} differs")
                if not torch.equal(y2, ops.bsr_spmv(
                        b.vals, b.col_idx, xs_sorted, plan.n,
                        nbr_mask=b.nbr_mask)):
                    raise AssertionError(f"restored B2 f={f} differs")
        t0 = time.perf_counter()
        fresh, _ = ck.restore_plan(name="sift", refresh_with=x, device=dev)
        sync()
        refresh_s = time.perf_counter() - t0
        tier = fresh.refresh_stats.last_action
        say(f"  save_plan: blocking {save_s:.3f} s, async {async_return_s:.3f}"
            f" s to return and {async_s:.3f} s to the end; "
            f"{plan_bytes / 1e9:.3f} GB on disk; restore_plan on the card "
            f"{restore_s:.3f} s; build_plan in this run {build_s:.3f} s. "
            f"Restored pi, inv, col_idx, nbr_mask, vals torch.equal; matvec "
            f"through B1 and B2 on its storage torch.equal at (n,) and (n, 8)")
        say(f"  restore_plan(refresh_with=x) at unchanged points: tier "
            f"{tier!r}, migrated {fresh.refresh_stats.last_migrated_frac}, "
            f"{refresh_s:.3f} s")
        if fresh.refresh_stats.last_migrated_frac != 0.0:
            raise AssertionError("unchanged points migrated on restore")
        del back, fresh, bb

        # -- the batch round trip: one B1 launch for every member
        ck.save_plan(3, batch, name="batch", blocking=True)
        batch_bytes = disk_bytes(tmp / "ckpt" / "step_3")
        t0 = time.perf_counter()
        bback, _ = ck.restore_plan(name="batch", device=dev)
        sync()
        batch_restore_s = time.perf_counter() - t0
        xs = torch.from_numpy(rng.standard_normal(
            (batch.batch, batch.capacity)).astype(np.float32)).to(dev)
        n0 = k_bsr.bsr_spmv_batched.launches
        yb = bback.matvec(xs)
        sync()
        if not rehearse and k_bsr.bsr_spmv_batched.launches != n0 + 1:
            raise AssertionError("the restored batch's matvec was not one B1 "
                                 "launch")
        with uncounted(k_bsr.bsr_spmv_batched):
            if not torch.equal(yb, batch.matvec(xs)):
                raise AssertionError("the restored batch's matvec differs")
        say(f"  batch round trip: {batch_bytes / 1e6:.1f} MB on disk, "
            f"restore {batch_restore_s:.3f} s; matvec one B1 launch for "
            f"{batch.batch} members, torch.equal")
        del bback
    finally:
        costmodel.set_hardware(None)
    launches = collect_counts("autotune and persistence")
    if not rehearse:
        for name in ("bsr_spmv_batched", "bsr_spmv"):
            if launches[name] <= 0:
                raise AssertionError(f"phase 14 never launched {name}")
    phase_s = time.perf_counter() - t_phase
    say(f"  phase 14 took {phase_s:.1f} s")
    return {"knobs": hw.to_dict(), "probe": probe, "tuned": tuned,
            "save_s": save_s, "save_async_return_s": async_return_s,
            "save_async_s": async_s, "restore_s": restore_s,
            "plan_disk_bytes": plan_bytes, "build_plan_s": build_s,
            "refresh_tier": tier, "refresh_s": refresh_s,
            "batch_disk_bytes": batch_bytes,
            "batch_restore_s": batch_restore_s, "launches": launches,
            "phase_s": phase_s}


def phase_shard(args, dev, timer, sync, rehearse, reset_counts,
                collect_counts, k_bsr, plan, krr, ckpt_dir):
    """Phase 15: sharded plans on the one card — phase 3's SIFT plan
    sharded 1 and 4 ways (B2 once per shard per matvec), the ``dist``
    backend, a sharded KRR solve on phase 13's plan, a delete-only step
    through ``ShardedPlan.update``, a double-buffer swap absorbed, a
    sharded restore of phase 14's checkpoint, and Qwen2-0.5B's sharded
    long-context decode."""
    from repro_torch import api
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.core import autotune
    from repro_torch.core.doublebuf import DoubleBufferedPlan
    from repro_torch.data.pipeline import feature_mixture
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.solvers import krr_fit
    from repro_torch.solvers.cg import CHECK_EVERY

    t_phase = time.perf_counter()
    b1, b2 = k_bsr.bsr_spmv_batched, k_bsr.bsr_spmv
    it = 2 if rehearse else 20
    meshes = {n: make_mesh((n,), ("data",), [dev] * n) for n in (1, 4)}
    say(f"== phase 15: sharded plans on one card (meshes of 1 and 4 shards "
        f"on {meshes[4].devices_along('data')[0]}; no exchange between "
        f"cards): phase 3's SIFT plan (n={plan.n}, {plan.bsr.n_rb} row "
        f"blocks), phase 13's KRR plan, phase 14's checkpoint, "
        f"Qwen2-0.5B's decode")
    rng = np.random.default_rng(args.seed + 15)
    x = torch.from_numpy(rng.standard_normal(plan.n).astype(np.float32)
                         ).to(dev)
    with uncounted(b1, b2):
        y_ref = plan.matvec(x)                  # unsharded, B1
    sync()
    reset_counts()

    # -- shard, matvec through B2 per shard, held against the unsharded
    rows, sharded = {}, {}
    for n_dev, mesh in meshes.items():
        t0 = time.perf_counter()
        sp = plan.shard(mesh)
        sync()
        shard_s = time.perf_counter() - t0
        s = sp.spec
        n0 = b2.launches
        y = sp.matvec(x)
        sync()
        grew = b2.launches - n0
        sharded[n_dev] = (sp, y)
        if not rehearse and grew != n_dev:
            raise AssertionError(f"{n_dev}-shard matvec launched B2 {grew} "
                                 f"times")
        equal = bool(torch.equal(y, y_ref))
        err, scale = check_close(f"{n_dev}-shard matvec vs unsharded", y,
                                 y_ref, rel_tol=BACKEND_TOL)
        with uncounted(b1, b2):
            ms_un = timer(lambda: plan.matvec(x), it)
            ms_sh = timer(lambda: sp.matvec(x), it)
            ms_un2 = timer(lambda: plan.matvec(x), it)
        rows[n_dev] = {"mode": s.mode, "rb_per": s.rb_per,
                       "halo": [s.halo_lo, s.halo_hi], "n_hot": s.n_hot,
                       "win": s.win,
                       "transfer_fraction": sp.transfer_fraction,
                       "transfer_blocks": s.transfer_blocks,
                       "allgather_blocks": s.allgather_blocks,
                       "shard_s": shard_s, "b2_launches_per_matvec": grew,
                       "torch_equal": equal, "max_abs_err": err,
                       "scale": scale, "ms_sharded": ms_sh,
                       "ms_unsharded": [ms_un, ms_un2]}
        say(f"  {n_dev} shard(s): ShardSpec mode {s.mode!r}, rb_per "
            f"{s.rb_per}, halo ({s.halo_lo}, {s.halo_hi}), n_hot {s.n_hot}, "
            f"window {s.win} blocks, transfer_fraction "
            f"{sp.transfer_fraction:.4f} ({s.transfer_blocks} of "
            f"{s.allgather_blocks} all-gather blocks); shard {shard_s:.3f} s;"
            f" matvec {grew} B2 launches, torch.equal to the unsharded "
            f"matvec: {equal} (max-abs {err:.2e}); ms per matvec sharded "
            f"{ms_sh:.4f}, unsharded {ms_un:.4f} / {ms_un2:.4f}")

    # -- B2 at the shard shapes (rectangular: each window's win + n_hot
    # column blocks against rb_per row blocks) against its plain version
    sp4, y4 = sharded[4]
    s4, bs = sp4.spec, plan.bsr.bs
    xs = plan.permute(x)
    xp = torch.nn.functional.pad(xs, (0, s4.n_rb_pad * bs - plan.n))
    b2_err = []
    with uncounted(b2):
        for d, win in enumerate(sp4._windows(list(xp.split(s4.rb_per * bs)))):
            got = b2(sp4.vals[d], sp4.lcol[d], win[:, None], sp4.mask[d],
                     indices_checked=True)
            b2_err.append(check_close(
                f"B2 on shard {d}'s window", got,
                k_bsr.bsr_spmv_plain(sp4.vals[d], sp4.lcol[d], win[:, None],
                                     sp4.mask[d]))[0])
    say(f"  B2 on each of the 4 shard windows ({s4.rb_per} row blocks x "
        f"{s4.win + s4.n_hot} column blocks) vs its plain version: max-abs "
        f"{max(b2_err):.2e}")

    # -- the dist backend (default mesh: every card, here the one)
    y_dist = plan.apply(xs, backend="dist")
    sync()
    dist_equal = bool(torch.equal(y_dist, plan.permute(y_ref)))
    check_close("dist backend vs unsharded", y_dist, plan.permute(y_ref),
                rel_tol=BACKEND_TOL)
    say(f"  plan.apply(backend='dist'): torch.equal to the unsharded apply: "
        f"{dist_equal}")
    # the multi-device autotune: dist probed on the default mesh (the one
    # card), the decision priced for 4 devices
    n0 = b2.launches
    tuned, _ = autotune.tune_backend(plan, device_count=4)
    sync()
    probe_b2 = b2.launches - n0
    rep = autotune._TUNE_MEMO[next(k for k in reversed(autotune._TUNE_MEMO)
                                   if k[-1] == 4)]
    say(f"  tune_backend(device_count=4): winner {tuned!r}, local ranking "
        f"{rep['ranking']}, dist {rep.get('dist')}; B2 launches by the "
        f"dist probe {probe_b2}")
    if not rehearse and (tuned != "dist" or probe_b2 <= 0):
        raise AssertionError(f"tune_backend(device_count=4) picked "
                             f"{tuned!r} ({probe_b2} B2 launches)")

    # -- a sharded KRR solve on phase 13's plan, against its unsharded fit
    kplan, lam = krr["plan"], krr["lam"]
    sk = kplan.shard(meshes[4])
    n0 = b2.launches
    t0 = time.perf_counter()
    model = krr_fit(sk, krr["y"], lam=lam, precond="block_jacobi")
    sync()
    krr_s = time.perf_counter() - t0
    iters = int(model.result.iters)
    grew = b2.launches - n0
    trips = cg_trips(iters, CHECK_EVERY, kplan.config.cg_maxiter)
    if not bool(model.result.converged):
        raise AssertionError(f"sharded KRR did not converge in {iters}")
    if not rehearse and grew != 4 * (trips + 1):
        raise AssertionError(f"sharded KRR launched B2 {grew} times for "
                             f"{trips} CG iterations + 1 apply on 4 shards")
    if abs(iters - krr["iters"]) > 2:
        raise AssertionError(f"sharded KRR took {iters} iterations, "
                             f"unsharded {krr['iters']}")
    err_k, scale_k = check_close("sharded KRR alpha vs unsharded",
                                 model.alpha, krr["alpha"], rel_tol=1e-3)
    say(f"  krr_fit on phase 13's plan sharded 4 ways (lam {lam}, "
        f"block_jacobi): {krr_s:.3f} s, {iters} iterations (unsharded "
        f"{krr['iters']}), B2 launches {grew} (4 x (iterations + 1)); alpha"
        f" vs the unsharded fit {err_k:.2e} (scale {scale_k:.4f})")

    # -- one delete-only streaming step: the owning shard patched in place
    n_kill = 16 if rehearse else 100           # one run in cluster order
    kill = np.asarray(plan.host.pi[plan.n // 50:plan.n // 50 + n_kill],
                      np.int64)
    t0 = time.perf_counter()
    sp5 = sp4.update(delete=kill)
    sync()
    update_s = time.perf_counter() - t0
    owners = sorted(set((sp5.plan.host.last_patch_rb
                         // sp4.spec.rb_per).tolist()))
    kept_same = [d for d in range(4) if sp5.vals[d] is sp4.vals[d]]
    if (sp5.shard_patches, sp5.reshards) != (1, 0) or \
            kept_same != [d for d in range(4) if d not in owners]:
        raise AssertionError(f"delete step: patches {sp5.shard_patches}, "
                             f"reshards {sp5.reshards}, owners {owners}, "
                             f"untouched tensors {kept_same}")
    ub = sp5.unshard()
    for name in ("col_idx", "nbr_mask", "vals"):
        if not torch.equal(getattr(ub, name), getattr(sp5.plan.bsr, name)):
            raise AssertionError(f"unshard() {name} differs after the step")
    with uncounted(b1, b2):
        if not torch.equal(sp4.matvec(x), y4):
            raise AssertionError("the input ShardedPlan changed (C6)")
        y5 = sp5.matvec(x)
        check_close("streamed shards vs their plan", y5,
                    sp5.plan.matvec(x), rel_tol=BACKEND_TOL)
        step_equal = bool(torch.equal(y5, sp5.plan.matvec(x)))
    say(f"  update(delete={n_kill} points): {update_s:.3f} s host, tier "
        f"{sp5.plan.refresh_stats.last_action!r}, shard_patches "
        f"{sp5.shard_patches}, patched shard(s) {owners}, the others the "
        f"same tensors; unshard() equals the updated plan's BSR; matvec "
        f"torch.equal to the updated plan's: {step_equal}")
    del sp5, ub, y5

    # -- a double-buffer swap absorbed at 32 768 points
    n_db = 2048 if rehearse else 32768
    xdb = feature_mixture(n_db, 128, n_clusters=max(8, n_db // 256),
                          seed=args.seed + 15)
    pdb = api.build_plan(xdb, k=30, bs=32, sb=8, ell_slack=4, device=dev)
    spd = pdb.shard(meshes[4])
    dbp = DoubleBufferedPlan(pdb)
    dead = rng.choice(n_db, int(0.3 * n_db), replace=False)
    t0 = time.perf_counter()
    dbp.update(delete=dead)
    spd = spd.absorb(dbp.plan)
    if (spd.shard_patches, spd.reshards) != (1, 0) or \
            dbp.plan.host.pending_layout != "compact":
        raise AssertionError(f"the in-place half: patches "
                             f"{spd.shard_patches}, pending "
                             f"{dbp.plan.host.pending_layout!r}")
    dbp.wait()
    spd2 = spd.absorb(dbp.plan)
    sync()
    swap_s = time.perf_counter() - t0
    if dbp.generation != 1 or (spd2.reshards, spd2.shard_patches) != (1, 1):
        raise AssertionError(f"the swap: generation {dbp.generation}, "
                             f"reshards {spd2.reshards}")
    xd = torch.from_numpy(rng.standard_normal(dbp.plan.n).astype(
        np.float32)).to(dev)
    with uncounted(b1, b2):
        yd = spd2.matvec(xd)
        check_close("absorbed swap vs its plan", yd, dbp.plan.matvec(xd),
                    rel_tol=BACKEND_TOL)
        swap_equal = bool(torch.equal(yd, dbp.plan.matvec(xd)))
    say(f"  DoubleBufferedPlan at n={n_db}: {len(dead)} deletes tombstoned "
        f"(shards patched), the compaction swapped in and re-sharded on the "
        f"same mesh ({spd2.spec.mode!r}, {spd2.spec.n_dev} shards, n "
        f"{dbp.plan.n}) in {swap_s:.3f} s; matvec torch.equal to the "
        f"successor's: {swap_equal}")
    del dbp, pdb, spd, spd2

    # -- a sharded restore of phase 14's checkpoint
    ck = Checkpointer(ckpt_dir / "ckpt")
    t0 = time.perf_counter()
    rsp, step = ck.restore_plan(name="sift", mesh=meshes[4], device=dev)
    sync()
    restore_s = time.perf_counter() - t0
    with uncounted(b1, b2):
        if rsp.spec != sp4.spec or not torch.equal(rsp.matvec(x), y4):
            raise AssertionError("the sharded restore differs")
    say(f"  restore_plan(mesh=4 shards) of phase 14's step {step}: "
        f"{restore_s:.3f} s, the same ShardSpec, matvec torch.equal")
    del rsp
    launches_plan = collect_counts("sharded plan")
    if not rehearse and launches_plan["bsr_spmv"] <= 0:
        raise AssertionError("phase 15 never launched B2")

    decode = phase_shard_decode(args, dev, sync, rehearse, reset_counts,
                                collect_counts)
    phase_s = time.perf_counter() - t_phase
    say(f"  phase 15 took {phase_s:.1f} s")
    return {"shards": rows, "b2_window_max_abs": b2_err,
            "dist_torch_equal": dist_equal,
            "tune_4": {"winner": tuned, "report": rep,
                       "probe_b2_launches": probe_b2},
            "krr": {"s": krr_s, "iters": iters, "iters_unsharded":
                    krr["iters"], "b2_launches": grew,
                    "alpha_vs_unsharded": err_k},
            "update": {"s": update_s, "patched_shards": owners,
                       "torch_equal": step_equal},
            "swap": {"n": n_db, "s": swap_s, "torch_equal": swap_equal},
            "restore_s": restore_s, "decode": decode,
            "launches": {k: launches_plan[k] + decode["launches"][k]
                         for k in launches_plan},
            "phase_s": phase_s}


def phase_shard_decode(args, dev, sync, rehearse, reset_counts,
                       collect_counts):
    """Phase 15's decode: Qwen2-0.5B at full width, 8
    ``decode_step(sharded_long=True)`` steps with the 8 192-slot cache
    split over 4 shards — at a covering budget (float32) against the
    unsharded decode, then at the default budget (bf16) timed beside it."""
    import dataclasses
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model_api
    from repro_torch.models import transformer as tf
    from repro_torch.models.sharding import ShardCtx

    cfg = qwen_config(rehearse)
    s_max = 256 if rehearse else 8192
    steps = 8
    plen = s_max - cfg.clusterkv.block_k       # the prefill takes whole tiles
    shd = ShardCtx(make_mesh((4,), ("data",), [dev] * 4))
    params = model_api.init(cfg, torch.Generator(device=dev).manual_seed(
        args.seed), device=dev)
    rng = np.random.default_rng(args.seed + 151)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (1, plen))).to(dev)
    reset_counts()

    def prefilled(c):
        cache, logits = tf.prefill(params, c, {"tokens": toks}, "clusterkv")
        return model_api.grow_cache(c, cache, s_max), logits

    def clone(cache):
        return {k: v.clone() for k, v in cache.items()}

    # covering budget, float32: both sides attend every tile
    cover = s_max // cfg.clusterkv.block_k
    cfgc = cfg.with_(dtype="float32", clusterkv=dataclasses.replace(
        cfg.clusterkv, blocks_per_query=cover, decode_clusters=cover))
    ca, logits = prefilled(cfgc)
    cb = clone(ca)
    na = nb = logits.argmax(-1)[:, None]
    errs = []
    for _ in range(steps):
        la, ca = tf.decode_step(params, cfgc, ca, na, "clusterkv")
        lb, cb = tf.decode_step(params, cfgc, cb, nb, "clusterkv",
                                sharded_long=True, shd=shd)
        err, scale = check_close("sharded decode vs unsharded (covering)",
                                 lb, la, rel_tol=1e-3)
        errs.append((err, scale))
        na, nb = la.argmax(-1)[:, None], lb.argmax(-1)[:, None]
        if not torch.equal(na, nb):
            raise AssertionError("the sharded decode chose another token")
    say(f"  {cfg.name} ({cfg.n_layers} layers, d_model {cfg.d_model}), "
        f"covering budget ({cover} tiles), float32: {steps} "
        f"decode_step(sharded_long=True) on 4 shards of a {s_max}-slot "
        f"cache give the unsharded tokens; logits max-abs "
        f"{max(e for e, _ in errs):.2e} (scale {errs[0][1]:.2f}, tolerance "
        f"0.001 x scale)")
    del ca, cb

    # default budget, bf16: ms per step, sharded against clusterkv_decode
    cache, logits = prefilled(cfg)
    times = {}
    for name, kw in (("unsharded", {}),
                     ("sharded", {"sharded_long": True, "shd": shd}),
                     ("unsharded_2", {})):
        c, nxt, ts = clone(cache), logits.argmax(-1)[:, None], []
        for _ in range(steps):
            sync()
            t0 = time.perf_counter()
            lg, c = tf.decode_step(params, cfg, c, nxt, "clusterkv", **kw)
            sync()
            ts.append((time.perf_counter() - t0) * 1e3)
            nxt = lg.argmax(-1)[:, None]
            if not bool(torch.isfinite(lg).all()):
                raise AssertionError(f"{name} decode: non-finite logits")
        times[name] = ts
    med = {k: float(np.median(v)) for k, v in times.items()}
    s_local = s_max // 4
    bk = min(cfg.clusterkv.block_k, s_local)
    per_shard = min(cfg.clusterkv.decode_clusters, s_local // bk)
    say(f"  default budget ({cfg.clusterkv.decode_clusters} tiles; "
        f"{per_shard} of each shard's {s_local // bk}), {cfg.dtype}: ms per "
        f"step (host clock, median of {steps}) sharded {med['sharded']:.2f},"
        f" clusterkv_decode {med['unsharded']:.2f} / "
        f"{med['unsharded_2']:.2f}")
    launches = collect_counts("sharded decode")
    del params, cache
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return {"s_max": s_max, "covering_max_abs": [e for e, _ in errs],
            "covering_scale": errs[0][1], "ms_per_step": med,
            "step_ms": times, "per_shard_tiles": per_shard,
            "launches": launches}


# ---------------------------------------------------------------------------
# the decoder-only model zoo at full width (phase 16)
# ---------------------------------------------------------------------------

# the six configurations of phase 16 in their order, and the depth one
# 80 GB card holds (None: every layer). Widths are never cut.
ZOO = (("granite-moe-3b-a800m", None), ("h2o-danube-3-4b", None),
       ("minicpm3-4b", None), ("llava-next-34b", None),
       ("mistral-large-123b", 20), ("llama4-maverick-400b-a17b", 1))
# layers of mistral-large-123b the float32 check against its flash path
# holds (its bf16 weights read in float32)
MISTRAL_F32_LAYERS = 4


def zoo_config(arch: str, depth, rehearse: bool):
    """The config of ``arch`` at full width, cut to ``depth`` layers, and
    the list of cuts; llava-next-34b keeps bf16 master weights (float32
    would be 126 GiB). The CPU rehearsal takes the reduced config with
    tiles of 32."""
    from repro_torch.configs import ClusterKVConfig, get_config, reduced_config
    if rehearse:
        cfg = reduced_config(arch)
        if get_config(arch).clusterkv.enabled:
            cfg = cfg.with_(clusterkv=ClusterKVConfig(
                enabled=True, block_q=32, block_k=32, blocks_per_query=4,
                decode_clusters=4))
        return cfg, ["reduced config (CPU rehearsal)"]
    cfg, cuts = get_config(arch), []
    if arch == "llava-next-34b":
        cfg = cfg.with_(param_dtype="bfloat16")
        cuts.append("param_dtype bfloat16 (float32 masters: 126 GiB)")
    if depth is not None and depth < cfg.n_layers:
        cuts.append(f"depth {depth} of {cfg.n_layers} layers")
        cfg = cfg.with_(n_layers=depth)
    return cfg, cuts


def tree_bytes(params) -> int:
    from repro_torch.models import param as pm
    return sum(t.numel() * t.element_size() for t in pm.tree_leaves(params))


def covering(cfg, max_seq: int):
    """``cfg`` in float32 with ClusterKV budgets that cover every tile of a
    ``max_seq`` cache: ClusterKV is then exact attention."""
    n = max_seq // cfg.clusterkv.block_k
    return cfg.with_(dtype="float32", clusterkv=dataclasses.replace(
        cfg.clusterkv, blocks_per_query=n, decode_clusters=n))


def zoo_serve(args, dev, sync, cfg, params, rehearse, reset_counts,
              collect_counts):
    """Granite served on phase 10's traffic through ``Engine(backend=
    "clusterkv")`` and ``ClusterKVEngine(mode="plan", knn=8,
    plan_prefill=True)``, then the float32 covering-budget check against
    the flash engine."""
    from repro_torch.serve import ClusterKVEngine
    from repro_torch.train.serve_loop import Engine, Request

    out = {}
    for name in ("Engine", "ClusterKVEngine"):
        sizes, reqs, rng = serve_traffic(args, cfg, rehearse)
        slots, max_seq, bucket, n_req, max_new, lo, hi = sizes
        if name == "Engine":
            eng = Engine(cfg, params, slots=slots, max_seq=max_seq,
                         prefill_bucket=bucket, backend="clusterkv",
                         device=dev)
        else:
            eng = ClusterKVEngine(cfg, params, slots=slots, max_seq=max_seq,
                                  prefill_bucket=bucket, mode="plan", knn=8,
                                  plan_prefill=True, device=dev)
        for r in reqs:
            eng.submit(r)
        sync()
        reset_counts()
        t0 = time.perf_counter()
        eng.run()
        sync()
        wall = time.perf_counter() - t0
        launches = collect_counts(f"{cfg.name} served by {name}")
        for r in reqs:
            if len(r.output) != max_new or not all(0 <= t < cfg.vocab
                                                   for t in r.output):
                raise AssertionError(f"{name} request {r.rid}: {r.output}")
        generated = sum(len(r.output) for r in reqs)
        plan_mode = launches["decode_attend_fused.plan_mode"]
        if not rehearse and (
                launches["block_attention"] != cfg.n_layers * n_req
                or plan_mode != cfg.n_layers * eng.ticks
                or launches["decode_attend_fused"] != plan_mode):
            raise AssertionError(f"{name}: {eng.ticks} ticks and {n_req} "
                                 f"prefills launched {launches}")
        pre = [t * 1e3 for t in eng.timings["prefill_s"]]
        tick = [t * 1e3 for t in eng.timings["tick_s"]]
        say(f"  {name}: {n_req} requests of {lo}-{hi} tokens, {generated} "
            f"tokens in {wall:.2f} s = {generated / wall:.2f} tokens/s, "
            f"{eng.ticks} ticks; prefill ms {min(pre):.1f}-{max(pre):.1f} "
            f"(median {float(np.median(pre)):.1f}); tick ms median "
            f"{float(np.median(tick)):.2f} ({min(tick):.2f}-"
            f"{max(tick):.2f}); B6 {launches['block_attention']}, B5 "
            f"{launches['decode_attend_fused']} launches")
        out[name] = {"wall_s": wall, "generated": generated,
                     "tokens_per_s": generated / wall, "ticks": eng.ticks,
                     "prefill_ms": pre, "tick_ms": tick,
                     "tick_ms_median": float(np.median(tick)),
                     "launches": launches}
        del eng
    # float32, budgets covering every tile: the ClusterKV engine must give
    # the flash engine's greedy tokens and first-token logits
    cfgc = covering(cfg, max_seq)
    chk = [rng.integers(0, cfg.vocab, int(n)).astype(np.int64)
           for n in ((40, 70) if rehearse else (2048, 3000))]
    outs, firsts = {}, {}
    for backend in ("flash", "clusterkv"):
        e = Engine(cfgc, params, slots=2, max_seq=max_seq,
                   prefill_bucket=bucket, backend=backend, device=dev)
        rs = [Request(rid=i, tokens=t, max_new=8) for i, t in enumerate(chk)]
        for r in rs:
            e.submit(r)
        e.run()
        outs[backend] = [r.output for r in rs]
        firsts[backend] = e.first_logits
        del e
    collect_counts(f"{cfg.name} covering-budget check")
    if outs["flash"] != outs["clusterkv"]:
        raise AssertionError(f"clusterkv engine tokens {outs['clusterkv']} "
                             f"!= flash engine tokens {outs['flash']}")
    errs = [check_close(f"{cfg.name} first-token logits request {i}",
                        firsts["clusterkv"][i], firsts["flash"][i],
                        rel_tol=SERVE_TOL) for i in range(2)]
    say(f"  covering budgets, float32: 2 requests x 8 tokens equal the "
        f"flash engine's; first-token logits max-abs "
        + ", ".join(f"{e:.2e} (scale {s:.2f})" for e, s in errs)
        + f", tolerance {SERVE_TOL:g} x scale")
    out["check_tokens"] = outs["clusterkv"]
    out["check_logit_err"] = [e for e, _ in errs]
    return out


def zoo_run(args, dev, sync, cfg, params, rehearse, reset_counts,
            collect_counts):
    """One prompt through ``prefill`` (ClusterKV where the config enables
    it, else flash; a vlm model takes (1, S, d) embeddings), then scalar
    ``decode_step``s in a grown cache (a vlm model continues from (1, 1,
    d) embeddings). Returns prefill ms and ms a step."""
    from repro_torch.models import model_api
    from repro_torch.models import transformer as tf

    swa = bool(cfg.swa_window)
    plen = (96 if swa else 64) if rehearse else (6144 if swa else 4096)
    s_max, steps = (128, 3) if rehearse else (8192, 8)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 16)
    dt = tf.compute_dtype(cfg)
    if cfg.embedding_inputs:
        batch = {"embeddings": torch.randn((1, plen, cfg.d_model),
                                           generator=gen, device=dev).to(dt)}
    else:
        batch = {"tokens": torch.randint(0, cfg.vocab, (1, plen),
                                         generator=gen, device=dev)}
    sync()
    reset_counts()
    t0 = time.perf_counter()
    cache, logits = tf.prefill(params, cfg, batch, "clusterkv")
    sync()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    pre = collect_counts(f"{cfg.name} prefill")
    cache = model_api.grow_cache(cfg, cache, s_max)
    nxt = logits.argmax(-1)[:, None]
    step_ms = []
    for _ in range(steps):
        if cfg.embedding_inputs:
            nxt = torch.randn((1, 1, cfg.d_model), generator=gen,
                              device=dev).to(dt)
        sync()
        t0 = time.perf_counter()
        logits, cache = tf.decode_step(params, cfg, cache, nxt, "clusterkv")
        nxt = logits.argmax(-1)[:, None]
        sync()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    dec = collect_counts(f"{cfg.name} decode steps")
    if tuple(logits.shape) != (1, cfg.vocab) or \
            not torch.isfinite(logits).all():
        raise AssertionError(f"{cfg.name}: decode logits of shape "
                             f"{tuple(logits.shape)} or not finite")
    if not rehearse:
        use_ckv = cfg.clusterkv.enabled
        want6 = cfg.n_layers if use_ckv else 0
        # MLA decodes by the absorbed dense einsum, no kernel
        want5 = cfg.n_layers * steps if use_ckv and cfg.mla is None else 0
        if pre["block_attention"] != want6 or \
                dec["decode_attend_fused.plain_mode"] != want5:
            raise AssertionError(f"{cfg.name}: prefill launched {pre}, "
                                 f"decode {dec}")
    return {"prompt": plen, "cache": s_max, "steps": steps,
            "prefill_ms": prefill_ms, "step_ms": step_ms,
            "step_ms_median": float(np.median(step_ms)),
            "launches_prefill": pre, "launches_decode": dec}


def zoo_flash_check(args, dev, sync, cfg, params, rehearse):
    """float32, budgets covering every tile: ``prefill`` and two decode
    steps through ClusterKV give the flash path's logits (1e-3 x scale)
    and tokens (the family's own module: the transformer, or the hybrid's
    shared block)."""
    from repro_torch.models import model_api

    tf = model_api.module_for(cfg)
    plen, s_max = (64, 128) if rehearse else (2048, 4096)
    cfgc = covering(cfg, s_max)
    rng = np.random.default_rng(args.seed + 161)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (1, plen))).to(dev)
    runs = {}
    for backend in ("flash", "clusterkv"):
        cache, lg = tf.prefill(params, cfgc, {"tokens": tokens}, backend)
        cache = model_api.grow_cache(cfgc, cache, s_max)
        lgs, nxt = [lg], lg.argmax(-1)[:, None]
        for _ in range(2):
            lg, cache = tf.decode_step(params, cfgc, cache, nxt, backend)
            lgs.append(lg)
            nxt = lg.argmax(-1)[:, None]
        runs[backend] = lgs
        del cache
    sync()
    errs = [check_close(f"{cfg.name} float32 logits {i}", a, b,
                        rel_tol=SERVE_TOL)
            for i, (a, b) in enumerate(zip(runs["clusterkv"],
                                           runs["flash"]))]
    if [int(a.argmax()) for a in runs["clusterkv"]] != \
            [int(b.argmax()) for b in runs["flash"]]:
        raise AssertionError(f"{cfg.name}: ClusterKV and flash pick other "
                             "tokens")
    depth = f"{cfg.n_layers} layers"
    if cfg.family == "hybrid":
        from repro_torch.models import hybrid
        depth = (f"full depth ({hybrid._n_groups(cfg) * cfg.shared_attn_every}"
                 f" mamba2 layers)")
    say(f"  float32 at {depth}, budgets covering every tile: "
        f"prefill of {plen} tokens + 2 steps, ClusterKV vs flash logits "
        f"max-abs " + ", ".join(f"{e:.2e} (scale {s:.2f})" for e, s in errs)
        + f", tolerance {SERVE_TOL:g} x scale; same tokens")
    return {"layers": cfg.n_layers, "prompt": plen,
            "logit_err": [e for e, _ in errs],
            "scale": [s for _, s in errs]}


def moe_plain(ffn, x, moe):
    """An independent plain MoE FFN over ``x`` (T, d), in float32: the
    router by ``torch.topk``, each (token, choice) taken in token order and
    kept while its expert holds fewer than ``ceil(T k cf / E)`` tokens
    (Switch drops), then one expert at a time over the tokens it kept, and
    the shared expert. Returns (y (T, d) float32, dropped choices)."""
    t, d = x.shape
    xf = x.float()
    probs = torch.softmax(xf @ ffn["router"]["w"].float(), dim=-1)
    gates, eidx = torch.topk(probs, moe.top_k, dim=-1)
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    cap = max(1, math.ceil(t * moe.top_k * moe.capacity_factor
                           / moe.n_experts))
    load = [0] * moe.n_experts
    kept = [[] for _ in range(moe.n_experts)]
    for ti, choice in enumerate(eidx.tolist()):
        for j, e in enumerate(choice):
            if load[e] < cap:
                kept[e].append((ti, j))
            load[e] += 1
    y = torch.zeros((t, d), dtype=torch.float32, device=x.device)
    for e, rows in enumerate(kept):
        if not rows:
            continue
        ti = torch.tensor([r[0] for r in rows], device=x.device)
        tj = torch.tensor([r[1] for r in rows], device=x.device)
        xe = xf[ti]
        h = torch.nn.functional.silu(xe @ ffn["wg"][e].float()) \
            * (xe @ ffn["wu"][e].float())
        y[ti] += gates[ti, tj, None] * (h @ ffn["wd"][e].float())
    if "shared" in ffn:
        sh = ffn["shared"]
        h = torch.nn.functional.silu(xf @ sh["wg"].float()) \
            * (xf @ sh["wu"].float())
        y = y + h @ sh["wd"].float()
    return y, sum(max(0, n - cap) for n in load)


def zoo_moe_check(args, dev, cfg, params, rehearse):
    """Layer 0's MoE FFN at full width against :func:`moe_plain` on 512
    seeded tokens: in float32 (``REL_TOL``) where the model's float32
    experts fit beside it, else in the model's bf16 (maverick: its 128
    experts cast to float32 would be 64 GiB), to ``MOE_BF16_TOL``."""
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import param as pm

    ffn = pm.layer(params["layers"], 0)["ffn"]
    t = 64 if rehearse else 512
    dtype = (torch.float32 if cfg.param_dtype == "float32"
             else torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 162)
    x = torch.randn((t, cfg.d_model), generator=gen, device=dev).to(dtype)
    y, _ = moe_mod.moe_ffn(ffn, x[None], cfg)
    want, dropped = moe_plain(ffn, x, cfg.moe)
    tol = REL_TOL if dtype == torch.float32 else MOE_BF16_TOL
    err, scale = check_close(f"{cfg.name} MoE FFN layer 0", y[0].float(),
                             want, rel_tol=tol)
    say(f"  MoE FFN, layer 0, {t} tokens in {dtype}: {cfg.moe.n_experts} "
        f"experts top {cfg.moe.top_k}, {dropped} of {t * cfg.moe.top_k} "
        f"choices dropped; against a plain per-expert loop in float32 "
        f"max-abs {err:.2e} (scale {scale:.2f}, tolerance {tol:g} x scale)")
    return {"tokens": t, "dtype": str(dtype), "dropped": dropped,
            "max_abs_err": err, "scale": scale, "tolerance": tol}


def phase_zoo(args, dev, sync, rehearse, reset_counts, collect_counts):
    """Phase 16: the six A13a configurations at full width, one after the
    other (each freed before the next)."""
    from repro_torch.models import model_api

    t_phase = time.perf_counter()
    say("== phase 16: the decoder-only model zoo at full width")
    out = {}
    for arch, depth in ZOO:
        cfg, cuts = zoo_config(arch, depth, rehearse)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        gen_w = torch.Generator(device=dev).manual_seed(args.seed)
        t0 = time.perf_counter()
        params = model_api.init(cfg, gen_w, device=dev)
        sync()
        init_s = time.perf_counter() - t0
        nbytes = tree_bytes(params)
        peak = (torch.cuda.max_memory_allocated() if dev.type == "cuda"
                else None)
        if cfg.mla is not None:
            m = cfg.mla
            heads = (f"MLA, {cfg.n_heads} heads of q/k "
                     f"{m.qk_nope_head_dim + m.qk_rope_head_dim}, v "
                     f"{m.v_head_dim}")
        else:
            heads = (f"GQA {cfg.n_heads}/{cfg.n_kv_heads} heads of "
                     f"{cfg.head_dim}")
        say(f" -- {cfg.name} [{cfg.family}]: {cfg.n_layers} layers, d_model "
            f"{cfg.d_model}, {heads}, d_ff {cfg.d_ff}"
            + (f", {cfg.moe.n_experts} experts top {cfg.moe.top_k} "
               f"(+{cfg.moe.n_shared_experts} shared) of d_ff "
               f"{cfg.moe.d_ff_expert}" if cfg.moe else "")
            + (f", SWA {cfg.swa_window}" if cfg.swa_window else "")
            + f", vocab {cfg.vocab}; ClusterKV "
            + ("on" if cfg.clusterkv.enabled else "off (flash)")
            + f"; {cfg.param_dtype} weights {nbytes / 2 ** 30:.2f} GiB from "
            f"seed {args.seed} in {init_s:.2f} s"
            + (f" (peak {peak / 2 ** 30:.2f} GiB)" if peak else "")
            + (f"; cut: {'; '.join(cuts)}" if cuts else "; nothing cut"))
        row = {"family": cfg.family, "layers": cfg.n_layers, "cuts": cuts,
               "param_dtype": cfg.param_dtype, "weight_bytes": nbytes,
               "init_s": init_s, "init_peak_bytes": peak}
        if cfg.moe is not None:
            row["moe_check"] = zoo_moe_check(args, dev, cfg, params,
                                             rehearse)
        if arch == "granite-moe-3b-a800m":
            row["serve"] = zoo_serve(args, dev, sync, cfg, params, rehearse,
                                     reset_counts, collect_counts)
        else:
            row.update(zoo_run(args, dev, sync, cfg, params, rehearse,
                               reset_counts, collect_counts))
            say(f"  prefill of {row['prompt']} tokens "
                f"{row['prefill_ms']:.1f} ms; {row['steps']} decode steps "
                f"in a {row['cache']}-slot cache, median "
                f"{row['step_ms_median']:.2f} ms a step "
                f"({min(row['step_ms']):.2f}-{max(row['step_ms']):.2f})")
            if arch in ("minicpm3-4b", "mistral-large-123b"):
                fcfg = (cfg.with_(n_layers=MISTRAL_F32_LAYERS)
                        if arch == "mistral-large-123b" and not rehearse
                        else cfg)
                row["float32_check"] = zoo_flash_check(
                    args, dev, sync, fcfg, params, rehearse)
                collect_counts(f"{cfg.name} float32 check")
        out[arch] = row
        del params
        sync()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t_phase
    say(f"  phase 16 wall time: {out['wall_s']:.1f} s")
    return out


def check_zoo_shapes(args, dev, rehearse):
    """B6 and B5 held against their plain versions at the heads and dims
    each ClusterKV configuration of phase 16 gives them, in bf16 (the
    models' runs) and float32 (the covering checks): B6 as one causal
    prefill layer of 4096 tokens; B5 as one scalar decode step's layer in
    an 8192-slot cache (plain mode), and for the served granite also at
    the engines' 4 slots in plan mode, with and without the self column.
    MLA layers decode by a dense einsum and reach no B5. zamba2-1.2b's
    shared block (phase 17) at its run's own shapes: B6 over 4 prompts of
    3968 tokens, B5 at batch 4 in the 4096-slot cache, 32 / 32 heads of
    128 (g = 1)."""
    from repro_torch.kernels import block_attention as k_ba
    from repro_torch.kernels import decode_attend as k_da

    gen = torch.Generator(device=dev).manual_seed(args.seed + 163)
    rows = []
    for arch, _ in ZOO + (("zamba2-1.2b", None),):
        cfg, _ = zoo_config(arch, None, rehearse)
        ck = cfg.clusterkv
        if not ck.enabled:
            continue
        # the hybrid's shared block: one batch of phase 17's zamba2 run
        # (4 prompts of 3968 tokens, a 4096-slot cache)
        hybrid = cfg.family == "hybrid"
        b6 = 4 if hybrid else 1
        s6 = (96 if hybrid else 128) if rehearse else (
            ZAMBA_PROMPT if hybrid else 4096)
        s5 = (128 if hybrid else 256) if rehearse else (
            ZAMBA_PROMPT + ZAMBA_GEN if hybrid else 8192)
        if cfg.mla is not None:
            m = cfg.mla
            hq = hkv = cfg.n_heads
            dh, dv = m.qk_nope_head_dim + m.qk_rope_head_dim, m.v_head_dim
        elif hybrid:
            hq = hkv = cfg.n_heads
            dh = dv = 2 * cfg.d_model // cfg.n_heads
        else:
            hq, hkv, dh, dv = (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                               cfg.head_dim)
        g = hq // hkv
        for dtype in (torch.bfloat16, torch.float32):
            ulps = BF16_ULPS if dtype == torch.bfloat16 else 0
            n6 = min(ck.blocks_per_query, s6 // ck.block_k)
            q, k, _, kpos, qpos, idx = attention_inputs(
                gen, b6, hq, hkv, s6, dh, ck.block_q, n6, dtype, dev)
            v = torch.randn((b6, hkv, s6, dv), generator=gen,
                            device=dev).to(dtype)
            kw = dict(bq=ck.block_q, bk=ck.block_k)
            err, scale = check_close(
                f"block_attention {arch} {dtype}",
                k_ba.block_attention(q, k, v, kpos, qpos, idx, **kw).float(),
                k_ba.block_attention_plain(q, k, v, kpos, qpos, idx,
                                           **kw).float(), bf16_ulps=ulps)
            rows.append({"kernel": "block_attention", "config": arch,
                         "dtype": str(dtype), "B": b6, "hq": hq, "hkv": hkv,
                         "dh": dh, "dv": dv, "S": s6, "n_sel": n6,
                         "max_abs_err": err, "scale": scale})
            say(f"  B6 {arch:26s} {str(dtype):14s} B={b6} {hq}/{hkv} heads, "
                f"q/k {dh}, v {dv}, S={s6}, {n6} tiles: err {err:.2e} "
                f"(scale {scale:.2f})")
            del q, k, v, kpos, qpos, idx
            if cfg.mla is not None:
                continue
            bk = ck.block_k
            n5 = min(ck.decode_clusters, s5 // bk)
            modes = [("plain", b6)]
            if arch == "granite-moe-3b-a800m":
                modes += [("plan", 4), ("plan+self", 4)]
            for mode, b in modes:
                plan_mode = mode != "plain"
                q, k, v, pos, cent = decode_inputs(
                    gen, b, hkv, g, s5, dh, bk, dtype, dev,
                    holes=0.2 if plan_mode else 0.0)
                ks = torch.randn((b, hkv, dh), generator=gen,
                                 device=dev).to(dtype)
                vs = torch.randn((b, hkv, dh), generator=gen,
                                 device=dev).to(dtype)
                # plain mode decodes at one scalar position for the batch
                qp = (torch.tensor([s5 - 500, s5 // 3, s5 - 1, 40],
                                   dtype=torch.int32, device=dev)
                      if plan_mode else
                      torch.tensor([s5 // 2 + 4], dtype=torch.int32,
                                   device=dev))
                kw = dict(n_sel=n5, bk=bk, plan_mode=plan_mode,
                          has_self=mode == "plan+self",
                          window=ck.local_window_blocks * bk)
                err, scale = check_close(
                    f"decode_attend {arch} {dtype} {mode}",
                    k_da.decode_attend_fused(q, k, v, pos, cent, qp, ks, vs,
                                             **kw).float(),
                    k_da.decode_attend_plain(q, k, v, pos, cent, qp, ks, vs,
                                             **kw).float(), bf16_ulps=ulps)
                rows.append({"kernel": "decode_attend_fused", "config": arch,
                             "dtype": str(dtype), "B": b, "hkv": hkv, "g": g,
                             "dh": dh, "S": s5, "n_sel": n5, "mode": mode,
                             "max_abs_err": err, "scale": scale})
                say(f"  B5 {arch:26s} {str(dtype):14s} B={b} {hkv} kv heads "
                    f"g={g} dh={dh} S={s5} {n5} tiles {mode}: err {err:.2e} "
                    f"(scale {scale:.2f})")
                del q, k, v, pos, cent
    return rows


def time_zoo_kernels(args, dev, timer, rehearse):
    """B6 at the zoo's new shapes (one prefill layer at S = 4096, 16 of 32
    tiles: llava-next-34b's 56 / 8 heads of 128 in bf16 and float32,
    minicpm3-4b's 40 MLA heads of q/k 96 and v 64 in bf16; zamba2-1.2b's
    shared block, 4 prompts of 3968 tokens, 32 / 32 heads of 128, 16 of 31
    tiles) and B5 at head dim 128 (one scalar decode step's layer, 16
    tiles: g = 7 and 12 in an 8192-slot cache, zamba2's g = 1 over 32 kv
    heads at batch 4 in a 4096-slot cache), each beside its plain version
    and its bound, B6 also beside SDPA with the equivalent boolean
    mask."""
    from repro_torch.kernels import block_attention as k_ba
    from repro_torch.kernels import decode_attend as k_da

    gen = torch.Generator(device=dev).manual_seed(args.seed + 22)
    it_fast, it_slow = (2, 1) if rehearse else (20, 3)
    n6 = 4 if rehearse else 16
    sz = 512 if rehearse else ZAMBA_PROMPT
    b6 = []
    for what, b, s6, hq, hkv, dh, dv, dtype in (
            ("llava-next-34b", 1, 4096, 56, 8, 128, 128, torch.bfloat16),
            ("llava-next-34b", 1, 4096, 56, 8, 128, 128, torch.float32),
            ("minicpm3-4b", 1, 4096, 40, 40, 96, 64, torch.bfloat16),
            # zamba2-1.2b's shared block in phase 17's prefill (g = 1)
            ("zamba2-1.2b", 4, sz, 32, 32, 128, 128, torch.bfloat16)):
        if rehearse:
            dtype, s6 = torch.float32, 512
        q, k, _, kpos, qpos, idx = attention_inputs(
            gen, b, hq, hkv, s6, dh, 128, n6, dtype, dev)
        v = torch.randn((b, hkv, s6, dv), generator=gen, device=dev).to(dtype)
        run = lambda: k_ba.block_attention(q, k, v, kpos, qpos, idx, bq=128,
                                           bk=128)
        plain = lambda: k_ba.block_attention_plain(q, k, v, kpos, qpos, idx,
                                                   bq=128, bk=128)
        ulps = BF16_ULPS if dtype == torch.bfloat16 else 0
        err, scale = check_close(f"block_attention {what} {dtype}",
                                 run().float(), plain().float(),
                                 bf16_ulps=ulps)
        ms, plain_ms = timer(run, it_fast), timer(plain, it_slow)
        g = hq // hkv
        tile_of = torch.arange(s6, device=dev) // 128
        sel = torch.zeros((b, hkv, s6 // 128, s6 // 128), dtype=torch.bool,
                          device=dev)
        sel.scatter_(-1, idx.long(), True)
        mask = sel[:, :, :, tile_of].repeat_interleave(128, dim=2)
        mask &= kpos[:, :, None, :] <= qpos[None, None, :, None]
        mask = mask.repeat_interleave(g, dim=1)
        kx, vx = k.repeat_interleave(g, dim=1), v.repeat_interleave(g, dim=1)
        lib_ms = timer(lambda: torch.nn.functional
                       .scaled_dot_product_attention(q, kx, vx,
                                                     attn_mask=mask),
                       it_fast)
        del mask, kx, vx, sel
        # 2 x bq x bk x (dh + dv) operations a selected tile pair (q.k and
        # p.v); bytes: q, k, v, positions, indices and the output, once
        elem = 2 if dtype == torch.bfloat16 else 4
        ops = 2.0 * b * hq * (s6 // 128) * n6 * 128 * 128 * (dh + dv)
        byts = elem * b * (hq * s6 * (dh + dv) + hkv * s6 * (dh + dv)) \
            + 4 * (b * hkv * s6 + s6 + b * hkv * (s6 // 128) * n6)
        rate = BF16_FLOP_PER_S if elem == 2 else FP32_FLOP_PER_S
        t_b, t_o = byts / HBM_BYTES_PER_S * 1e3, ops / rate * 1e3
        bound, by = (t_b, "bytes") if t_b >= t_o else (t_o, "operations")
        say(f"  B6 {what} layer: q ({b}, {hq}, {s6}, {dh}), k ({b}, {hkv}, "
            f"{s6}, {dh}), v (..., {dv}) {dtype}, {n6} tiles of 128: kernel "
            f"{ms:.3f} ms  plain {plain_ms:.3f} ms  SDPA (boolean mask) "
            f"{lib_ms:.3f} ms  bound {bound:.3f} ms ({by}: "
            f"{ops / 1e9:.1f} GFLOP); err {err:.2e} (scale {scale:.2f})")
        b6.append({"config": what, "dtype": str(dtype), "B": b, "hq": hq,
                   "hkv": hkv, "dh": dh, "dv": dv, "S": s6, "n_sel": n6,
                   "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                   "library_ms": lib_ms, "bound_ms": bound, "bound_by": by,
                   "gflop": ops / 1e9})
        del q, k, v, kpos, qpos, idx
    b5 = []
    n5 = 4 if rehearse else 16
    dtype = torch.float32 if rehearse else torch.bfloat16
    for what, b, hkv, g, s5 in (
            ("llava-next-34b", 1, 8, 7, 8192),
            ("mistral-large-123b", 1, 8, 12, 8192),
            # zamba2-1.2b's shared block in phase 17's decode (g = 1)
            ("zamba2-1.2b", 4, 32, 1, ZAMBA_PROMPT + ZAMBA_GEN)):
        if rehearse:
            s5 = 1024
        q, k, v, pos, cent = decode_inputs(gen, b, hkv, g, s5, 128, 128,
                                           dtype, dev, holes=0.0)
        qp = torch.tensor([s5 - 1], dtype=torch.int32, device=dev)
        kw = dict(n_sel=n5, bk=128, plan_mode=False, has_self=False,
                  window=128)
        run = lambda: k_da.decode_attend_fused(q, k, v, pos, cent, qp, **kw)
        plain = lambda: k_da.decode_attend_plain(q, k, v, pos, cent, qp,
                                                 **kw)
        err, scale = check_close(f"decode_attend {what} g={g}",
                                 run().float(), plain().float(),
                                 bf16_ulps=0 if rehearse else BF16_ULPS)
        ms, plain_ms = timer(run, it_fast), timer(plain, it_slow)
        device_ms = timer.device_time(run, it_fast)
        bound, by = decode_bound(b, hkv, g, s5, 128, 128, n5,
                                 4 if rehearse else 2, False)
        say(f"  B5 {what} decode-step layer: q ({b}, {hkv * g}, 128), k/v "
            f"({b}, {hkv}, {s5}, 128) {dtype}, {n5} tiles, plain mode: kernel "
            f"{ms:.4f} ms a call back to back ({device_ms:.4f} ms device, "
            f"graph replay)  plain {plain_ms:.3f} ms  bound {bound:.4f} ms "
            f"({by}); err {err:.2e} (scale {scale:.2f})")
        b5.append({"config": what, "B": b, "hkv": hkv, "g": g, "dh": 128,
                   "S": s5, "n_sel": n5,
                   "max_abs_err": err, "ms": ms, "device_ms": device_ms,
                   "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by})
        del q, k, v, pos, cent
    return b6, b5


# ---------------------------------------------------------------------------
# the rest of the model zoo at full width (phase 17)
# ---------------------------------------------------------------------------

# zamba2-1.2b's run: prompt and prompt + gen are whole 128-tiles, so its
# prefill launches B6 and every decode step B5 (a cache length off the
# tiles takes dense decode)
ZAMBA_PROMPT, ZAMBA_GEN = 3968, 128
# the three configurations of phase 17, each served through the
# ``launch.serve`` twin's one-shot loop at full width and depth: (arch,
# attention backend, batch, prompt, generated tokens). whisper-medium's
# frames and tokens are both 448, Whisper's decoder context, as the
# reference's launcher ties them
ZOO_B = (("falcon-mamba-7b", "flash", 4, 2048, 32),
         ("zamba2-1.2b", "clusterkv", 4, ZAMBA_PROMPT, ZAMBA_GEN),
         ("whisper-medium", "flash", 4, 448, 32))
# layers (full width) of the float32 teacher-forcing checks
TF_LAYERS = 4
# the float32 chunked scan against the float64 step recurrence: float32
# sums over a state that forgets geometrically (decay <= 1) stay within a
# few float32 spacings of the largest output; a wrong combine, chunk carry
# or padded position is off by the whole of a term
SCAN_TOL = 1e-4


def zoo_b_teacher_forcing(args, dev, cfg, params, rehearse):
    """float32, ``TF_LAYERS`` layers at full width (the encoder too for an
    encdec model), the reference's ``tests/test_models.py`` check on the
    card: the last logits of ``prefill(S)`` equal ``prefill(S - 1)`` then
    one ``decode_step`` of the last token (1e-3 x scale). For the SSM LM,
    S = 600 spans three scan chunks, the last one padded: the chunked scan
    against the step recurrence. Whisper keeps its 448 frames whole."""
    from repro_torch.models import model_api

    mod = model_api.module_for(cfg)
    encdec = cfg.family == "encdec"
    cut = {"dtype": "float32"}
    if not rehearse:
        cut["n_layers"] = TF_LAYERS
        if encdec:
            cut["n_enc_layers"] = TF_LAYERS
    cfg4 = cfg.with_(**cut)
    s = 32 if rehearse else (448 if encdec else 600)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 172)
    batch = model_api.make_small_batch(cfg4, gen, 2, s, kind="prefill",
                                       device=dev)
    _, full = mod.prefill(params, cfg4, batch, "flash")
    short = dict(batch, tokens=batch["tokens"][:, :s - 1])
    cache, _ = mod.prefill(params, cfg4, short, "flash")
    cache = model_api.grow_cache(cfg4, cache, s)
    lg, _ = mod.decode_step(params, cfg4, cache, batch["tokens"][:, s - 1:],
                            "flash")
    err, scale = check_close(f"{cfg.name} teacher forcing", lg, full,
                             rel_tol=SERVE_TOL)
    say(f"  float32 teacher forcing, {cfg4.n_layers} layers at full width, "
        f"batch 2, S = {s}: prefill(S) vs prefill(S - 1) + one step, "
        f"max-abs {err:.2e} (scale {scale:.2f}, tolerance {SERVE_TOL:g} x "
        f"scale)")
    return {"layers": cfg4.n_layers, "S": s, "max_abs_err": err,
            "scale": scale, "tolerance": SERVE_TOL}


def mamba1_scan_check(args, dev, cfg, params, rehearse):
    """Layer 0 of the SSM LM at full width on 2048 seeded tokens: the
    scan's inputs formed as ``mamba1_forward`` forms them (float32), then
    ``selective_scan`` against the step recurrence in float64 (outputs and
    final state within ``SCAN_TOL`` x scale)."""
    import torch.nn.functional as F
    from repro_torch.models import mamba
    from repro_torch.models import param as pm

    lp = pm.layer(params["layers"], 0)["mixer"]
    s = 64 if rehearse else 2048
    di, dt_rank, n = mamba._dims(cfg)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 173)
    x = torch.randn((1, s, cfg.d_model), generator=gen, device=dev)
    xin = pm.apply_linear(lp["in_proj"], x)[..., :di]
    xc = F.silu(mamba.conv1d_apply(lp["conv"], xin))
    proj = pm.apply_linear(lp["x_proj"], xc)
    dt = F.softplus(pm.apply_linear(lp["dt_proj"], proj[..., :dt_rank]))
    bc, cc = proj[..., dt_rank:dt_rank + n], proj[..., dt_rank + n:]
    a_mat = -torch.exp(lp["A_log"]).float()
    y, h = mamba.selective_scan(xc, dt, a_mat, bc, cc, cfg.ssm.chunk)
    xc64, dt64, a64, bc64, cc64 = (t.double() for t in (xc, dt, a_mat, bc,
                                                         cc))
    h64 = torch.zeros((1, di, n), dtype=torch.float64, device=dev)
    y64 = torch.empty((1, s, di), dtype=torch.float64, device=dev)
    for t in range(s):
        h64 = torch.exp(dt64[:, t, :, None] * a64) * h64 \
            + dt64[:, t, :, None] * bc64[:, t, None, :] * xc64[:, t, :, None]
        y64[:, t] = torch.einsum("bdn,bn->bd", h64, cc64[:, t])
    err_y, scale_y = check_close(f"{cfg.name} selective_scan y", y.double(),
                                 y64, rel_tol=SCAN_TOL)
    err_h, scale_h = check_close(f"{cfg.name} selective_scan state",
                                 h.double(), h64, rel_tol=SCAN_TOL)
    say(f"  selective_scan, layer 0, d_inner {di}, d_state {n}, S {s}, "
        f"chunk {cfg.ssm.chunk}: against the float64 recurrence y max-abs "
        f"{err_y:.2e} (scale {scale_y:.2f}), final state {err_h:.2e} "
        f"(scale {scale_h:.2f}), tolerance {SCAN_TOL:g} x scale")
    return {"S": s, "d_inner": di, "d_state": n, "y_max_abs_err": err_y,
            "y_scale": scale_y, "h_max_abs_err": err_h, "h_scale": scale_h,
            "tolerance": SCAN_TOL}


def phase_zoo_b(args, dev, sync, rehearse, reset_counts, collect_counts,
                card: str):
    """Phase 17: falcon-mamba-7b, zamba2-1.2b and whisper-medium at full
    width and depth, each served through ``launch.serve.generate`` (one
    prefill, the cache grown, greedy decode steps) and freed before the
    next; then each family's float32 check. Each run's times are printed
    beside ``card``, the card's name and power limit."""
    from repro_torch.launch import serve
    from repro_torch.models import hybrid, model_api
    from repro_torch.models import param as pm

    t_phase = time.perf_counter()
    say("== phase 17: the rest of the model zoo (ssm, hybrid, encdec) at "
        "full width through launch.serve.generate")
    out = {}
    for arch, backend, b, plen, n_gen in ZOO_B:
        cfg, cuts = zoo_config(arch, None, rehearse)
        if rehearse:
            b, n_gen = 2, (32 if cfg.family == "hybrid" else 4)
            plen = {"ssm": 40, "hybrid": 96, "encdec": 32}[cfg.family]
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        gen_w = torch.Generator(device=dev).manual_seed(args.seed)
        t0 = time.perf_counter()
        params = model_api.init(cfg, gen_w, device=dev)
        sync()
        init_s = time.perf_counter() - t0
        nbytes = tree_bytes(params)
        n_params = sum(t.numel() for t in pm.tree_leaves(params))
        if cfg.family == "ssm":
            shape = (f"{cfg.n_layers} mamba1 layers, d_model {cfg.d_model}, "
                     f"d_inner {cfg.ssm.expand * cfg.d_model}, d_state "
                     f"{cfg.ssm.d_state}")
        elif cfg.family == "hybrid":
            groups = hybrid._n_groups(cfg)
            shape = (f"{groups * cfg.shared_attn_every} mamba2 layers "
                     f"({groups} groups of {cfg.shared_attn_every}; the "
                     f"config's n_layers {cfg.n_layers}), d_model "
                     f"{cfg.d_model}, a shared block of {cfg.n_heads}/"
                     f"{cfg.n_heads} heads of {2 * cfg.d_model // cfg.n_heads}"
                     f", ClusterKV on")
        else:
            shape = (f"{cfg.n_enc_layers} encoder + {cfg.n_layers} decoder "
                     f"layers, d_model {cfg.d_model}, {cfg.n_heads} heads of "
                     f"{cfg.head_dim}")
        say(f" -- {cfg.name} [{cfg.family}]: {shape}, vocab {cfg.vocab}; "
            f"{n_params / 1e9:.3f} B parameters, {cfg.param_dtype} weights "
            f"{nbytes / 1e9:.2f} GB from seed {args.seed} in {init_s:.2f} s; "
            + (f"cut: {'; '.join(cuts)}" if rehearse else "nothing cut"))
        batch = model_api.make_small_batch(cfg, gen_w, b, plen,
                                           kind="prefill", device=dev)
        sync()
        reset_counts()
        timings = {}
        t0 = time.perf_counter()
        toks = serve.generate(cfg, params, batch, n_gen, backend,
                              timings=timings)
        sync()
        wall = time.perf_counter() - t0
        launches = collect_counts(f"{cfg.name} generate")
        if tuple(toks.shape) != (b, n_gen) or int(toks.min()) < 0 or \
                int(toks.max()) >= cfg.vocab:
            raise AssertionError(f"{cfg.name}: generated tokens of shape "
                                 f"{tuple(toks.shape)} out of the vocab")
        groups = hybrid._n_groups(cfg) if cfg.family == "hybrid" else 0
        want6, want5 = groups, groups * (n_gen - 1)
        if not rehearse and (
                launches["block_attention"] != want6
                or launches["decode_attend_fused.plain_mode"] != want5
                or launches["decode_attend_fused"] != want5):
            raise AssertionError(f"{cfg.name}: one prefill and {n_gen - 1} "
                                 f"steps launched {launches}")
        prefill_ms = timings["prefill_s"] * 1e3
        step_ms = [t * 1e3 for t in timings["step_s"]]
        decode_s = sum(timings["step_s"])
        say(f"  batch {b}, prompt {plen}, {n_gen} tokens, backend "
            f"{backend}: prefill {prefill_ms:.1f} ms; decode step median "
            f"{float(np.median(step_ms)):.2f} ms ({min(step_ms):.2f}-"
            f"{max(step_ms):.2f}); {b * n_gen / wall:.1f} tokens/s over the "
            f"run, {b * (n_gen - 1) / decode_s:.1f} decode tokens/s; B6 "
            f"{launches['block_attention']}, B5 "
            f"{launches['decode_attend_fused']} launches; {card}")
        row = {"family": cfg.family, "backend": backend, "batch": b,
               "prompt": plen, "gen": n_gen, "params": n_params,
               "weight_bytes": nbytes, "init_s": init_s,
               "prefill_ms": prefill_ms, "step_ms": step_ms,
               "step_ms_median": float(np.median(step_ms)),
               "tokens_per_s": b * n_gen / wall,
               "decode_tokens_per_s": b * (n_gen - 1) / decode_s,
               "launches": launches}
        if cfg.family == "hybrid":
            row["float32_check"] = zoo_flash_check(args, dev, sync, cfg,
                                                   params, rehearse)
        else:
            row["teacher_forcing"] = zoo_b_teacher_forcing(
                args, dev, cfg, params, rehearse)
        if cfg.family == "ssm":
            row["scan_check"] = mamba1_scan_check(args, dev, cfg, params,
                                                  rehearse)
        collect_counts(f"{cfg.name} float32 checks")
        out[arch] = row
        del params, batch, toks
        sync()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t_phase
    say(f"  phase 17 wall time: {out['wall_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# single-card training (phase 18)
# ---------------------------------------------------------------------------

# the headline run: Qwen2-0.5B at full width and depth, train_4k's sequence
# length, the global batch of 256 cut to 16 (2 microbatches of 8) for the
# run's time limit, 6 AdamW steps on one fixed batch
TRAIN_STEPS, TRAIN_BATCH, TRAIN_MICRO, TRAIN_SEQ = 6, 16, 2, 4096
# the trained weights served: one prompt of train_4k's length, the cache
# grown by one 128-tile so every step attends through B5, 8 scalar steps
TRAIN_SERVE_GEN = 8
# the reference's bounds (tests/test_optim_trainer.py): microbatch
# accumulation against the full batch (loss rel 1e-4, params max-abs
# 5e-3) and bf16-compressed accumulation against exact (rel 0.05)
MICRO_LOSS_RTOL, MICRO_PARAM_ATOL, COMPRESS_RTOL = 1e-4, 5e-3, 0.05
# the float32 scan's gradients against float64 autograd of the step
# recurrence (as SCAN_TOL for its values)
SCAN_GRAD_TOL = 1e-4
# one step each of the rest of the families at full width and cut depth:
# (arch, {field: cut})
TRAIN_FAMILIES = (("falcon-mamba-7b", {"n_layers": 2}),
                  ("zamba2-1.2b", {"n_layers": 6}),
                  ("whisper-medium", {"n_layers": 2, "n_enc_layers": 2}),
                  ("granite-moe-3b-a800m", {"n_layers": 2}),
                  ("minicpm3-4b", {"n_layers": 2}),
                  ("mistral-large-123b", {"n_layers": 1}))
FAMILY_BATCH, FAMILY_SEQ = 2, 1024


def timed_steps(step, params, state, batch, n, sync):
    """``n`` train steps on ``batch``: (losses, grad norms, ms each on the
    host clock to the step's metrics read, which waits for the card)."""
    losses, norms, ms = [], [], []
    for _ in range(n):
        sync()
        t0 = time.perf_counter()
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        ms.append((time.perf_counter() - t0) * 1e3)
    return losses, norms, ms


def train_qwen(args, dev, sync, rehearse, reset_counts, collect_counts,
               card):
    """The headline: Qwen2-0.5B trained, then served from its weights."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.data import pipeline
    from repro_torch.launch import analytic
    from repro_torch.models import model_api
    from repro_torch.models import param as pm
    from repro_torch.optim.optimizers import make_optimizer
    from repro_torch.train import trainer

    if rehearse:
        cfg = reduced_config("qwen2-0.5b").with_(remat=True, loss_chunk=64)
        b, s = 4, 64
    else:
        cfg = get_config("qwen2-0.5b")
        b, s = TRAIN_BATCH, TRAIN_SEQ
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    params = model_api.init(cfg, torch.Generator(device=dev).manual_seed(
        args.seed), device=dev)
    # the launcher's schedule for a run of TRAIN_STEPS steps
    opt = make_optimizer(cfg.optimizer, warmup=max(TRAIN_STEPS // 20, 1),
                         total=TRAIN_STEPS)
    step, _ = trainer.make_train_step(cfg, None, "flash",
                                      microbatch=TRAIN_MICRO, optimizer=opt)
    state = opt.init(params)
    batch = pipeline.to_device(pipeline.token_batch(cfg, 0, b, s, args.seed),
                               dev)
    say(f" -- {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"vocab {cfg.vocab}, tied head; {pm.count_params(params) / 1e6:.1f} M "
        f"{cfg.param_dtype} masters from seed {args.seed}, {cfg.dtype} "
        f"compute, remat {cfg.remat} ({cfg.remat_policy}), loss_chunk "
        f"{cfg.loss_chunk}, {cfg.optimizer}; batch {b} x {s} in "
        f"{TRAIN_MICRO} microbatches, one fixed batch; cut: global batch "
        f"256 -> {b}")
    sync()
    reset_counts()
    losses, norms, ms = timed_steps(step, params, state, batch, TRAIN_STEPS,
                                    sync)
    launches = collect_counts(f"{cfg.name} training")
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    for i, (l, g, t) in enumerate(zip(losses, norms, ms)):
        say(f"  step {i + 1}: loss {l:.6f}  grad norm {g:.4f}  {t:.1f} ms")
    if not all(map(math.isfinite, losses + norms)):
        raise AssertionError(f"non-finite training metrics: {losses} {norms}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{TRAIN_STEPS - 1} steps on one batch did not "
                             f"lower its loss: {losses}")
    if any(launches[k] for k in launches):
        raise AssertionError(f"training launched kernels: {launches}")
    step_ms = float(np.median(ms[1:]))
    tokens = b * s
    # the analytic model's step at train_4k (global batch 256), scaled to
    # this batch (every term is linear in the batch)
    cm = analytic.cell_model("qwen2-0.5b", "train_4k")
    flops = cm.flops * b / analytic.SHAPES["train_4k"][1]
    model_flops = cm.model_flops * b / analytic.SHAPES["train_4k"][1]
    share = flops / (step_ms * 1e-3 * BF16_FLOP_PER_S)
    say(f"  step ms (median of steps 2-{TRAIN_STEPS}) {step_ms:.1f}; "
        f"{tokens / (step_ms * 1e-3):.0f} tokens/s; peak memory "
        f"{peak / 2 ** 30:.2f} GiB; analytic model {flops:.3e} FLOPs a step "
        f"(model FLOPs {model_flops:.3e}), {100 * share:.2f} % of "
        f"{BF16_FLOP_PER_S / 1e12:g} TFLOP/s bf16; {card}")
    out = {"arch": cfg.name, "batch": b, "seq": s, "microbatch": TRAIN_MICRO,
           "losses": losses, "grad_norms": norms, "step_ms": ms,
           "step_ms_median": step_ms, "tokens_per_s": tokens / (step_ms
                                                                * 1e-3),
           "peak_bytes": peak, "analytic_flops": flops,
           "analytic_model_flops": model_flops, "bf16_peak_share": share,
           "launches_training": launches,
           "cuts": [f"global batch 256 -> {b}"]}

    # serve the trained weights: B6 once a layer in the prefill, B5 once a
    # layer a step
    prompt = {"tokens": batch["tokens"][:1]}
    pre = trainer.make_prefill_step(cfg, backend="clusterkv")
    dec = trainer.make_decode_step(cfg, backend="clusterkv")
    bk = cfg.clusterkv.block_k if not rehearse else 16
    sync()
    reset_counts()
    t0 = time.perf_counter()
    with torch.no_grad():
        cache, logits = pre(params, prompt)
        cache = model_api.grow_cache(cfg, cache, s + max(bk, TRAIN_SERVE_GEN))
        toks = [logits.argmax(-1)]
        for _ in range(TRAIN_SERVE_GEN):
            logits, cache = dec(params, cache, {"tokens": toks[-1][:, None]})
            toks.append(logits.argmax(-1))
    sync()
    serve_s = time.perf_counter() - t0
    served = collect_counts(f"{cfg.name} serving its trained weights")
    toks = torch.stack(toks, 1)
    if not torch.isfinite(logits).all() or int(toks.min()) < 0 or \
            int(toks.max()) >= cfg.vocab:
        raise AssertionError("the trained weights served non-finite logits "
                             "or tokens outside the vocab")
    if not rehearse and (
            served["block_attention"] != cfg.n_layers
            or served["decode_attend_fused"] != cfg.n_layers
            * TRAIN_SERVE_GEN):
        raise AssertionError(f"serving the trained weights launched "
                             f"{served}")
    say(f"  served: one {s}-token prompt + {TRAIN_SERVE_GEN} scalar steps "
        f"through ClusterKV in {serve_s:.2f} s; B6 "
        f"{served['block_attention']}, B5 {served['decode_attend_fused']} "
        f"launches")
    out.update(serve_s=serve_s, launches_serving=served,
               served_tokens=toks[0].tolist())
    del params, state, batch, cache, opt, step
    return out


class RecordingOptimizer:
    """An optimizer that keeps a copy of the gradients it is handed (the
    accumulated ones of a microbatched step) and then updates as ``opt``."""

    def __init__(self, opt):
        self.opt, self.grads = opt, None

    def init(self, params):
        return self.opt.init(params)

    def update(self, grads, state, params):
        from repro_torch.models import param as pm
        self.grads = pm.tree_map(lambda g: g.detach().clone(), grads)
        return self.opt.update(grads, state, params)


def train_accumulation_checks(args, dev, sync, rehearse):
    """float32, 2 layers of Qwen2-0.5B at full width, one AdamW step each
    from the same weights: ``microbatch=2`` against ``microbatch=1`` within
    the reference's bounds (loss rel 1e-4, parameters max-abs 5e-3), and
    ``compress_grads`` against exact accumulation within the reference's
    relative bound (0.05) on the accumulated gradients it perturbs. The
    reference's form of that bound, on the updated parameters, is printed
    beside it: a zero-initialised leaf (the q/k/v biases) moves by
    ``lr x sign(g)`` in AdamW's first step, so a near-zero gradient element
    whose sign the bf16 rounding flips moves it by 2 lr, the leaf's whole
    size."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.data import pipeline
    from repro_torch.models import model_api
    from repro_torch.models import param as pm
    from repro_torch.optim.optimizers import make_optimizer
    from repro_torch.train import trainer

    cfg = (reduced_config("qwen2-0.5b") if rehearse
           else get_config("qwen2-0.5b").with_(n_layers=2))
    cfg = cfg.with_(dtype="float32")
    params = model_api.init(cfg, torch.Generator(device=dev).manual_seed(
        args.seed + 181), device=dev)
    batch = pipeline.to_device(pipeline.token_batch(cfg, 0, 8, 256,
                                                    args.seed), dev)
    outs = {}
    for key, kw in (("full", {}), ("micro", {"microbatch": 2}),
                    ("comp", {"microbatch": 2, "compress_grads": True})):
        opt = RecordingOptimizer(make_optimizer("adamw"))
        step, _ = trainer.make_train_step(cfg, None, "flash", optimizer=opt,
                                          **kw)
        p = pm.tree_map(lambda t: t.clone(), params)
        _, _, m = step(p, opt.init(p), batch)
        outs[key] = (pm.tree_leaves(p), m, pm.tree_leaves(opt.grads))
    sync()
    (p1, m1, _), (p2, m2, g2), (p3, _, g3) = (outs["full"], outs["micro"],
                                              outs["comp"])
    loss_rel = abs(float(m1["loss"]) - float(m2["loss"])) / \
        abs(float(m1["loss"]))
    p_err = max(float((a - c).abs().max()) for a, c in zip(p1, p2))
    g_rel = max(float((a - c).abs().max() / (a.abs().max() + 1e-9))
                for a, c in zip(g2, g3))
    p_rel = max(float((a - c).abs().max() / (a.abs().max() + 1e-9))
                for a, c in zip(p2, p3))
    flips = sum(int((torch.sign(a - p0) != torch.sign(c - p0)).sum())
                for a, c, p0 in zip(p2, p3, pm.tree_leaves(params)))
    if not (loss_rel < MICRO_LOSS_RTOL and p_err < MICRO_PARAM_ATOL
            and g_rel < COMPRESS_RTOL):
        raise AssertionError(f"accumulation checks: loss rel {loss_rel:.2e}, "
                             f"params {p_err:.2e}, compressed gradients rel "
                             f"{g_rel:.2e}")
    say(f"  float32, {cfg.n_layers} layers at full width, batch 8 x 256: "
        f"microbatch 2 vs 1 loss rel {loss_rel:.2e} (limit "
        f"{MICRO_LOSS_RTOL:g}), params max-abs {p_err:.2e} (limit "
        f"{MICRO_PARAM_ATOL:g}); compress_grads vs exact: accumulated "
        f"gradients rel {g_rel:.2e} (limit {COMPRESS_RTOL:g}); updated "
        f"params rel {p_rel:.2e}, {flips} elements moved the other way")
    return {"layers": cfg.n_layers, "microbatch_loss_rel": loss_rel,
            "microbatch_param_max_abs": p_err, "compressed_grad_rel": g_rel,
            "compressed_param_rel": p_rel, "compressed_sign_flips": flips}


def scan_gradient_check(args, dev, rehearse):
    """The mamba1 scan's gradients at falcon-mamba-7b's width (d_inner
    8192, d_state 16, S 512, batch 1; float32, chunks of 256) against
    float64 autograd of the step recurrence, for a random linear objective
    of the outputs and the final state."""
    from repro_torch.models import mamba

    di, n, s = (64, 16, 64) if rehearse else (8192, 16, 512)
    chunk = 16 if rehearse else 256
    g = torch.Generator(device=dev).manual_seed(args.seed + 182)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev)
    xc, bc, cc = rnd(1, s, di), rnd(1, s, n), rnd(1, s, n)
    dt = torch.nn.functional.softplus(rnd(1, s, di) - 2.0)
    a_mat = -torch.arange(1, n + 1, dtype=torch.float32,
                          device=dev).expand(di, n).contiguous()
    wy, wh = rnd(1, s, di), rnd(1, di, n)
    ins = [t.clone().requires_grad_() for t in (xc, dt, a_mat, bc, cc)]
    y, h = mamba.selective_scan(*ins, chunk)
    got = torch.autograd.grad((y * wy).sum() + (h * wh).sum(), ins)
    ins64 = [t.double().requires_grad_() for t in (xc, dt, a_mat, bc, cc)]
    x64, dt64, a64, b64, c64 = ins64
    h64 = torch.zeros((1, di, n), dtype=torch.float64, device=dev)
    obj = torch.zeros((), dtype=torch.float64, device=dev)
    for t in range(s):
        h64 = torch.exp(dt64[:, t, :, None] * a64) * h64 \
            + dt64[:, t, :, None] * b64[:, t, None, :] * x64[:, t, :, None]
        obj = obj + (torch.einsum("bdn,bn->bd", h64, c64[:, t])
                     * wy[:, t].double()).sum()
    obj = obj + (h64 * wh.double()).sum()
    want = torch.autograd.grad(obj, ins64)
    errs = {}
    for name, a, w in zip(("x", "dt", "A", "B", "C"), got, want):
        errs[name] = check_close(f"selective_scan grad {name}", a.double(),
                                 w, rel_tol=SCAN_GRAD_TOL)
    say(f"  selective_scan backward, d_inner {di}, d_state {n}, S {s}, "
        f"chunk {chunk}: against float64 autograd of the recurrence "
        + ", ".join(f"d{k} {e:.2e} (scale {sc:.2e})"
                    for k, (e, sc) in errs.items())
        + f"; tolerance {SCAN_GRAD_TOL:g} x scale")
    return {"S": s, "d_inner": di, "d_state": n,
            "grads": {k: {"max_abs_err": e, "scale": sc}
                      for k, (e, sc) in errs.items()},
            "tolerance": SCAN_GRAD_TOL}


def train_families(args, dev, sync, rehearse, card):
    """One train step of each other family at full width and cut depth."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.data import pipeline
    from repro_torch.models import model_api
    from repro_torch.models import param as pm
    from repro_torch.optim.optimizers import make_optimizer
    from repro_torch.train import trainer

    out = {}
    for arch, cut in TRAIN_FAMILIES:
        if rehearse:
            cfg, cuts, b, s = reduced_config(arch), ["reduced config"], 2, 32
        else:
            full = get_config(arch)
            cfg, b, s = full.with_(**cut), FAMILY_BATCH, FAMILY_SEQ
            cuts = [f"{k} {v} of {getattr(full, k)}" for k, v in cut.items()]
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        params = model_api.init(cfg, torch.Generator(device=dev).manual_seed(
            args.seed), device=dev)
        opt = make_optimizer(cfg.optimizer, warmup=1, total=1)
        step, _ = trainer.make_train_step(cfg, None, "flash", optimizer=opt)
        batch = pipeline.to_device(pipeline.token_batch(cfg, 0, b, s,
                                                        args.seed), dev)
        losses, norms, ms = timed_steps(step, params, opt.init(params),
                                        batch, 1, sync)
        if not (math.isfinite(losses[0]) and math.isfinite(norms[0])):
            raise AssertionError(f"{cfg.name}: loss {losses[0]}, grad norm "
                                 f"{norms[0]}")
        peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
        kind = cfg.family + (", MoE aux loss" if cfg.moe else "") + \
            (", MLA" if cfg.mla else "")
        say(f"  {cfg.name} [{kind}]: {pm.count_params(params) / 1e9:.3f} B "
            f"{cfg.param_dtype} params, {cfg.optimizer}, batch {b} x {s}: "
            f"loss {losses[0]:.4f}, grad norm {norms[0]:.4f}, one step "
            f"{ms[0]:.1f} ms, peak {peak / 2 ** 30:.2f} GiB; cut: "
            f"{'; '.join(cuts)}; {card}")
        out[arch] = {"family": cfg.family, "params": pm.count_params(params),
                     "param_dtype": cfg.param_dtype,
                     "optimizer": cfg.optimizer, "batch": b, "seq": s,
                     "loss": losses[0], "grad_norm": norms[0],
                     "step_ms": ms[0], "peak_bytes": peak, "cuts": cuts}
        del params, batch, step, opt
        sync()
    return out


def c40_still_raises(args, dev, rehearse):
    """C40 on the card for B1-B5: a kernel without a backward raises under
    grad where it would launch (B5's wrapper, one decode step's shape);
    B6 differentiates (the ClusterKV runs of this phase)."""
    from repro_torch.kernels import decode_attend as k_da
    from repro_torch.kernels import ops

    if rehearse:
        say("  C40: B1-B5 raise under grad on the card only (the CPU takes "
            "their plain versions)")
        return None
    gen = torch.Generator(device=dev).manual_seed(args.seed + 183)
    q, k, v, pos, cent = decode_inputs(gen, 1, 2, 7, 1024, 64, 128,
                                       torch.bfloat16, dev, holes=0.0)
    qp = torch.tensor([1023], dtype=torch.int32, device=dev)
    try:
        with uncounted(k_da.decode_attend_fused):
            ops.decode_attend_fused(q.requires_grad_(), k, v, pos, cent, qp,
                                    n_sel=4, bk=128)
    except NotImplementedError as e:
        if "C40" not in str(e):
            raise
        say(f"  C40 still holds for B1-B5: {str(e)[:96]}...")
        return str(e)
    raise AssertionError("B5's wrapper under grad on the card did not raise "
                         "C40's error")


# the ClusterKV step with B6's kernels against the same step with B6's
# plain forward and backward on the card (2 layers of Qwen2-0.5B at full
# width, bf16 compute): the kernel and the plain version round their
# bf16 outputs one bf16 spacing (2^-8) apart at most, which a bf16 model
# carries into the loss as an average over the tokens and into the
# gradient norm through two layers' bf16 products
CKV_PLAIN_LOSS_RTOL, CKV_PLAIN_GNORM_RTOL = 1e-3, 1e-2
# ... and each attention projection's gradient in each layer (wq, wk, wv
# with their biases, wo), ||kernel - yardstick|| / ||yardstick||, where
# the yardstick step runs B6's forward kernel and its plain backward: the
# same forward, so every tile selection is the same and only the
# backward differs. The limit sits between that step's reading and those
# of the kernel step with a fault planted in B6's backward (CKV_FAULTS),
# each of which it must catch: on an H100 the sound step reads 5.82e-3 at
# most (wk's bias in layer 0; its gradient nearly cancels, as dK sums to 0
# over each row's keys before RoPE), dk 1/16 too large 6.39e-2, near their
# geometric mean. Against the fully plain step the leaves read up to 0.33:
# layer 0's output rounds another way there and layer 1 selects other tiles
CKV_LEAF_RTOL = 2e-2
CKV_LEAVES = ("wq/w", "wq/b", "wk/w", "wk/b", "wv/w", "wv/b", "wo/w")
# faults planted in the (dq, dk, dv) that B6's kernels hand autograd: one
# gradient zeroed, and dk 1/16 too large (a wrong scale)
CKV_FAULTS = (("dq zeroed", lambda dq, dk, dv: (dq * 0, dk, dv)),
              ("dk zeroed", lambda dq, dk, dv: (dq, dk * 0, dv)),
              ("dv zeroed", lambda dq, dk, dv: (dq, dk, dv * 0)),
              ("dk x 17/16", lambda dq, dk, dv: (dq, dk * 1.0625, dv)))
# B6's backward against its plain version: float32 sums in another order;
# dS = p o (dP - D) subtracts two sums of dv products whose rounding does
# not shrink with dS (tests/test_torch_cuda.py, B6_BWD_REL), plus one bf16
# spacing of each element
B6_BWD_REL_TOL = 1e-4
# the layer shapes B6's backward is timed at: Qwen2-0.5B's training
# microbatch (8 x 4096 tokens), one llava-next-34b and one minicpm3-4b
# prefill layer (as phase 16's forward); 16 of 32 tiles of 128
B6_BWD_SHAPES = (("qwen2-0.5b", 8, 14, 2, 64, 64),
                 ("llava-next-34b", 1, 56, 8, 128, 128),
                 ("minicpm3-4b", 1, 40, 40, 96, 64))
# one ClusterKV step of these at full width and cut depth (phase 18's
# families cut, FAMILY_BATCH x FAMILY_SEQ tokens)
CKV_FAMILIES = ("granite-moe-3b-a800m", "minicpm3-4b")


def train_qwen_clusterkv(args, dev, sync, rehearse, reset_counts,
                         collect_counts, card, flash: dict):
    """Qwen2-0.5B trained through ClusterKV at full width and depth: the
    flash run's batch, steps, microbatches, remat and schedule with
    ``--backend clusterkv``. B6's forward runs twice a layer a microbatch
    (the first pass and remat's recompute), its backward (key-tile
    lists, dQ, dK/dV) once; step ms, tokens/s and peak beside the flash
    run's."""
    from repro_torch.configs import get_config
    from repro_torch.data import pipeline
    from repro_torch.models import model_api
    from repro_torch.optim.optimizers import make_optimizer
    from repro_torch.train import trainer

    if rehearse:
        cfg = qwen_config(True).with_(remat=True, loss_chunk=64)
        b, s = 4, 64
    else:
        cfg = get_config("qwen2-0.5b")
        b, s = TRAIN_BATCH, TRAIN_SEQ
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    params = model_api.init(cfg, torch.Generator(device=dev).manual_seed(
        args.seed), device=dev)
    opt = make_optimizer(cfg.optimizer, warmup=max(TRAIN_STEPS // 20, 1),
                         total=TRAIN_STEPS)
    step, _ = trainer.make_train_step(cfg, None, "clusterkv",
                                      microbatch=TRAIN_MICRO, optimizer=opt)
    state = opt.init(params)
    batch = pipeline.to_device(pipeline.token_batch(cfg, 0, b, s, args.seed),
                               dev)
    ckv = cfg.clusterkv
    nkb = s // ckv.block_k
    say(f" -- {cfg.name} through ClusterKV (tiles {ckv.block_q}, "
        f"{min(ckv.blocks_per_query, nkb)} of {nkb} key tiles a query "
        f"tile): the flash run's weights, batch {b} x {s} in {TRAIN_MICRO} "
        f"microbatches, remat {cfg.remat}, {cfg.dtype} compute")
    sync()
    reset_counts()
    losses, norms, ms = timed_steps(step, params, state, batch, TRAIN_STEPS,
                                    sync)
    launches = collect_counts(f"{cfg.name} ClusterKV training")
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    for i, (l, g, t) in enumerate(zip(losses, norms, ms)):
        say(f"  step {i + 1}: loss {l:.6f}  grad norm {g:.4f}  {t:.1f} ms")
    if not all(map(math.isfinite, losses + norms)):
        raise AssertionError(f"non-finite ClusterKV training metrics: "
                             f"{losses} {norms}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{TRAIN_STEPS - 1} ClusterKV steps on one "
                             f"batch did not lower its loss: {losses}")
    per = cfg.n_layers * TRAIN_MICRO * TRAIN_STEPS
    want = {"block_attention": 2 * per, "key_tile_lists": per,
            "key_tile_order": per, "block_attention_backward": per}
    if not rehearse and any(launches[k] != n for k, n in want.items()):
        raise AssertionError(f"ClusterKV training launched {launches}, "
                             f"expected {want}")
    step_ms = float(np.median(ms[1:]))
    tokens = b * s
    say(f"  ClusterKV step ms (median of steps 2-{TRAIN_STEPS}) "
        f"{step_ms:.1f}; {tokens / (step_ms * 1e-3):.0f} tokens/s; peak "
        f"{peak / 2 ** 30:.2f} GiB; the flash run in the same call: "
        f"{flash['step_ms_median']:.1f} ms, {flash['tokens_per_s']:.0f} "
        f"tokens/s, {flash['peak_bytes'] / 2 ** 30:.2f} GiB; launches B6 "
        f"{launches['block_attention']}, lists "
        f"{launches['key_tile_lists']}, order "
        f"{launches['key_tile_order']}, backward "
        f"{launches['block_attention_backward']}; {card}")
    out = {"arch": cfg.name, "batch": b, "seq": s, "microbatch": TRAIN_MICRO,
           "losses": losses, "grad_norms": norms, "step_ms": ms,
           "step_ms_median": step_ms,
           "tokens_per_s": tokens / (step_ms * 1e-3), "peak_bytes": peak,
           "launches_training": launches,
           "flash_step_ms_median": flash["step_ms_median"],
           "flash_tokens_per_s": flash["tokens_per_s"],
           "flash_peak_bytes": flash["peak_bytes"]}
    del params, state, batch, opt, step
    return out


def train_families_clusterkv(args, dev, sync, rehearse, reset_counts,
                             collect_counts, card):
    """One ClusterKV step each of granite-moe-3b-a800m (dh 64, MoE) and
    minicpm3-4b (MLA: B6 at q/k 96, v 64) at full width and phase 18's
    cut depth: finite, and B6's forward and backward launched."""
    from repro_torch.configs import ClusterKVConfig, get_config, \
        reduced_config
    from repro_torch.data import pipeline
    from repro_torch.models import model_api
    from repro_torch.optim.optimizers import make_optimizer
    from repro_torch.train import trainer

    cuts = dict(TRAIN_FAMILIES)
    out = {}
    for arch in CKV_FAMILIES:
        if rehearse:
            cfg = reduced_config(arch).with_(clusterkv=ClusterKVConfig(
                enabled=True, block_q=32, block_k=32))
            b, s = 2, 64
        else:
            cfg, b, s = get_config(arch).with_(**cuts[arch]), FAMILY_BATCH, \
                FAMILY_SEQ
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        params = model_api.init(cfg, torch.Generator(device=dev).manual_seed(
            args.seed), device=dev)
        opt = make_optimizer(cfg.optimizer, warmup=1, total=1)
        step, _ = trainer.make_train_step(cfg, None, "clusterkv",
                                          optimizer=opt)
        batch = pipeline.to_device(pipeline.token_batch(cfg, 0, b, s,
                                                        args.seed), dev)
        sync()
        reset_counts()
        losses, norms, ms = timed_steps(step, params, opt.init(params),
                                        batch, 1, sync)
        launches = collect_counts(f"{cfg.name} ClusterKV step")
        if not (math.isfinite(losses[0]) and math.isfinite(norms[0])):
            raise AssertionError(f"{cfg.name} ClusterKV step: loss "
                                 f"{losses[0]}, grad norm {norms[0]}")
        if not rehearse and not (launches["block_attention"] > 0 and
                                 launches["block_attention_backward"] > 0):
            raise AssertionError(f"{cfg.name}'s ClusterKV step launched "
                                 f"{launches}")
        say(f"  {cfg.name} through ClusterKV, {cfg.n_layers} layers at full "
            f"width, batch {b} x {s}: loss {losses[0]:.4f}, grad norm "
            f"{norms[0]:.4f}, {ms[0]:.1f} ms; B6 "
            f"{launches['block_attention']}, backward "
            f"{launches['block_attention_backward']}; {card}")
        out[arch] = {"layers": cfg.n_layers, "batch": b, "seq": s,
                     "loss": losses[0], "grad_norm": norms[0],
                     "step_ms": ms[0], "launches": launches}
        del params, batch, step, opt
        sync()
    return out


class PlainB6(torch.autograd.Function):
    """B6's plain forward and plain backward as one autograd function, on
    any device: the yardstick the kernels' ClusterKV step is held to on
    the card (never a path of the port)."""

    @staticmethod
    def forward(ctx, q, k, v, kpos, qpos, idx, bq, bk, causal):
        from repro_torch.core.clusterkv import sparse_block_attention
        out, m, l = sparse_block_attention(q, k, v, kpos, qpos, idx, bq, bk,
                                           causal=causal, stats=True)
        ctx.save_for_backward(q, k, v, kpos, qpos, idx, out,
                              torch.stack([m, l]))
        ctx.tiles = (bq, bk, causal)
        return out

    @staticmethod
    def backward(ctx, dout):
        from repro_torch.kernels import block_attention as k_ba
        q, k, v, kpos, qpos, idx, out, stats = ctx.saved_tensors
        bq, bk, causal = ctx.tiles
        grads = k_ba.block_attention_backward_plain(
            q, k, v, kpos, qpos, idx, out, stats,
            dout.to(out.dtype).contiguous(), bq=bq, bk=bk, causal=causal)
        return (*grads, None, None, None, None, None, None)


class KernelForwardPlainBackward(torch.autograd.Function):
    """B6's forward kernel, and its plain backward on that forward's output
    (the statistics recomputed by the plain forward): the yardstick the
    kernels' gradients are held to with every activation the same."""

    @staticmethod
    def forward(ctx, q, k, v, kpos, qpos, idx, bq, bk, causal):
        from repro_torch.kernels import block_attention as k_ba
        out = k_ba.block_attention(q, k, v, kpos, qpos, idx, bq=bq, bk=bk,
                                   causal=causal)
        ctx.save_for_backward(q, k, v, kpos, qpos, idx, out)
        ctx.tiles = (bq, bk, causal)
        return out

    @staticmethod
    def backward(ctx, dout):
        from repro_torch.kernels import block_attention as k_ba
        q, k, v, kpos, qpos, idx, out = ctx.saved_tensors
        bq, bk, causal = ctx.tiles
        grads = k_ba.block_attention_backward_plain(
            q, k, v, kpos, qpos, idx, out, None,
            dout.to(out.dtype).contiguous(), bq=bq, bk=bk, causal=causal)
        return (*grads, None, None, None, None, None, None)


class PlantedFault(torch.autograd.Function):
    """q, k and v unchanged on the way in; on the way back the gradients
    that B6's backward hands them go through ``fault``: a broken backward
    for :func:`ckv_step_against_plain` to catch."""

    @staticmethod
    def forward(ctx, q, k, v, fault):
        ctx.fault = fault
        return q.clone(), k.clone(), v.clone()

    @staticmethod
    def backward(ctx, dq, dk, dv):
        return (*ctx.fault(dq, dk, dv), None)


def ckv_step_against_plain(args, dev, sync, rehearse, card):
    """A ClusterKV step of Qwen2-0.5B at full width, 2 layers, bf16 compute,
    batch 2 x 4096, through B6's kernels against the same step, from the
    same weights, with ``ops.block_attention`` swapped for that step only:
    through B6's plain forward and backward (:class:`PlainB6`), loss and
    gradient norm within ``CKV_PLAIN_*``; through B6's forward kernel and
    plain backward (:class:`KernelForwardPlainBackward`), the gradient of
    each attention projection of each layer within ``CKV_LEAF_RTOL``. The
    kernel step with each fault of ``CKV_FAULTS`` planted in B6's backward
    must break that limit: the check's own power, read in the same run."""
    from repro_torch.configs import get_config
    from repro_torch.data import pipeline
    from repro_torch.kernels import block_attention as k_ba
    from repro_torch.kernels import ops
    from repro_torch.models import model_api
    from repro_torch.models import param as pm
    from repro_torch.optim.optimizers import make_optimizer
    from repro_torch.train import trainer

    if rehearse:
        cfg, b, s = qwen_config(True).with_(remat=True), 2, 64
    else:
        cfg, b, s = get_config("qwen2-0.5b").with_(n_layers=2), 2, TRAIN_SEQ
    params = model_api.init(cfg, torch.Generator(device=dev).manual_seed(
        args.seed + 184), device=dev)
    batch = pipeline.to_device(pipeline.token_batch(cfg, 0, b, s, args.seed),
                               dev)
    kernel_path = ops.block_attention

    def through(fn_cls):
        def path(q, k, v, kpos, qpos, idx, *, bq, bk, causal=True):
            return fn_cls.apply(q.contiguous(), k.contiguous(),
                                v.contiguous(), kpos.to(torch.int32),
                                qpos.to(torch.int32), idx.to(torch.int32),
                                bq, bk, causal)
        return path

    def faulty(fault):
        def path(q, k, v, *rest, **kw):
            return kernel_path(*PlantedFault.apply(q, k, v, fault), *rest,
                               **kw)
        return path

    def leaves(grads):
        attn = grads["layers"]["attn"]
        return {f"{name} layer {i}": attn[name.split("/")[0]][
            name.split("/")[1]][i].float() for name in CKV_LEAVES
            for i in range(cfg.n_layers)}

    counted = (k_ba.block_attention, k_ba.key_tile_lists,
               k_ba.key_tile_order, k_ba.block_attention_backward)
    runs, picks = {}, {}
    for name, fn in (("kernel", kernel_path), ("plain", through(PlainB6)),
                     ("plain backward", through(KernelForwardPlainBackward)),
                     *((f, faulty(fn_)) for f, fn_ in CKV_FAULTS)):
        opt = RecordingOptimizer(make_optimizer(cfg.optimizer, warmup=1,
                                                total=1))
        step, _ = trainer.make_train_step(cfg, None, "clusterkv",
                                          optimizer=opt)
        p = pm.tree_map(lambda t: t.clone(), params)
        n0 = k_ba.block_attention_backward.launches
        picks[name] = []

        def recorded(*a, _fn=fn, _into=picks[name], **kw):
            _into.append(a[5].clone())           # idx: the tiles selected
            return _fn(*a, **kw)
        ops.block_attention = recorded
        try:
            with uncounted(*counted):
                _, _, m = step(p, opt.init(p), batch)
                sync()
                n1 = k_ba.block_attention_backward.launches
        finally:
            ops.block_attention = kernel_path
        runs[name] = (float(m["loss"]), float(m["grad_norm"]), n1 - n0,
                      leaves(opt.grads))
        del p, step, opt
    (lk, gk, nk, ck), (lp, gp, npl, cp) = runs["kernel"], runs["plain"]
    loss_rel, gn_rel = abs(lk - lp) / abs(lp), abs(gk - gp) / abs(gp)
    yard, n_yard = runs["plain backward"][3], runs["plain backward"][2]

    def leaf_rel(c, w):
        return {n: float((c[n] - w[n]).norm() / w[n].norm()) for n in w}
    sound = leaf_rel(ck, yard)
    faults = {f: leaf_rel(runs[f][3], yard) for f, _ in CKV_FAULTS}
    worst = max(sound, key=sound.get)
    # for the record: the fully plain step's leaves, whose layer-1 tile
    # selection follows layer 0's output rounded another way
    loose = leaf_rel(ck, cp)
    moved = [float((a != w).float().mean())
             for a, w in zip(picks["kernel"], picks["plain"])]
    say(f"  {cfg.name} {cfg.n_layers} layers, batch {b} x {s}, one "
        f"ClusterKV step: through B6's kernels loss {lk:.6f}, grad norm "
        f"{gk:.5f}; through B6's plain forward and backward {lp:.6f}, "
        f"{gp:.5f}: loss rel {loss_rel:.2e} (limit {CKV_PLAIN_LOSS_RTOL:g}), "
        f"grad norm rel {gn_rel:.2e} (limit {CKV_PLAIN_GNORM_RTOL:g}); "
        f"attention projections' gradients against B6's forward kernel "
        f"with its plain backward: largest rel {sound[worst]:.2e} ({worst}; "
        f"limit {CKV_LEAF_RTOL:g}); {card}")
    say("    per leaf, kernels against the plain backward: " + ", ".join(
        f"{n} {r:.2e}" for n, r in sound.items()))
    say("    per leaf, kernels against the plain forward and backward (no "
        "limit): " + ", ".join(f"{n} {r:.2e}" for n, r in loose.items())
        + "; share of idx entries that differ, each B6 forward in order: "
        + ", ".join(f"{x:.4f}" for x in moved))
    for f, rel in faults.items():
        top = max(rel, key=rel.get)
        say(f"    fault planted in B6's backward, {f}: largest {rel[top]:.2e} "
            f"({top}); loss rel {abs(runs[f][0] - lp) / abs(lp):.2e}, grad "
            f"norm rel {abs(runs[f][1] - gp) / abs(gp):.2e}")
    if not rehearse and not (nk == cfg.n_layers and npl == 0
                             and n_yard == 0):
        raise AssertionError(f"the kernel step ran B6's backward {nk} times, "
                             f"the plain steps {npl} and {n_yard}")
    if not (loss_rel <= CKV_PLAIN_LOSS_RTOL and gn_rel <= CKV_PLAIN_GNORM_RTOL
            and sound[worst] <= CKV_LEAF_RTOL):
        raise AssertionError(f"ClusterKV step through B6's kernels against "
                             f"its plain version: loss {lk} vs {lp}, grad "
                             f"norm {gk} vs {gp}, {worst} rel {sound[worst]}")
    missed = [f for f, rel in faults.items()
              if max(rel.values()) <= CKV_LEAF_RTOL]
    if missed:
        raise AssertionError(f"faults planted in B6's backward pass the "
                             f"per-leaf limit {CKV_LEAF_RTOL:g}: {missed}")
    del params, batch
    return {"layers": cfg.n_layers, "batch": b, "seq": s,
            "kernel": {"loss": lk, "grad_norm": gk},
            "plain": {"loss": lp, "grad_norm": gp}, "loss_rel": loss_rel,
            "grad_norm_rel": gn_rel, "leaf_rel": sound,
            "leaf_rel_plain_forward": loose, "idx_moved": moved,
            "faults": {f: {"leaf_rel": rel, "loss": runs[f][0],
                           "grad_norm": runs[f][1]}
                       for f, rel in faults.items()},
            "limits": [CKV_PLAIN_LOSS_RTOL, CKV_PLAIN_GNORM_RTOL,
                       CKV_LEAF_RTOL]}


def b6_backward_bound(b, hq, hkv, s, dh, dv, n_sel, elem: int):
    """Least time of B6's backward: the gradient needs S, dP, dV, dK and
    dQ once each a selected tile pair (tiles of 128), 2 bq bk (3 dh + 2 dv)
    operations, at the bf16 rate (float32 CUDA-core rate in float32);
    bytes: q, k, v, the output, its cotangent, idx, positions and
    statistics read, dq, dk, dv written, each once. Returns the bound, the
    operations it counts, and the operations the kernels execute: 2 bq bk
    (4 dh + 3 dv), S and dP once in the dQ kernel and again in the dK/dV
    kernel, which keeps each block's sums its own (no atomics); the op's
    FLOP formula counts these."""
    pairs = b * hq * (s // 128) * n_sel
    ops_ = 2.0 * 128 * 128 * (3 * dh + 2 * dv) * pairs
    executed = 2.0 * 128 * 128 * (4 * dh + 3 * dv) * pairs
    byts = elem * (b * hq * s * (dh + 2 * dv) * 2 + b * hkv * s * (dh + dv)
                   * 2) + 4 * (b * hkv * s + s + b * hkv * (s // 128) * n_sel
                               + 2 * b * hq * s)
    rate = BF16_FLOP_PER_S if elem == 2 else FP32_FLOP_PER_S
    t_b, t_o = byts / HBM_BYTES_PER_S * 1e3, ops_ / rate * 1e3
    return ((t_b, "bytes") if t_b >= t_o else (t_o, "operations")), ops_, \
        executed


def time_b6_backward(args, dev, timer, rehearse, card):
    """B6's backward at the layer shapes of ``B6_BWD_SHAPES`` (bf16, causal,
    16 of 32 tiles of 128): held against its plain version, then timed
    (the backward op: key-tile lists + their order + dQ + dK/dV, and each
    of the four launches alone, ``block_attention.backward_stages``) beside
    the plain backward, ``torch.autograd.grad`` of
    ``scaled_dot_product_attention`` with the equivalent boolean mask (the
    library time), and the bound; the operations the kernels issue over
    dQ + dK/dV's time, and the largest and mean number of visits of a
    dK/dV block (its key tile's list x g). Launches here are not a
    path's."""
    from repro_torch.core.clusterkv import sparse_block_attention
    from repro_torch.kernels import block_attention as k_ba

    gen = torch.Generator(device=dev).manual_seed(args.seed + 185)
    it_fast, it_slow = (2, 1) if rehearse else (20, 3)
    n_sel = 4 if rehearse else 16
    rows = []
    with uncounted(k_ba.block_attention, k_ba.key_tile_lists,
                   k_ba.key_tile_order, k_ba.block_attention_backward):
        for what, b, hq, hkv, dh, dv in B6_BWD_SHAPES:
            s = 512 if rehearse else 4096
            if rehearse:
                b = 1
            dtype = torch.float32 if rehearse else torch.bfloat16
            q, k, _, kpos, qpos, idx = attention_inputs(
                gen, b, hq, hkv, s, dh, 128, n_sel, dtype, dev)
            v = torch.randn((b, hkv, s, dv), generator=gen,
                            device=dev).to(dtype)
            if rehearse:
                out, m, l = sparse_block_attention(q, k, v, kpos, qpos, idx,
                                                   128, 128, stats=True)
                stats = torch.stack([m, l])
            else:
                out, stats = torch.ops.repro_torch.block_attention_with_stats(
                    q, k, v, kpos, qpos, idx, 128, 128, True)
            dout = torch.randn(tuple(out.shape), generator=gen,
                               device=dev).to(dtype)
            run = lambda: k_ba.block_attention_backward(
                q, k, v, kpos, qpos, idx, out, stats, dout, bq=128, bk=128)
            plain = lambda: k_ba.block_attention_backward_plain(
                q, k, v, kpos, qpos, idx, out, None, dout, bq=128, bk=128)
            got, want = run(), plain()
            again = run()
            errs = []
            for name, g_, a, w in zip(("dq", "dk", "dv"), got, again, want):
                if not torch.equal(g_, a):
                    raise AssertionError(f"B6 backward {what}: {name} "
                                         "differs from run to run")
                errs.append(check_close(
                    f"B6 backward {what} {name}", g_.float(), w.float(),
                    rel_tol=B6_BWD_REL_TOL,
                    bf16_ulps=BF16_ULPS if dtype == torch.bfloat16 else 0))
            lk = k_ba.key_tile_lists(idx, s // 128)
            lp = k_ba.key_tile_lists_plain(idx, s // 128)
            if not (torch.equal(lk[0], lp[0]) and torch.equal(lk[1], lp[1])):
                raise AssertionError(f"key-tile lists {what} differ from "
                                     "their plain version")
            if not torch.equal(k_ba.key_tile_order(lk[0]),
                               k_ba.key_tile_order_plain(lp[0])):
                raise AssertionError(f"key-tile order {what} differs from "
                                     "its plain version")
            visits = (lp[0][..., 1:] - lp[0][..., :-1]).float() * (hq // hkv)
            ms, plain_ms = timer(run, it_fast), timer(plain, it_slow)
            lists_plain_ms = timer(lambda: k_ba.key_tile_lists_plain(
                idx, s // 128), it_slow)
            order_plain_ms = timer(lambda: k_ba.key_tile_order_plain(lp[0]),
                                   it_slow)
            if rehearse:           # the launches exist on the card only
                stage_ms = dict.fromkeys(("lists", "order", "dq", "dkv"),
                                         0.0)
            else:
                stages, _ = k_ba.backward_stages(
                    q, k, v, kpos, qpos, idx, out, stats, dout, 128, 128,
                    True)
                for f in stages.values():
                    f()
                stage_ms = {name: timer(f, it_fast)
                            for name, f in stages.items()}
            # the library yardstick: SDPA's backward over the same keys
            # with the equivalent boolean mask (selected tiles AND causal)
            g = hq // hkv
            tile_of = torch.arange(s, device=dev) // 128
            sel = torch.zeros((b, hkv, s // 128, s // 128), dtype=torch.bool,
                              device=dev)
            sel.scatter_(-1, idx.long(), True)
            mask = sel[:, :, :, tile_of].repeat_interleave(128, dim=2)
            mask &= kpos[:, :, None, :] <= qpos[None, None, :, None]
            mask = mask.repeat_interleave(g, dim=1)
            xs = [t.detach().clone().requires_grad_() for t in (
                q, k.repeat_interleave(g, dim=1),
                v.repeat_interleave(g, dim=1))]
            o_lib = torch.nn.functional.scaled_dot_product_attention(
                *xs, attn_mask=mask)
            lib_ms = timer(lambda: torch.autograd.grad(
                o_lib, xs, dout, retain_graph=True), it_fast)
            del o_lib, xs, mask, sel
            (bound, by), flops, executed = b6_backward_bound(
                b, hq, hkv, s, dh, dv, n_sel, 2 if dtype == torch.bfloat16
                else 4)
            # what dQ + dK/dV issue to the tensor cores: S and dP in both,
            # dQ, dK and dV twice (p and dS as hi + lo)
            issued = (2.0 * 128 * 128 * (6 * dh + 4 * dv)
                      * b * hq * (s // 128) * n_sel)
            kern_ms = stage_ms["dq"] + stage_ms["dkv"]
            tflops = issued / (kern_ms * 1e-3) / 1e12 if kern_ms else 0.0
            say(f"  B6 backward, {what} layer: q ({b}, {hq}, {s}, {dh}), k "
                f"({b}, {hkv}, {s}, {dh}), v (..., {dv}) {dtype}, {n_sel} of "
                f"{s // 128} tiles: kernels {ms:.3f} ms = lists "
                f"{stage_ms['lists']:.4f} + order {stage_ms['order']:.4f} + "
                f"dQ {stage_ms['dq']:.4f} + dK/dV {stage_ms['dkv']:.4f} "
                f"(each alone; dQ + dK/dV issue {issued / 1e9:.1f} GFLOP with "
                f"hi + lo, {tflops:.1f} TFLOP/s), "
                f"plain {plain_ms:.3f} ms, SDPA backward (boolean mask) "
                f"{lib_ms:.3f} ms, bound {bound:.4f} ms ({by}: "
                f"{flops / 1e9:.1f} GFLOP the gradient needs; the kernels "
                f"execute {executed / 1e9:.1f}); dK/dV visits a block max "
                f"{float(visits.max()):g}, mean {float(visits.mean()):g}; "
                "errs dq/dk/dv "
                + "/".join(f"{e:.2e}" for e, _ in errs)
                + f" (tolerance {B6_BWD_REL_TOL:g} x scale + {BF16_ULPS} "
                f"bf16 spacing); bit-equal run to run; {card}")
            rows.append({"config": what, "dtype": str(dtype), "B": b,
                         "hq": hq, "hkv": hkv, "dh": dh, "dv": dv, "S": s,
                         "n_sel": n_sel, "max_abs_err": max(e for e, _ in
                                                            errs),
                         "errs": errs, "ms": ms,
                         "lists_ms": stage_ms["lists"],
                         "order_ms": stage_ms["order"],
                         "dq_ms": stage_ms["dq"], "dkv_ms": stage_ms["dkv"],
                         "issued_gflop": issued / 1e9,
                         "issued_tflops": tflops,
                         "visits_max": float(visits.max()),
                         "visits_mean": float(visits.mean()),
                         "lists_plain_ms": lists_plain_ms,
                         "order_plain_ms": order_plain_ms,
                         "plain_ms": plain_ms, "library_ms": lib_ms,
                         "bound_ms": bound, "bound_by": by,
                         "gflop": flops / 1e9,
                         "executed_gflop": executed / 1e9})
            del q, k, v, kpos, qpos, idx, out, stats, dout, got, want, again
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    return rows


def b6_backward_entries(rows: list) -> list:
    """The kernels line's entries of B6's backward, its key-tile lists and
    their order, at the main path's shape (Qwen2-0.5B's training microbatch); the other
    layer shapes ride along."""
    qwen = rows[0]
    shape = (f"q ({qwen['B']}, {qwen['hq']}, {qwen['S']}, {qwen['dh']}) "
             f"{qwen['dtype']}, k/v ({qwen['B']}, {qwen['hkv']}, "
             f"{qwen['S']}, {qwen['dh']}), bq=bk=128, n_sel={qwen['n_sel']},"
             f" causal")
    # the backward at these shapes (bf16, tiles of 128) is the Hopper
    # kernels'; the lists, their order and the other instances are
    # block_attention_bwd.cu's
    src = "src/repro_torch/kernels/csrc/block_attention_bwd.cu"
    src_sm90 = "src/repro_torch/kernels/csrc/block_attention_bwd_sm90.cu"
    # the lists read idx once and write the offsets and entries once
    n_idx = qwen["B"] * qwen["hkv"] * (qwen["S"] // 128) * qwen["n_sel"]
    list_bytes = 4 * (2 * n_idx + qwen["B"] * qwen["hkv"]
                      * (qwen["S"] // 128 + 1))
    # the order reads the offsets once and writes one int a key tile
    order_bytes = 4 * qwen["B"] * qwen["hkv"] * (2 * (qwen["S"] // 128) + 1)
    return [
        {"name": "block_attention_backward", "route": "cuda",
         "source": src_sm90,
         "replaces": "src/repro/kernels/block_attention.py:60",
         "backward_of": "B6 (the reference differentiates "
                        "src/repro/core/clusterkv.py:211 with jax.grad)",
         "launches": 0, "shape": shape, "max_abs_err": qwen["max_abs_err"],
         "ms": qwen["ms"], "plain_ms": qwen["plain_ms"],
         "bound_ms": qwen["bound_ms"], "bound_by": qwen["bound_by"],
         "library_ms": qwen["library_ms"], "layer_shapes": rows},
        {"name": "key_tile_lists", "route": "cuda", "source": src,
         "replaces": "src/repro/kernels/block_attention.py:60",
         "backward_of": "B6 (the transpose of idx its backward walks)",
         "launches": 0, "shape": f"idx ({qwen['B']}, {qwen['hkv']}, "
                                 f"{qwen['S'] // 128}, {qwen['n_sel']})",
         "max_abs_err": 0.0, "ms": qwen["lists_ms"],
         "plain_ms": qwen["lists_plain_ms"],
         "bound_ms": list_bytes / HBM_BYTES_PER_S * 1e3,
         "bound_by": "bytes", "library_ms": None},
        {"name": "key_tile_order", "route": "cuda", "source": src,
         "replaces": "src/repro/kernels/block_attention.py:60",
         "backward_of": "B6 (the order its dK/dV blocks are numbered in)",
         "launches": 0, "shape": f"off ({qwen['B']}, {qwen['hkv']}, "
                                 f"{qwen['S'] // 128 + 1})",
         "max_abs_err": 0.0, "ms": qwen["order_ms"],
         "plain_ms": qwen["order_plain_ms"],
         "bound_ms": order_bytes / HBM_BYTES_PER_S * 1e3,
         "bound_by": "bytes", "library_ms": None}]


def phase_train(args, dev, sync, timer, rehearse, reset_counts,
                collect_counts, card: str):
    """Phase 18: single-card training. Qwen2-0.5B trained at full width
    and depth with flash attention, then served from its trained weights
    through B6/B5, then trained through ClusterKV (B6's forward and its
    hand-written backward); the accumulation checks, the scan's gradient,
    one step of each other family, one ClusterKV step of granite and
    minicpm3, the ClusterKV step against B6's plain forward and backward,
    B6's backward at three layer shapes, and C40 for B1-B5."""
    t_phase = time.perf_counter()
    say("== phase 18: single-card training (make_train_step, AdamW / "
        "Adafactor, remat, chunked CE), serving the trained weights, and "
        "training through ClusterKV")
    out = {"qwen": train_qwen(args, dev, sync, rehearse, reset_counts,
                              collect_counts, card)}
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out["qwen_clusterkv"] = train_qwen_clusterkv(
        args, dev, sync, rehearse, reset_counts, collect_counts, card,
        out["qwen"])
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out["accumulation"] = train_accumulation_checks(args, dev, sync,
                                                    rehearse)
    out["scan_grad"] = scan_gradient_check(args, dev, rehearse)
    out["families"] = train_families(args, dev, sync, rehearse, card)
    out["families_clusterkv"] = train_families_clusterkv(
        args, dev, sync, rehearse, reset_counts, collect_counts, card)
    reset_counts()
    out["ckv_against_plain"] = ckv_step_against_plain(args, dev, sync,
                                                      rehearse, card)
    out["b6_backward"] = time_b6_backward(args, dev, timer, rehearse, card)
    out["c40"] = c40_still_raises(args, dev, rehearse)
    collect_counts("phase 18 checks")
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t_phase
    say(f"  phase 18 wall time: {out['wall_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# training on a process mesh (phase 19)
# ---------------------------------------------------------------------------

# phase 18's run on a (1, 1) ("data", "model") process mesh: 3 steps of
# its batch, against 3 steps without a mesh from the same init, within the
# single-card step tests' bounds (tests/test_torch_train.py)
MESH_STEPS, MESH_RTOL = 3, 1e-5
# steps at full width and cut depth on the mesh against as many without:
# (arch, cut, expert_parallel, steps). granite takes the expert-parallel
# branch; mistral trains with Adafactor, two steps, so the second's loss
# reads the first's update made on the shards
MESH_CUTS = (("granite-moe-3b-a800m", {"n_layers": 2}, True, 1),
             ("mistral-large-123b", {"n_layers": 1}, False, 2))
MESH_CUT_BATCH, MESH_CUT_SEQ = 2, 1024
# the launcher's restart on the mesh: the reduced Qwen config, 4 steps
# saving at 1 and 3, step 3 removed and resumed from 1. The resumed run
# ends within LAUNCH_ATOL of the uninterrupted one: the card's scatter-add
# backward sums in a changing order, and AdamW (lr 3e-4) turns a flipped
# near-zero gradient into at most 2 lr a step
LAUNCH_ATOL = 4 * 3e-4


def _tree_diff(a, b) -> float:
    """The largest absolute difference of two trees' leaves, by key."""
    from repro_torch.models import param as pm

    fa = pm.aligned_leaves(a, a)
    fb = pm.aligned_leaves(b, a)
    return max(float((_whole(x).float() - _whole(y).float()).abs().max())
               for x, y in zip(fa, fb))


def _whole(t):
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


def mesh_qwen(args, dev, sync, mesh, rehearse, reset_counts, collect_counts,
              card):
    """Phase 18's Qwen2-0.5B run on the process mesh against mesh=None."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.data import pipeline
    from repro_torch.models import model_api
    from repro_torch.models import param as pm
    from repro_torch.optim.optimizers import make_optimizer
    from repro_torch.train import trainer

    if rehearse:
        cfg = reduced_config("qwen2-0.5b").with_(remat=True, loss_chunk=64)
        b, s = 4, 64
    else:
        cfg = get_config("qwen2-0.5b")
        b, s = TRAIN_BATCH, TRAIN_SEQ
    opt = make_optimizer(cfg.optimizer, warmup=max(TRAIN_STEPS // 20, 1),
                         total=TRAIN_STEPS)
    batch = pipeline.to_device(pipeline.token_batch(cfg, 0, b, s, args.seed),
                               dev)
    runs = {}
    for kind in ("plain", "mesh"):
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        params = model_api.init(cfg, torch.Generator(device=dev).manual_seed(
            args.seed), device=dev)
        state = opt.init(params)
        m = mesh if kind == "mesh" else None
        step, _ = trainer.make_train_step(cfg, m, "flash",
                                          microbatch=TRAIN_MICRO,
                                          optimizer=opt)
        if m is not None:
            params, state = trainer.place_train_state(cfg, m, opt, params,
                                                      state)
        sync()
        reset_counts()
        losses, norms, ms = timed_steps(step, params, state, batch, MESH_STEPS,
                                        sync)
        launches = collect_counts(f"{cfg.name} training ({kind})")
        if any(launches.values()):
            raise AssertionError(f"training launched kernels: {launches}")
        peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
        runs[kind] = {"losses": losses, "grad_norms": norms, "step_ms": ms,
                      "peak_bytes": peak}
        del params, state, step
    for i in range(MESH_STEPS):
        for key in ("losses", "grad_norms"):
            got, want = runs["mesh"][key][i], runs["plain"][key][i]
            if not (math.isfinite(got) and
                    abs(got - want) <= MESH_RTOL * abs(want)):
                raise AssertionError(f"mesh step {i + 1}: {key} {got} "
                                     f"against {want} without a mesh")
    mesh_ms = float(np.median(runs["mesh"]["step_ms"][1:]))
    plain_ms = float(np.median(runs["plain"]["step_ms"][1:]))
    say(f" -- {cfg.name} ({cfg.n_layers} layers, d_model {cfg.d_model}), "
        f"batch {b} x {s} in {TRAIN_MICRO} microbatches, {MESH_STEPS} steps "
        f"on mesh {mesh.shape} and without a mesh from seed {args.seed}")
    for i in range(MESH_STEPS):
        say(f"  step {i + 1}: mesh loss {runs['mesh']['losses'][i]:.6f} "
            f"grad norm {runs['mesh']['grad_norms'][i]:.4f} "
            f"{runs['mesh']['step_ms'][i]:.1f} ms | no mesh loss "
            f"{runs['plain']['losses'][i]:.6f} grad norm "
            f"{runs['plain']['grad_norms'][i]:.4f} "
            f"{runs['plain']['step_ms'][i]:.1f} ms")
    say(f"  step ms (median of steps 2-{MESH_STEPS}): mesh {mesh_ms:.1f}, "
        f"no mesh {plain_ms:.1f}; peak GiB: mesh "
        f"{runs['mesh']['peak_bytes'] / 2 ** 30:.3f}, no mesh "
        f"{runs['plain']['peak_bytes'] / 2 ** 30:.3f}; world of one, no "
        f"exchange between ranks measured; {card}")
    return {"arch": cfg.name, "batch": b, "seq": s, "microbatch": TRAIN_MICRO,
            "steps": MESH_STEPS, "mesh_shape": mesh.shape, **{
                f"{kind}_{k}": v for kind, r in runs.items()
                for k, v in r.items()},
            "mesh_step_s_median": mesh_ms / 1e3,
            "plain_step_s_median": plain_ms / 1e3, "card": card}


def mesh_cut_step(args, dev, sync, mesh, rehearse, card, arch, cut, ep,
                  n_steps):
    """``arch`` at full width and cut depth (``expert_parallel`` as
    ``ep``): ``n_steps`` on the mesh against as many without, from the
    same init."""
    import dataclasses

    from repro_torch.configs import get_config, reduced_config
    from repro_torch.data import pipeline
    from repro_torch.models import model_api, moe
    from repro_torch.optim.optimizers import make_optimizer
    from repro_torch.train import trainer

    full = get_config(arch)
    if rehearse:
        cfg = reduced_config(arch).with_(optimizer=full.optimizer)
        cuts, b, s = ["reduced config"], 2, 32
    else:
        cfg, b, s = full.with_(**cut), MESH_CUT_BATCH, MESH_CUT_SEQ
        cuts = [f"{k} {v} of {getattr(full, k)}" for k, v in cut.items()]
    if ep:
        cfg = cfg.with_(moe=dataclasses.replace(cfg.moe,
                                                expert_parallel=True))
        if moe.mesh_branch(cfg, mesh, s) != "ep":
            raise AssertionError(f"{cfg.name}'s step on the mesh would not "
                                 "take the expert-parallel branch")
    opt = make_optimizer(cfg.optimizer, warmup=1, total=n_steps)
    batch = pipeline.to_device(pipeline.token_batch(cfg, 0, b, s, args.seed),
                               dev)
    got = {}
    for kind in ("plain", "mesh"):
        params = model_api.init(cfg, torch.Generator(device=dev).manual_seed(
            args.seed), device=dev)
        state = opt.init(params)
        m = mesh if kind == "mesh" else None
        step, _ = trainer.make_train_step(cfg, m, "flash", optimizer=opt)
        if m is not None:
            params, state = trainer.place_train_state(cfg, m, opt, params,
                                                      state)
        got[kind] = timed_steps(step, params, state, batch, n_steps, sync)
        del params, state, step
        sync()
    for i, key in enumerate(("loss", "grad norm")):
        for j in range(n_steps):
            a, w = got["mesh"][i][j], got["plain"][i][j]
            if not (math.isfinite(a) and abs(a - w) <= MESH_RTOL * abs(w)):
                raise AssertionError(f"{cfg.name} step {j + 1} on the mesh: "
                                     f"{key} {a} against {w} without one")
    what = ", ".join(x for x in (cfg.family, "expert_parallel" if ep else "",
                                 cfg.optimizer) if x)
    say(f"  {cfg.name} [{what}]: batch {b} x {s}, {n_steps} step(s); loss "
        f"{got['mesh'][0]} (no mesh {got['plain'][0]}), grad norm "
        f"{got['mesh'][1]} (no mesh {got['plain'][1]}), ms "
        f"{[round(x, 1) for x in got['mesh'][2]]} (no mesh "
        f"{[round(x, 1) for x in got['plain'][2]]}); cut: {'; '.join(cuts)}; "
        f"{card}")
    return {"arch": cfg.name, "expert_parallel": ep,
            "optimizer": cfg.optimizer, "batch": b, "seq": s, "cuts": cuts,
            **{kind: {"loss": r[0], "grad_norm": r[1], "step_ms": r[2]}
               for kind, r in got.items()}}


def mesh_launcher(args, dev, rehearse):
    """``launch.train --mesh 1,1`` with a checkpoint directory: run, the
    last checkpoint removed (the run killed after its first save), run
    again: it resumes through ``restore(shardings=)``."""
    import contextlib
    import io

    from repro_torch.launch import train as launch

    ckpt = Path(tempfile.mkdtemp(prefix="chip_smoke_mesh_"))
    argv = ["--arch", "qwen2-0.5b", "--reduced", "--steps", "4", "--batch",
            "4", "--seq", "128", "--ckpt-every", "2", "--log-every", "1",
            "--mesh", "1,1", "--ckpt-dir", str(ckpt),
            "--device", "cpu" if rehearse else "cuda"]
    try:
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            first = launch.main(argv)
        saved = sorted(p.name for p in ckpt.glob("step_*"))
        if saved != ["step_1", "step_3"]:
            raise AssertionError(f"the launcher saved {saved}")
        shutil.rmtree(ckpt / "step_3")
        with contextlib.redirect_stdout(out):
            second = launch.main(argv)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    text = out.getvalue()
    if "resumed from the checkpoint of step 1" not in text:
        raise AssertionError(f"the launcher did not resume:\n{text}")
    diff = _tree_diff(first["params"], second["params"])
    if not diff <= LAUNCH_ATOL:
        raise AssertionError(f"the resumed run ends {diff} from the "
                             "uninterrupted one")
    say(f"  launcher --mesh 1,1: saved {saved}, resumed from step 1 after "
        f"step 3's checkpoint was removed; largest parameter difference "
        f"from the uninterrupted run {diff:.3g} (bound {LAUNCH_ATOL:g})")
    return {"saved": saved, "resumed_from": 1, "max_param_diff": diff}


def mesh_pipeline(dev, mesh):
    """``pipeline_apply`` at one stage against sequential application: the
    output, and the gradients of ``sum(y * cot)`` with respect to the stage
    weights, biases and ``x`` through its backward (ROADMAP C47)."""
    from repro_torch.launch.pp import pipeline_apply

    g = torch.Generator(device=dev).manual_seed(0)
    w = torch.randn(1, 256, 256, generator=g, device=dev) / 16
    bias = torch.randn(1, 256, generator=g, device=dev) * 0.1
    x = torch.randn(64, 256, generator=g, device=dev)
    cot = torch.randn(64, 256, generator=g, device=dev)

    def stage_fn(p, xm):
        return torch.tanh(xm @ p["w"] + p["b"])

    y = pipeline_apply({"w": w, "b": bias}, x, stage_fn, mesh, "model", 4)
    want = torch.tanh(x @ w[0] + bias[0])
    err = float((y - want).abs().max())
    if not err <= 1e-5:
        raise AssertionError(f"pipeline_apply at one stage: max error {err}")
    leaves = [t.clone().requires_grad_(True) for t in (w, bias, x)]
    yp = pipeline_apply({"w": leaves[0], "b": leaves[1]}, leaves[2],
                        stage_fn, mesh, "model", 4)
    got = torch.autograd.grad((yp * cot).sum(), leaves)
    ref = [t.clone().requires_grad_(True) for t in (w, bias, x)]
    want = torch.autograd.grad(
        (torch.tanh(ref[2] @ ref[0][0] + ref[1][0]) * cot).sum(), ref)
    gerr = max(float((a - b).abs().max() / b.abs().max())
               for a, b in zip(got, want))
    if not gerr <= 1e-5:
        raise AssertionError(f"pipeline_apply's backward at one stage: "
                             f"relative error {gerr}")
    say(f"  pipeline_apply, one stage, 4 microbatches of 16 x 256: max "
        f"error {err:.3g} against sequential application; its backward's "
        f"gradients of w, b and x within {gerr:.3g} x their largest")
    return {"max_abs_err": err, "grad_rel_err": gerr}


def phase_mesh(args, dev, sync, rehearse, reset_counts, collect_counts,
               card: str):
    """Phase 19: training on a process mesh, as a world of one (the one
    card: nccl refuses two ranks on one device). A (1, 1) ("data",
    "model") mesh over an nccl group of this process (gloo on the CPU)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_test_mesh

    t_phase = time.perf_counter()
    say("== phase 19: training on a process mesh (DTensor parameters and "
        "state; world of one)")
    rendezvous = Path(tempfile.mkdtemp(prefix="chip_smoke_pg_")) / "pg"
    kw = {} if rehearse else {"device_id": torch.device("cuda", 0)}
    dist.init_process_group("gloo" if rehearse else "nccl",
                            init_method=f"file://{rendezvous}", rank=0,
                            world_size=1, **kw)
    try:
        mesh = make_test_mesh(1, 1, device=dev)
        out = {"qwen": mesh_qwen(args, dev, sync, mesh, rehearse,
                                 reset_counts, collect_counts, card)}
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        for arch, cut, ep, n_steps in MESH_CUTS:
            out[arch] = mesh_cut_step(args, dev, sync, mesh, rehearse, card,
                                      arch, cut, ep, n_steps)
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        out["launcher"] = mesh_launcher(args, dev, rehearse)
        out["pipeline"] = mesh_pipeline(dev, mesh)
        collect_counts("phase 19 checks")
    finally:
        dist.destroy_process_group()
        shutil.rmtree(rendezvous.parent, ignore_errors=True)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t_phase
    say(f"  phase 19 wall time: {out['wall_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# the dry run on the card (phase 20)
# ---------------------------------------------------------------------------

# the predicted peak of phase 19's Qwen step against its measured one
DRYRUN_PEAK_TOL = 0.15
# a 16x16 rank's traced FLOPs against its 16x1 trace / 16 (Qwen2-0.5B)
DRYRUN_SPLIT_RATIO = 1.3
DRYRUN_TAG = "chip_smoke"
DRYRUN_CELL = r"""
import json, sys
sys.path.insert(0, SRC)
from repro_torch.configs import reduced_config
from repro_torch.launch import dryrun
kw = json.loads(KW)
if kw.pop("reduced"):
    kw["cfg"] = reduced_config(kw["arch"])
for key in ("sizes", "mesh"):
    if kw.get(key) is not None:
        kw[key] = tuple(kw[key])
arch, shape = kw.pop("arch"), kw.pop("shape")
print(json.dumps(dryrun.run_cell(arch, shape, False, **kw)))
"""


def dryrun_cells(rehearse: bool) -> dict:
    """Phase 20's cells (``launch.dryrun.run_cell`` keywords): Qwen2-0.5B's
    phase 19 step (batch 16 x 4096 in 2 microbatches, 8 rows each) on a
    fake (1, 1) world; its and h2o-danube-3-4b's ``train_4k`` cells on
    the production 16x16 world and on a fake 16x1 world (the same 256
    rows, 16 a rank, no tensor split); Qwen2-0.5B's ``prefill_32k`` cell
    through ClusterKV on 16x16 (B6 as the opaque op). Fake CUDA tensors on
    the card; in the CPU rehearsal fake CPU tensors at the reduced configs
    and small sizes."""
    dev = "cpu" if rehearse else "cuda"
    one = dict(mesh=(1, 1), microbatch=TRAIN_MICRO,
               sizes=(64, 4) if rehearse else (TRAIN_SEQ, TRAIN_BATCH))
    small = (64, 16) if rehearse else None
    cells = {"phase19_step": dict(arch="qwen2-0.5b", shape="train_4k",
                                  **one)}
    for key, arch in DRYRUN_TRAIN.items():
        cells[key] = dict(arch=arch, shape="train_4k", mesh=None,
                          sizes=small)
        cells[key + "_16x1"] = dict(arch=arch, shape="train_4k",
                                    mesh=(16, 1), sizes=small)
    cells["prefill_32k_clusterkv"] = dict(
        arch="qwen2-0.5b", shape="prefill_32k", mesh=None,
        backend="clusterkv", sizes=small)
    cells["train_4k_clusterkv"] = dict(
        arch="qwen2-0.5b", shape="train_4k", mesh=None, backend="clusterkv",
        sizes=small)
    return cells, dev


# phase 20's train_4k cells on 16x16 and 16x1, by record name
DRYRUN_TRAIN = {"train_4k": "qwen2-0.5b",
                "h2o_train_4k": "h2o-danube-3-4b"}


def time_b5_op(timer, dev, rehearse: bool) -> dict:
    """B5 per call at the tick shape of phases 9/10 (4 slots, S 8192, 16
    tiles, plan mode, bf16) through the opaque op
    ``torch.ops.repro_torch.decode_attend`` and through its ``CUDA``
    implementation called directly (the ctypes launch, no dispatcher), on
    the same prepared inputs, alternating; and through the wrapper the
    paths call."""
    from repro_torch.kernels import decode_attend as k_da

    if rehearse:
        say("  B5 through the op against the direct call: not timed on the "
            "CPU (the op has a CUDA implementation only)")
        return {}
    gen = torch.Generator(device=dev).manual_seed(5)
    b, s5, n5 = 4, 8192, 16
    q, k, v, pos, cent = decode_inputs(gen, b, 2, 7, s5, 64, 128,
                                       torch.bfloat16, dev, holes=0.0)
    qp = torch.tensor([s5 - 1, s5 // 2, s5 // 3, s5 // 4], dtype=torch.int32,
                      device=dev)
    qk = q.reshape(b, 2, 7, 64).contiguous()
    args = (qk, k, v, pos, cent.contiguous(), qp, None, None, None, n5, 128,
            True, False, 128)
    runs = {"op": lambda: torch.ops.repro_torch.decode_attend(*args),
            "direct": lambda: k_da.launch(*args),
            "wrapper": lambda: k_da.decode_attend_fused(
                q, k, v, pos, cent, qp, n_sel=n5, bk=128, plan_mode=True,
                has_self=False, window=128)}
    with uncounted(k_da.decode_attend_fused):
        if not torch.equal(runs["op"](), runs["direct"]()):
            raise AssertionError("B5 through the op and the direct call "
                                 "differ")
    got = {name: [] for name in runs}
    with uncounted(k_da.decode_attend_fused):
        for _ in range(3):
            for name in ("op", "direct", "direct", "op", "wrapper"):
                got[name].append(timer(runs[name], 200))
    out = {name: float(np.median(v)) for name, v in got.items()}
    out["op_minus_direct_us"] = (out["op"] - out["direct"]) * 1e3
    say(f"  B5 per call, tick shape (B=4 Hkv=2 g=7 S=8192 n_sel=16 bf16 "
        f"plan mode), back to back: through the op {out['op']:.5f} ms, "
        f"direct {out['direct']:.5f} ms (the op adds "
        f"{out['op_minus_direct_us']:.2f} us), through the wrapper "
        f"{out['wrapper']:.5f} ms; medians of 3 x (op, direct) pairs")
    return out


def phase_dryrun(args, dev, timer, rehearse: bool, mesh_train: dict,
                 card: str) -> dict:
    """Phase 20: ``launch.dryrun`` and ``launch.roofline`` on the card. The
    three cells trace at once, each in its own process (phase 19 held a
    real nccl group in this one; a fake world forms its own), over the
    ``fake`` process group with fake tensors: nothing is allocated. The
    predicted per-rank peak of phase 19's step must be within
    ``DRYRUN_PEAK_TOL`` of the peak phase 19 measured in this run."""
    from repro_torch.launch import analytic, roofline

    t_phase = time.perf_counter()
    say("== phase 20: the dry run (fake world, fake tensors) and the "
        "roofline")
    cells, device = dryrun_cells(rehearse)
    src = str(Path(__file__).resolve().parent / "src")
    procs = {}
    try:
        for name, kw in cells.items():
            kw = dict(kw, device=device, tag=DRYRUN_TAG, reduced=rehearse)
            code = f"SRC = {src!r}\nKW = {json.dumps(kw)!r}\n" + DRYRUN_CELL
            procs[name] = subprocess.Popen(
                [sys.executable, "-c", code], stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True)
        recs = {}
        for name, p in procs.items():
            out, err = p.communicate(timeout=900)
            if p.returncode != 0:
                raise AssertionError(f"dry run {name}: exit {p.returncode}\n"
                                     f"{err[-3000:]}")
            recs[name] = json.loads(out.strip().splitlines()[-1])
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()
    for name, rec in recs.items():
        if rec["status"] != "ok":
            raise AssertionError(f"dry run {name}: {rec.get('error')}\n"
                                 f"{rec.get('traceback')}")
        say(f"  {name}: {rec['arch']} {rec['shape']} on {rec['mesh']} "
            f"({rec['chips']} ranks, {rec['world']}), backend "
            f"{rec['backend']}, microbatch {rec['microbatch']}, traced in "
            f"{rec['trace_s']} s: {rec['cost']['flops']:.4g} FLOPs, peak "
            f"{rec['memory']['peak_bytes'] / 2 ** 30:.3f} GiB a rank, "
            f"collectives {rec['collectives']['entry']['counts']} "
            f"({rec['collectives']['weighted_bytes']:.4g} weighted bytes); "
            f"opaque kernel ops {rec.get('kernel_ops')}")
    b6 = recs["prefill_32k_clusterkv"].get("kernel_ops", {})
    if not rehearse and b6.get("block_attention", 0) <= 0:
        raise AssertionError(f"the ClusterKV prefill cell traced no B6 op: "
                             f"{b6}")
    b6t = recs["train_4k_clusterkv"].get("kernel_ops", {})
    if not rehearse and not (
            b6t.get("block_attention_with_stats", 0) > 0
            and b6t.get("block_attention_backward", 0) > 0):
        raise AssertionError(f"the ClusterKV train cell traced B6's "
                             f"forward and backward ops {b6t}")
    # the prediction against phase 19's measured peak
    step = recs["phase19_step"]
    predicted = step["memory"]["peak_bytes"]
    measured = mesh_train["qwen"]["mesh_peak_bytes"]
    rel = (predicted - measured) / measured if measured else float("nan")
    say(f"  phase 19's Qwen step, one rank: predicted peak "
        f"{predicted / 2 ** 30:.3f} GiB against {measured / 2 ** 30:.3f} "
        f"GiB measured in phase 19 ({rel:+.2%}); {card}")
    if not rehearse and not abs(rel) <= DRYRUN_PEAK_TOL:
        raise AssertionError(f"the dry run's peak is {rel:+.2%} from phase "
                             f"19's (limit {DRYRUN_PEAK_TOL:.0%})")
    # traced FLOPs against the analytic model (its 256-row cell, per rank)
    # and, for the 16x16 cells, against the 16x1 trace of the same rows
    rows_step = TRAIN_BATCH if not rehearse else 4
    flops = {}
    for name, chips, rows in [("phase19_step", 1, rows_step)] + [
            (key, 256, 256) for key in DRYRUN_TRAIN]:
        arch = recs[name]["arch"]
        ana = analytic.cell_model(arch, "train_4k",
                                  chips=chips).flops / chips * rows / 256
        got = {"traced": recs[name]["cost"]["flops"], "analytic": ana,
               "ratio": recs[name]["cost"]["flops"] / ana}
        line = (f"  {name}: {arch} traced {got['traced']:.4g} FLOPs a rank "
                f"against the analytic {ana:.4g} (ratio {got['ratio']:.3f})")
        if name in DRYRUN_TRAIN:
            per_rank = recs[name + "_16x1"]["cost"]["flops"] / 16
            got["traced_16x1_over_16"] = per_rank
            got["ratio_16x1"] = got["traced"] / per_rank
            got["peak_bytes"] = recs[name]["memory"]["peak_bytes"]
            line += (f"; against its 16x1 trace / 16 {per_rank:.4g} (ratio "
                     f"{got['ratio_16x1']:.3f}); peak "
                     f"{got['peak_bytes'] / 1e9:.3f} GB a rank")
        flops[name] = got
        say(line)
    ratio = flops["train_4k"]["ratio_16x1"]
    if not rehearse and not ratio <= DRYRUN_SPLIT_RATIO:
        raise AssertionError(f"Qwen2-0.5B train_4k on 16x16 traces {ratio:.3f}"
                             f"x its 16x1 trace / 16 (limit "
                             f"{DRYRUN_SPLIT_RATIO})")
    peak_h2o = flops["h2o_train_4k"]["peak_bytes"]
    card_bytes = (torch.cuda.get_device_properties(0).total_memory
                  if not rehearse else None)
    say(f"  h2o-danube-3-4b train_4k on 16x16: predicted peak "
        f"{peak_h2o / 1e9:.3f} GB a rank against the card's "
        f"{card_bytes / 1e9:.3f} GB" if card_bytes else
        f"  h2o-danube-3-4b train_4k on 16x16: predicted peak "
        f"{peak_h2o / 1e9:.3f} GB a rank (no card in the rehearsal)")
    if card_bytes and not peak_h2o < card_bytes:
        raise AssertionError(f"h2o-danube-3-4b train_4k's predicted peak "
                             f"{peak_h2o / 1e9:.3f} GB a rank does not fit "
                             f"the card's {card_bytes / 1e9:.3f} GB")
    say(f"  roofline (H100 rates on the counts, no time measured): "
        f"torch {torch.__version__}, fake backend formed "
        f"{recs['train_4k']['chips']} ranks as {recs['train_4k']['mesh']}")
    rows = roofline.main(["--tag", DRYRUN_TAG])
    b5 = time_b5_op(timer, dev, rehearse)
    wall = time.perf_counter() - t_phase
    say(f"  phase 20 wall time: {wall:.1f} s")
    return {"records": {n: {k: r.get(k) for k in (
                "arch", "shape", "mesh", "chips", "backend", "microbatch",
                "sizes", "trace_s", "cost", "memory", "collectives",
                "kernel_ops")} for n, r in recs.items()},
            "predicted_peak_bytes": predicted,
            "measured_peak_bytes": measured, "peak_rel_diff": rel,
            "flops": flops, "card_bytes": card_bytes, "roofline": rows,
            "b5_op": b5, "torch": torch.__version__, "wall_s": wall}


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
    from repro_torch.kernels import cluster_order as k_co
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
                "key_tile_lists": k_ba.key_tile_lists,
                "key_tile_order": k_ba.key_tile_order,
                "block_attention_backward": k_ba.block_attention_backward,
                "decode_attend_fused": k_da.decode_attend_fused,
                "cluster_codes": k_co.cluster_codes}
    # the decode kernel's wrapper also counts its launches per contract
    mode_counters = {"decode_attend_fused.plain_mode": "plain_mode_launches",
                     "decode_attend_fused.plan_mode": "plan_mode_launches"}
    # launches by the paths (phases 3-4, 6, 7, 9-13): counters are set to 0
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
    ptxas, ptxas_bwd = [], []
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
        report = _build.ptxas_report()
        ptxas = (ptxas_summary(report, "block_attention_mma")
                 + ptxas_summary(report, "block_attention_kernel"))
        if len(ptxas) != 11:
            raise AssertionError(f"-Xptxas -v reports {len(ptxas)} B6 "
                                 "instantiations, expected 5 bf16 + 6 "
                                 "float32")
        # B6's backward: dQ and dK/dV, bf16 by wgmma at tiles of 128,
        # by mma.sync at tiles of 32 and 64, and float32
        ptxas_bwd = [row for k in ("dq_wgmma", "dkv_wgmma", "dq_mma",
                                   "dkv_mma", "dq_kernel", "dkv_kernel")
                     for row in ptxas_summary(report, k)]
        if len(ptxas_bwd) != 22:
            raise AssertionError(f"-Xptxas -v reports {len(ptxas_bwd)} "
                                 "instantiations of B6's backward, expected "
                                 "2 x (3 wgmma bf16 + 2 mma.sync bf16 + 6 "
                                 "float32)")
        for row in ptxas + ptxas_bwd:
            say(f"  ptxas {row['kernel']}: {row['registers']} registers, "
                f"{row['spill_stores']} bytes spill stores, "
                f"{row['spill_loads']} bytes spill loads")
        # what ptxas says of the wgmma pipelines (a serialised wgmma is a
        # loss of speed, not of correctness)
        serial = sorted({ln.strip() for ln in report.splitlines()
                         if "wgmma.mma_async" in ln})
        say(f"  ptxas: {len(serial)} notes of serialised wgmma"
            + "".join(f"\n  ptxas: {ln[:240]}" for ln in serial))

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
    check_b6_backward(args, dev, rehearse, micro_cases)
    cluster_order_entry = check_cluster_order(args, dev, timer, rehearse)

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
    # 'auto' is the cost model's winner: the kernel on the card; on the
    # CPU (rehearsal) a plain path, the kernel not being ranked there
    auto = plan.resolve_backend()
    if (auto != "cuda") if not rehearse else (auto == "cuda"):
        raise AssertionError(f"backend 'auto' resolved to {auto!r}")

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

    # phase 14 reads the SIFT plan and its points again
    del b, vals1, col1, mask1, charges
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # ---------------------------------------------------------------- 6 ---
    tsne = phase_tsne(args, dev, timer, sync, x, rehearse, reset_counts,
                      collect_counts, k_tf)
    entries.append(tsne.pop("entry"))
    entries.append(cluster_order_entry)

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
    # ------------------------------------------------- 12 (with 10's weights)
    service = phase_service(args, dev, sync, cfg, params, rehearse,
                            reset_counts, collect_counts, serve)
    del params
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    say("== B5 and B6 at the serving path's shapes")
    entries += time_attention_kernels(args, dev, timer, rehearse,
                                      main_launches)

    # --------------------------------------------------------------- 11 ---
    stream = phase_stream(args, dev, timer, sync, rehearse, reset_counts,
                          collect_counts, k_bsr)
    # --------------------------------------------------------------- 13 ---
    solvers = phase_solvers(args, dev, timer, sync, rehearse, reset_counts,
                            collect_counts, k_bsr)
    # --------------------------------------------------------------- 14 ---
    ckv_cfg = cfg.clusterkv
    serve_shape = dict(batch=serve["slots"], hq=cfg.n_heads,
                       hkv=cfg.n_kv_heads, s=serve["max_seq"],
                       dh=cfg.head_dim, dv=cfg.head_dim,
                       bk=min(ckv_cfg.block_k, serve["max_seq"]),
                       n_sel=min(ckv_cfg.decode_clusters, serve["max_seq"]
                                 // min(ckv_cfg.block_k, serve["max_seq"])))
    ckpt_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_persist_"))
    try:
        persist = phase_persist(args, dev, timer, sync, rehearse,
                                reset_counts, collect_counts, k_bsr, plan, x,
                                build_s, solvers.pop("_batch"), serve_shape,
                                plan_batch.pop("_keys"), cfg, ckpt_dir)
        # ----------------------------------------------------------- 15 ---
        shard = phase_shard(args, dev, timer, sync, rehearse, reset_counts,
                            collect_counts, k_bsr, plan, solvers.pop("_krr"),
                            ckpt_dir)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    del plan, x
    # --------------------------------------------------------------- 16 ---
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    before = dict(main_launches)
    zoo = phase_zoo(args, dev, sync, rehearse, reset_counts, collect_counts)
    zoo["launches"] = {name: main_launches[name] - before[name]
                       for name in main_launches}
    # --------------------------------------------------------------- 17 ---
    before = dict(main_launches)
    zoo_b = phase_zoo_b(args, dev, sync, rehearse, reset_counts,
                        collect_counts, smi_line)
    zoo_b["launches"] = {name: main_launches[name] - before[name]
                         for name in main_launches}
    # --------------------------------------------------------------- 18 ---
    before = dict(main_launches)
    train = phase_train(args, dev, sync, timer, rehearse, reset_counts,
                        collect_counts, smi_line)
    entries += b6_backward_entries(train["b6_backward"])
    train["launches"] = {name: main_launches[name] - before[name]
                         for name in main_launches}
    # --------------------------------------------------------------- 19 ---
    before = dict(main_launches)
    mesh_train = phase_mesh(args, dev, sync, rehearse, reset_counts,
                            collect_counts, smi_line)
    mesh_train["launches"] = {name: main_launches[name] - before[name]
                              for name in main_launches}
    # --------------------------------------------------------------- 20 ---
    before = dict(main_launches)
    dry = phase_dryrun(args, dev, timer, rehearse, mesh_train, smi_line)
    collect_counts("phase 20 (the dry run launches none)")
    dry["launches"] = {name: main_launches[name] - before[name]
                       for name in main_launches}
    say("== B6 and B5 at each zoo configuration's heads and dims")
    zoo_checked = check_zoo_shapes(args, dev, rehearse)
    say("== B6 and B5 at the zoo's new shapes, timed")
    zoo_b6, zoo_b5 = time_zoo_kernels(args, dev, timer, rehearse)
    for e in entries:
        if e["name"] in ("bsr_spmv_batched", "bsr_spmv"):
            e["launches_streaming"] = stream["launches"][e["name"]]
            e["launches_solvers"] = solvers["launches"][e["name"]]
            e["launches_persist"] = persist["launches"][e["name"]]
            e["launches_shard"] = shard["launches"][e["name"]]
        if e["name"] in ("key_tile_lists", "key_tile_order",
                         "block_attention_backward"):
            e["launches_train"] = train["launches"][e["name"]]
            e["launches_mesh_train"] = mesh_train["launches"][e["name"]]
        if e["name"] in ("decode_attend_fused", "block_attention",
                         "cluster_codes"):
            e["launches_service"] = service["launches"][e["name"]]
            e["launches_zoo"] = zoo["launches"][e["name"]]
            e["launches_zoo_b"] = zoo_b["launches"][e["name"]]
            e["launches_train"] = train["launches"][e["name"]]
            e["launches_mesh_train"] = mesh_train["launches"][e["name"]]
        if e["name"] in ("decode_attend_fused", "block_attention"):
            e["zoo_shapes_checked"] = [r for r in zoo_checked
                                       if r["kernel"] == e["name"]]
        if e["name"] == "block_attention":
            e["zoo_shapes"] = zoo_b6
            e["ptxas"] = ptxas
        if e["name"] == "block_attention_backward":
            e["ptxas"] = ptxas_bwd
        if e["name"] == "decode_attend_fused":
            e["zoo_shapes"] = zoo_b5

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
    details = json.dumps({"ptxas_b6": ptxas,
                          "ptxas_b6_backward": ptxas_bwd,
                          "micro_cases": micro_cases,
                          "build_plan_s": build_s,
                          "stage_s": stage_s,
                          "matvec_ms": matvec_ms,
                          "plan_bytes": plan_bytes, "n": n_main,
                          "max_nbr": max_nbr, "kept_tiles": kept,
                          "gamma": {o: {"exact": g[0], "score": g[1]}
                                    for o, g in gammas.items()},
                          "tsne": tsne, "meanshift": meanshift,
                          "plan_batch": plan_batch, "serve": serve,
                          "service": service, "stream": stream,
                          "solvers": solvers, "persist": persist,
                          "shard": shard, "zoo": zoo, "zoo_b": zoo_b,
                          "train": train, "mesh_train": mesh_train,
                          "dryrun": dry})
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
