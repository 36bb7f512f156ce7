"""Time the port's ClusterKV decode path on one CUDA card.

    python3 tools/time_decode.py [--root DIR] [--steps N] [--seed S]

``--root`` names the checkout whose ``src/repro_torch`` is timed (default:
the one holding this script), so that an older commit unpacked beside the
tree is timed by the same code in the same call: run it for each checkout
in turn, alternating, and compare the lines. It prints one JSON line:

* ``b5``: the decode kernel wrapper
  ``kernels.decode_attend.decode_attend_fused`` at the serving tick's
  shape (4 slots, 2 kv heads, g = 7, S = 8192, 16 tiles of 128, plan mode)
  and at the scalar ``decode_step``'s (1 slot, S = 4096, plain mode), bf16,
  each timed three ways: ``call_ms``, the median of three runs of 200
  calls back to back by CUDA events (what the serving path pays per call);
  ``device_ms``, one call captured as a CUDA graph and replayed (the
  launches' device time without the host's); ``host_ms``, the host clock
  around the same 200 calls before the card is waited for (the host's
  time to issue one call);
* ``decode_step``: the scalar-position ``models.transformer.decode_step``
  of Qwen2-0.5B at full width (random weights from ``--seed``, bf16) over
  a 2048-token prompt in a 4096-slot cache, ``--steps`` steps after 4
  warm-up steps, each step waited for and timed by the host clock: the
  median and every step.

Needs a CUDA card; exits 1 without one. Imports only ``torch`` and the
chosen checkout's ``repro_torch``.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent.parent


def events_ms(fn, iters: int) -> float:
    """Median of three runs of ``iters`` calls, CUDA events, after one
    call to warm up."""
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


def host_ms(fn, iters: int) -> float:
    """Median of three runs: host clock around ``iters`` calls, stopped
    before the card is waited for."""
    runs = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        runs.append((time.perf_counter() - t0) * 1e3 / iters)
        torch.cuda.synchronize()
    return sorted(runs)[1]


def graph_ms(fn, iters: int) -> float:
    """Device time of one call of ``fn``: captured once, replayed."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return events_ms(graph.replay, iters)


def b5_inputs(gen, b, s, plan_mode, dev):
    """bf16 caches of Qwen2-0.5B's attention (2 kv heads of 64, g = 7):
    plan order (whole tiles shuffled) with the centroids in float32 as the
    plan service keeps them, or time order with bf16 centroids as
    ``clusterkv_decode`` makes them."""
    from repro_torch.core.clusterkv import block_centroids
    hkv, g, dh, bk = 2, 7, 64, 128
    bf = torch.bfloat16
    q = torch.randn((b, hkv * g, dh), generator=gen, device=dev).to(bf)
    k = torch.randn((b, hkv, s, dh), generator=gen, device=dev).to(bf)
    v = torch.randn((b, hkv, s, dh), generator=gen, device=dev).to(bf)
    if plan_mode:
        order = torch.argsort(torch.rand((b, hkv, s // bk), generator=gen,
                                         device=dev), dim=-1)
        pos = (order[..., None] * bk + torch.arange(bk, device=dev)
               ).reshape(b, hkv, s)
        cent = block_centroids(k.float(), bk)
        qpos = torch.tensor([s - 1, s // 2, s // 3, s // 4][:b],
                            dtype=torch.int32, device=dev)
    else:
        pos = torch.arange(s, device=dev).expand(b, hkv, s)
        cent = block_centroids(k, bk)
        qpos = torch.tensor(s // 2 + 5, dtype=torch.int32, device=dev)
    return q, k, v, pos.to(torch.int32).contiguous(), cent, qpos


def time_b5(dev, seed: int) -> dict:
    from repro_torch.kernels import decode_attend as k_da
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = {}
    for name, b, s, plan_mode in (("tick", 4, 8192, True),
                                  ("scalar_step", 1, 4096, False)):
        q, k, v, pos, cent, qpos = b5_inputs(gen, b, s, plan_mode, dev)
        kw = dict(n_sel=16, bk=128)
        if plan_mode:
            kw.update(plan_mode=True, has_self=False, window=128)

        def run():
            return k_da.decode_attend_fused(q, k, v, pos, cent, qpos, **kw)

        out[name] = {"shape": f"B={b} Hkv=2 g=7 S={s} n_sel=16 bf16 "
                              f"{'plan' if plan_mode else 'plain'} mode",
                     "call_ms": events_ms(run, 200),
                     "host_ms": host_ms(run, 200),
                     "device_ms": graph_ms(run, 200)}
    return out


def time_decode_step(dev, seed: int, steps: int) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.models import model_api
    from repro_torch.models import transformer as tf
    cfg = get_config("qwen2-0.5b")
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = model_api.init(cfg, gen, device=dev)
    plen, warm = 2048, 4
    toks = torch.randint(0, cfg.vocab, (1, plen), generator=gen,
                         device=dev)
    cache, logits = tf.prefill(params, cfg, {"tokens": toks}, "clusterkv")
    cache = model_api.grow_cache(cfg, cache, 2 * plen)
    nxt = logits.argmax(-1)[:, None]
    torch.cuda.synchronize()
    ms = []
    for i in range(warm + steps):
        t0 = time.perf_counter()
        logits, cache = tf.decode_step(params, cfg, cache, nxt, "clusterkv")
        nxt = logits.argmax(-1)[:, None]
        torch.cuda.synchronize()
        if i >= warm:
            ms.append((time.perf_counter() - t0) * 1e3)
    if not torch.isfinite(logits).all():
        raise AssertionError("decode_step: non-finite logits")
    return {"prompt": plen, "cache": 2 * plen, "steps": steps,
            "median_ms": statistics.median(ms), "step_ms": ms}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path, default=HERE)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_decode: no CUDA card", file=sys.stderr)
        return 1
    root = args.root.resolve()
    sys.path.insert(0, str(root / "src"))
    import repro_torch
    if Path(repro_torch.__file__).resolve().parent != root / "src" / \
            "repro_torch":
        raise AssertionError(f"imported {repro_torch.__file__}, not {root}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()
    dev = torch.device("cuda", 0)
    result = {"root": str(root), "card": smi[0] if smi else None}
    result["decode_step"] = time_decode_step(dev, args.seed, args.steps)
    result["b5"] = time_b5(dev, args.seed)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
