"""Serving launcher: prefill a batch of prompts, then decode with batched
steps, optionally with the paper's cluster-sparse KV selection. The twin
of the reference's ``launch/serve.py``; it runs on the card unless
``--device cpu`` is given.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \\
      --reduced --prompt-len 256 --gen 32 --batch 4 --backend clusterkv

Every family is served by the one-shot loop (:func:`generate`): one
``prefill``, the cache grown to ``prompt + gen`` along each entry's
sequence axis (``model_api.grow_cache``), then ``gen - 1`` greedy
``decode_step``s at a scalar position. The ``ssm``, ``hybrid`` and
``encdec`` families have no continuous-batching engine, as in the
reference, so this is their serving entry point:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b \\
      --backend clusterkv --prompt-len 3968 --gen 128

``--service`` routes through the ClusterKV decode service instead: a
continuous-batching engine with plan-cached sessions (``--mode plan``) or
the per-call Morton-sort baseline (``--mode percall``), printing the
service's JSON report:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \\
      --reduced --backend clusterkv --service --slots 4 --batch 8 \\
      --gen 32 --report report.json
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.configs import get_config, reduced_config
from repro_torch.models import model_api


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(cfg, params, batch: Dict[str, torch.Tensor], gen: int,
             backend: str = "flash", *,
             embed_gen: Optional[torch.Generator] = None,
             timings: Optional[dict] = None) -> torch.Tensor:
    """Greedy generation of ``gen`` tokens after the prompt ``batch``:
    ``prefill``, the cache grown to ``prompt + gen``, then ``gen - 1``
    ``decode_step``s, each fed the previous step's argmax. A vlm model
    (embedding inputs) continues from (B, 1, d) bf16 embeddings drawn from
    ``embed_gen``. Returns the tokens (B, gen).

    ``timings``, when given, receives ``prefill_s`` (the prefill and the
    cache growth) and ``step_s`` (one entry a decode step), each timed on
    the host clock around work that ends in a device sync."""
    mod = model_api.module_for(cfg)
    prompt = batch["tokens"] if "tokens" in batch else batch["embeddings"]
    dev = prompt.device
    b, s = prompt.shape[:2]
    t0 = time.perf_counter()
    cache, logits = mod.prefill(params, cfg, batch, backend)
    cache = model_api.grow_cache(cfg, cache, s + gen)
    toks = logits.argmax(-1)[:, None]
    if timings is not None:
        _sync(dev)
        timings["prefill_s"] = time.perf_counter() - t0
        timings["step_s"] = []
    outs = [toks]
    for _ in range(gen - 1):
        t0 = time.perf_counter()
        if cfg.family == "vlm":
            step_in = torch.randn((b, 1, cfg.d_model), generator=embed_gen,
                                  device=dev).to(torch.bfloat16)
        else:
            step_in = toks
        logits, cache = mod.decode_step(params, cfg, cache, step_in,
                                        backend)
        toks = logits.argmax(-1)[:, None]
        outs.append(toks)
        if timings is not None:
            _sync(dev)
            timings["step_s"].append(time.perf_counter() - t0)
    return torch.cat(outs, dim=1)


def run_service(cfg, params, args, device=None) -> dict:
    """Decode ``args.batch`` synthetic prompts through the ClusterKV
    decode service; returns (and optionally writes) the service report."""
    from repro_torch.serve import ClusterKVEngine
    from repro_torch.train.serve_loop import Request

    engine = ClusterKVEngine(cfg, params, slots=args.slots,
                             max_seq=args.max_seq,
                             prefill_bucket=args.prefill_bucket,
                             mode=args.mode, device=device)
    rng = np.random.default_rng(args.seed)
    for i in range(args.batch):
        plen = int(rng.integers(args.prompt_len // 2, args.prompt_len + 1))
        engine.submit(Request(
            rid=i, tokens=rng.integers(0, cfg.vocab, plen).astype(np.int32),
            max_new=args.gen))
    engine.run()
    report = engine.report()
    print(json.dumps(report, indent=2))
    if args.report:
        with open(args.report, "w") as f:
            json.dump(report, f, indent=2)
    return report


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--prompt-len", type=int, default=256)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--backend", default="flash")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--service", action="store_true",
                    help="route through the ClusterKV decode service")
    ap.add_argument("--mode", default="plan", choices=("plan", "percall"))
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=512)
    ap.add_argument("--prefill-bucket", type=int, default=64)
    ap.add_argument("--report", default=None,
                    help="write the service JSON report here")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = model_api.init(cfg, gen, device=dev)

    if args.service:
        return run_service(cfg, params, args, device=dev)

    batch = model_api.make_small_batch(cfg, gen, args.batch, args.prompt_len,
                                       kind="prefill", device=dev)
    timings = {}
    out = generate(cfg, params, batch, args.gen, args.backend,
                   embed_gen=gen, timings=timings)
    pre, dec = timings["prefill_s"], sum(timings["step_s"])
    print(f"arch={cfg.name} backend={args.backend} device={dev}")
    print(f"prefill: {pre:.2f}s ({args.batch * args.prompt_len / pre:.0f} "
          f"tok/s)")
    print(f"decode:  {dec:.2f}s "
          f"({args.batch * (args.gen - 1) / max(dec, 1e-9):.0f} tok/s)")
    print("sample tokens:", out[0][:16].cpu().numpy())
    return out


if __name__ == "__main__":
    main()
