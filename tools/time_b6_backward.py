"""Time B6's backward kernels one by one on one CUDA card.

    python3 tools/time_b6_backward.py [--root DIR] [--seed S] [--qwen-idx]

``--root`` names the checkout whose ``src/repro_torch`` is timed (default:
the one holding this script), so that two commits unpacked side by side are
timed by the same code in the same call: run it for each checkout in turn,
alternating, and compare the lines. At each layer shape of ``SHAPES`` (bf16,
causal, 16 of 32 key tiles of 128 drawn at random per query tile, as
``chip_smoke.py`` times the backward) it prints one JSON line:

* ``lists_ms``, ``order_ms``, ``dq_ms``, ``dkv_ms``: each launch of the
  backward timed alone by CUDA events (the median of three runs of 20
  launches after one to warm up); ``order_ms`` is null for a checkout
  whose backward has no key-tile order; ``backward_ms`` the whole op
  ``torch.ops.repro_torch.block_attention_backward``;
* ``tflops``: the operations the kernels issue to the tensor cores over
  ``dq_ms + dkv_ms``: ``2 bq bk (6 dh + 4 dv)`` a selected tile pair (S
  and dP in both kernels, dQ, dK and dV twice, as hi + lo);
* ``visits_max``, ``visits_mean``: the largest and the mean number of
  (query tile, query head) visits of one dK/dV block (one key tile of one
  kv head) for the timed ``idx``.

With ``--qwen-idx`` one more line gives the same visit counts for the
``idx`` that ``core.clusterkv.select_blocks`` returns in each layer of
Qwen2-0.5B's ClusterKV forward at its training microbatch (8 x 4096
tokens, random weights from ``--seed``): layer 0's and the largest ratio
of any layer.

Needs a CUDA card; exits 1 without one. Imports only ``torch`` and the
chosen checkout's ``repro_torch``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent.parent
# (name, B, Hq, Hkv, dh, dv) at S = 4096, as chip_smoke.B6_BWD_SHAPES
SHAPES = (("qwen2-0.5b", 8, 14, 2, 64, 64),
          ("llava-next-34b", 1, 56, 8, 128, 128),
          ("minicpm3-4b", 1, 40, 40, 96, 64))
S, TILE, N_SEL = 4096, 128, 16


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


def visit_counts(off: torch.Tensor, g: int) -> dict:
    """Visits of each dK/dV block: its key tile's list length times g."""
    n = (off[..., 1:] - off[..., :-1]).float() * g
    return {"visits_max": float(n.max()), "visits_mean": float(n.mean())}


def inputs(gen, b, hq, hkv, dh, dv, dev):
    q = torch.randn((b, hq, S, dh), generator=gen, device=dev).bfloat16()
    k = torch.randn((b, hkv, S, dh), generator=gen, device=dev).bfloat16()
    v = torch.randn((b, hkv, S, dv), generator=gen, device=dev).bfloat16()
    kpos = torch.stack([torch.randperm(S, generator=gen, device=dev)
                        for _ in range(b * hkv)]).reshape(b, hkv, S)
    idx = torch.argsort(torch.rand((b, hkv, S // TILE, S // TILE),
                                   generator=gen, device=dev),
                        dim=-1)[..., :N_SEL]
    return (q, k, v, kpos.to(torch.int32),
            torch.arange(S, dtype=torch.int32, device=dev),
            idx.to(torch.int32).contiguous())


def parent_stages(_build, k_ba, q, k, v, kpos, qpos, idx, out, stats, dout):
    """The launches of a backward that has no ``backward_stages`` (PR 28's:
    lists, dQ, dK/dV, no order) as calls of no argument."""
    b, hq, _, dh = q.shape
    hkv, dv = k.shape[1], v.shape[3]
    dq, dk, dvt = (torch.empty_like(q), torch.empty_like(k),
                   torch.empty_like(v))
    dsum = torch.empty((2, b, hq, S), dtype=torch.float32, device=q.device)
    lib, lists = _build.load(), {}
    dims = (b, hq, hkv, S, S, dh, dv, TILE, TILE, N_SEL, 1, 1)

    def run_lists():
        lists["off"], lists["ent"] = k_ba.key_tile_lists(idx, S // TILE)

    def run_dq():
        _build.check(lib.repro_block_attention_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), kpos.data_ptr(),
            qpos.data_ptr(), idx.data_ptr(), out.data_ptr(),
            stats.data_ptr(), dout.data_ptr(), dq.data_ptr(),
            dsum.data_ptr(), *dims, _build.current_stream()), "dq")

    def run_dkv():
        _build.check(lib.repro_block_attention_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), kpos.data_ptr(),
            qpos.data_ptr(), stats.data_ptr(), dsum.data_ptr(),
            dout.data_ptr(), lists["off"].data_ptr(),
            lists["ent"].data_ptr(), dk.data_ptr(), dvt.data_ptr(), *dims,
            _build.current_stream()), "dkv")

    return {"lists": run_lists, "dq": run_dq, "dkv": run_dkv}


def time_shape(k_ba, _build, gen, what, b, hq, hkv, dh, dv, dev):
    q, k, v, kpos, qpos, idx = inputs(gen, b, hq, hkv, dh, dv, dev)
    out, stats = torch.ops.repro_torch.block_attention_with_stats(
        q, k, v, kpos, qpos, idx, TILE, TILE, True)
    dout = torch.randn(tuple(out.shape), generator=gen,
                       device=dev).bfloat16()
    nkb = S // TILE
    if hasattr(k_ba, "backward_stages"):
        stages, _ = k_ba.backward_stages(q, k, v, kpos, qpos, idx, out,
                                         stats, dout, TILE, TILE, True)
    else:
        stages = parent_stages(_build, k_ba, q, k, v, kpos, qpos, idx, out,
                               stats, dout)
    for run in stages.values():
        run()
    row = {"config": what, "B": b, "hq": hq, "hkv": hkv, "dh": dh, "dv": dv,
           "S": S, "n_sel": N_SEL}
    for name in ("lists", "order", "dq", "dkv"):
        row[f"{name}_ms"] = (events_ms(stages[name]) if name in stages
                             else None)
    row["backward_ms"] = events_ms(lambda: k_ba.block_attention_backward(
        q, k, v, kpos, qpos, idx, out, stats, dout, bq=TILE, bk=TILE))
    off = k_ba.key_tile_lists_plain(idx, nkb)[0]
    pairs = b * hq * (S // TILE) * N_SEL
    issued = 2.0 * TILE * TILE * (6 * dh + 4 * dv) * pairs
    row["issued_gflop"] = issued / 1e9
    row["tflops"] = issued / ((row["dq_ms"] + row["dkv_ms"]) * 1e-3) / 1e12
    row.update(visit_counts(off, hq // hkv))
    return row


def qwen_idx_visits(seed: int, dev) -> dict:
    """Visit counts of the idx each layer's ``select_blocks`` returns in
    Qwen2-0.5B's ClusterKV forward at 8 x 4096 tokens."""
    from repro_torch.configs import get_config
    from repro_torch.core import clusterkv as ckv
    from repro_torch.data import pipeline
    from repro_torch.kernels import block_attention as k_ba
    from repro_torch.models import model_api
    from repro_torch.models.sharding import NO_SHARD

    cfg = get_config("qwen2-0.5b")
    params = model_api.init(cfg, torch.Generator(device=dev).manual_seed(
        seed), device=dev)
    batch = pipeline.to_device(pipeline.token_batch(cfg, 0, 8, S, seed), dev)
    seen, select = [], ckv.select_blocks

    def record(*a, **kw):
        idx = select(*a, **kw)
        seen.append(idx)
        return idx

    ckv.select_blocks = record
    try:
        with torch.no_grad():
            model_api.module_for(cfg).loss_fn(params, cfg, batch,
                                              "clusterkv", NO_SHARD)
    finally:
        ckv.select_blocks = select
    g = cfg.n_heads // cfg.n_kv_heads
    layers = [visit_counts(k_ba.key_tile_lists_plain(i.cpu(), S // TILE)[0],
                           g) for i in seen]
    worst = max(layers, key=lambda r: r["visits_max"] / r["visits_mean"])
    return {"config": "qwen2-0.5b select_blocks idx", "layers": len(layers),
            "layer0": layers[0], "worst_layer": worst,
            "idx_shape": list(seen[0].shape)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", type=Path, default=HERE)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--qwen-idx", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(args.root.resolve() / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels import block_attention as k_ba

    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    _build.load()
    gen = torch.Generator(device=dev).manual_seed(args.seed + 185)
    for shape in SHAPES:
        row = time_shape(k_ba, _build, gen, *shape, dev)
        row.update(root=str(args.root), card=card)
        print(json.dumps(row), flush=True)
        torch.cuda.empty_cache()
    if args.qwen_idx:
        row = qwen_idx_visits(args.seed, dev)
        row.update(root=str(args.root), card=card)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
