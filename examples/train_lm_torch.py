"""Train a small LM end-to-end with the PyTorch port's full stack
(config -> data pipeline -> train step -> checkpoint -> restart): the twin
of ``examples/train_lm.py``. Runs on the card unless ``--device cpu``.

  PYTHONPATH=src python examples/train_lm_torch.py [--steps 60] [--device cpu]

Uses the qwen2 family at reduced size; demonstrates checkpoint/restart by
stopping the loop halfway and resuming from the checkpoint (the
fault-tolerance contract).
"""
import argparse
import shutil
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch

from repro_torch._device import resolve_device
from repro_torch.checkpoint.ckpt import Checkpointer
from repro_torch.configs import reduced_config
from repro_torch.data import pipeline
from repro_torch.models import model_api
from repro_torch.models.param import count_params
from repro_torch.optim.optimizers import make_optimizer
from repro_torch.train import trainer


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda)")
    args = ap.parse_args()
    dev = resolve_device(args.device)

    cfg = reduced_config("qwen2-0.5b").with_(n_layers=4, d_model=128,
                                             d_ff=512, n_heads=8,
                                             n_kv_heads=4)
    opt = make_optimizer("adamw", lr=1e-3, warmup=10, total=args.steps)
    step, _ = trainer.make_train_step(cfg, None, "flash", optimizer=opt)

    def fresh():
        return model_api.init(cfg, torch.Generator(device=dev).manual_seed(0),
                              device=dev)

    params = fresh()
    opt_state = opt.init(params)
    print(f"params: {count_params(params) / 1e6:.2f}M on {dev}")

    tmp = tempfile.mkdtemp()
    ck = Checkpointer(tmp, keep=2)
    losses = []

    def run(params, opt_state, start, stop):
        for s in range(start, stop):
            batch = pipeline.to_device(
                pipeline.token_batch(cfg, s, args.batch, args.seq), dev)
            params, opt_state, m = step(params, opt_state, batch)
            losses.append(float(m["loss"]))
            if s % 10 == 0:
                print(f"step {s:4d} loss {losses[-1]:.4f}")
        return params, opt_state

    half = args.steps // 2
    params, opt_state = run(params, opt_state, 0, half)
    ck.save(half - 1, {"p": params, "o": opt_state}, blocking=True)
    print(f"-- simulated failure at step {half}; restoring from checkpoint --")
    del params, opt_state
    like = fresh()
    restored, at = ck.restore({"p": like, "o": opt.init(like)}, device=dev)
    params, opt_state = restored["p"], restored["o"]
    params, opt_state = run(params, opt_state, at + 1, args.steps)

    first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    print(f"loss {first:.3f} -> {last:.3f}")
    assert last < first, "training failed to reduce loss"
    shutil.rmtree(tmp, ignore_errors=True)
    print("OK: trained through a simulated failure with exact resume")


if __name__ == "__main__":
    main()
