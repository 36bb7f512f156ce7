"""Training launcher, the twin of the reference's ``launch/train.py``; it
runs on the card unless ``--device cpu`` is given.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
      --reduced --steps 50 --batch 8 --seq 128 --device cpu

One process trains on one device (training on a mesh is ROADMAP A14b).
The reference's TPU XLA flags have no counterpart. With ``--ckpt-dir`` the
loop runs under ``launch.ft.Supervisor``: ``{"params", "opt"}`` is saved
through the ``Checkpointer`` every ``--ckpt-every`` steps and at the end,
and a run started on a directory that holds a checkpoint resumes after
its latest step (the data pipeline regenerates the batches by step).
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch._device import resolve_device
from repro_torch.checkpoint.ckpt import Checkpointer
from repro_torch.configs import get_config, reduced_config
from repro_torch.data import pipeline
from repro_torch.launch.ft import Supervisor
from repro_torch.models import model_api
from repro_torch.models.param import count_params
from repro_torch.optim.optimizers import make_optimizer
from repro_torch.train import trainer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--backend", default="flash")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    opt = make_optimizer(cfg.optimizer, lr=args.lr,
                         warmup=max(args.steps // 20, 1), total=args.steps)
    step_fn, _ = trainer.make_train_step(cfg, mesh=None, backend=args.backend,
                                         microbatch=args.microbatch,
                                         optimizer=opt)

    params = model_api.init(
        cfg, torch.Generator(device=dev).manual_seed(args.seed), device=dev)
    opt_state = opt.init(params)
    print(f"arch={cfg.name} params={count_params(params) / 1e6:.2f}M "
          f"optimizer={cfg.optimizer} backend={args.backend} device={dev}")

    ckpt = Checkpointer(args.ckpt_dir) if args.ckpt_dir else None
    state = {"params": params, "opt": opt_state}

    def one_step(state, step):
        batch = pipeline.to_device(
            pipeline.token_batch(cfg, step, args.batch, args.seq, args.seed),
            dev)
        p, o, metrics = step_fn(state["params"], state["opt"], batch)
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss {float(metrics['loss']):.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f}")
        return {"params": p, "opt": o}

    def restore():
        restored, at = ckpt.restore(state, device=dev)
        print(f"resumed from the checkpoint of step {at}")
        return restored, at

    if ckpt:
        sup = Supervisor(step_deadline_s=3600)
        state = sup.run(
            n_steps=args.steps,
            make_state=lambda: state,
            step_fn=one_step,
            save=lambda s, st: ckpt.save(s, st),
            restore=restore,
            ckpt_every=args.ckpt_every or max(args.steps // 4, 1))
        ckpt.wait()
    else:
        t0 = time.time()
        for step in range(args.steps):
            state = one_step(state, step)
        dt = time.time() - t0
        tok = args.steps * args.batch * args.seq
        print(f"done: {dt:.1f}s, {tok / dt:.0f} tok/s")
    return state


if __name__ == "__main__":
    main()
