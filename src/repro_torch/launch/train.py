"""Training launcher, the twin of the reference's ``launch/train.py``; it
runs on the card unless ``--device cpu`` is given.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
      --reduced --steps 50 --batch 8 --seq 128 --device cpu

Without ``--mesh`` one process trains on one device. With ``--mesh
DATA,MODEL`` the run trains on a ("data", "model") process mesh, one
process per device, e.g. on a machine with N cards:

  PYTHONPATH=src torchrun --nproc_per_node N -m repro_torch.launch.train \
      --arch qwen2-0.5b --mesh D,M          # D * M == N

The launcher joins the process group ``torchrun`` describes in the
environment (``nccl`` on cards, ``gloo`` with ``--device cpu``) unless the
caller has already initialized one, places parameters, optimizer state
and batches on the mesh (``--layout`` picks the logical-axis layout) and
trains through ``make_train_step(mesh=)``; rank 0 prints and writes the
checkpoints. The reference's TPU XLA flags have no counterpart.

With ``--ckpt-dir`` the loop runs under ``launch.ft.Supervisor``:
``{"params", "opt"}`` is saved through the ``Checkpointer`` every
``--ckpt-every`` steps and at the end, and a run started on a directory
that holds a checkpoint resumes after its latest step (the data pipeline
regenerates the batches by step); on a mesh the restore places every
leaf on the current mesh, whatever mesh saved it.
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
from repro_torch.models.sharding import set_layout, shardings_for
from repro_torch.optim.optimizers import make_optimizer
from repro_torch.train import trainer


def _join_mesh(spec: str, device: torch.device):
    """The ("data", "model") process mesh of ``--mesh DATA,MODEL``,
    joining the process group of the environment (``torchrun``) when none
    is initialized."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_process_mesh

    shape = tuple(int(n) for n in spec.split(","))
    if len(shape) != 2:
        raise ValueError(f"--mesh takes DATA,MODEL, got {spec!r}")
    if not dist.is_initialized():
        dist.init_process_group(
            "nccl" if device.type == "cuda" else "gloo", init_method="env://")
    return init_process_mesh(shape, ("data", "model"), device)


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
    ap.add_argument("--mesh", default=None, metavar="DATA,MODEL",
                    help="train on a (data, model) process mesh")
    ap.add_argument("--layout", default="2d",
                    help="logical-axis layout on the mesh (models.sharding)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    mesh = None
    if args.mesh:
        set_layout(args.layout)
        mesh = _join_mesh(args.mesh, dev)
        dev = resolve_device(args.device)     # the rank's own card
    lead = mesh is None or mesh.device_mesh.get_rank() == 0

    def say(*a):
        if lead:
            print(*a)

    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    opt = make_optimizer(cfg.optimizer, lr=args.lr,
                         warmup=max(args.steps // 20, 1), total=args.steps)
    step_fn, _ = trainer.make_train_step(cfg, mesh=mesh, backend=args.backend,
                                         microbatch=args.microbatch,
                                         optimizer=opt)

    params = model_api.init(
        cfg, torch.Generator(device=dev).manual_seed(args.seed), device=dev)
    n_params = count_params(params)
    opt_state = opt.init(params)
    if mesh is not None:
        params, opt_state = trainer.place_train_state(cfg, mesh, opt, params,
                                                      opt_state)
    where = f"device={dev}" if mesh is None else \
        f"mesh={mesh.shape} layout={args.layout} device={dev}"
    say(f"arch={cfg.name} params={n_params / 1e6:.2f}M "
        f"optimizer={cfg.optimizer} backend={args.backend} {where}")

    ckpt = Checkpointer(args.ckpt_dir) if args.ckpt_dir else None
    state = {"params": params, "opt": opt_state}

    def one_step(state, step):
        batch = pipeline.to_device(
            pipeline.token_batch(cfg, step, args.batch, args.seq, args.seed),
            dev)
        p, o, metrics = step_fn(state["params"], state["opt"], batch)
        if step % args.log_every == 0 or step == args.steps - 1:
            say(f"step {step:5d} loss {float(metrics['loss']):.4f} "
                f"gnorm {float(metrics['grad_norm']):.3f}")
        return {"params": p, "opt": o}

    def restore():
        if mesh is None:
            restored, at = ckpt.restore(state, device=dev)
        else:
            restored, at = ckpt.restore(state, shardings={
                "params": shardings_for(
                    state["params"], model_api.param_specs(cfg), mesh),
                "opt": shardings_for(
                    state["opt"],
                    opt.state_specs(model_api.param_specs(cfg)), mesh)})
        say(f"resumed from the checkpoint of step {at}")
        return restored, at

    def save(step, st):
        if mesh is None:
            ckpt.save(step, st)
            return
        # every rank gathers, rank 0 writes; all see the step once written
        ckpt.save(step, st, blocking=True)
        torch.distributed.barrier()

    if ckpt:
        sup = Supervisor(step_deadline_s=3600)
        state = sup.run(
            n_steps=args.steps,
            make_state=lambda: state,
            step_fn=one_step,
            save=save,
            restore=restore,
            ckpt_every=args.ckpt_every or max(args.steps // 4, 1))
        ckpt.wait()
    else:
        t0 = time.time()
        for step in range(args.steps):
            state = one_step(state, step)
        dt = time.time() - t0
        tok = args.steps * args.batch * args.seq
        say(f"done: {dt:.1f}s, {tok / dt:.0f} tok/s")
    return state


if __name__ == "__main__":
    main()
