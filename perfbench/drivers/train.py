"""Traffic kind ``train``: steps of the program's train step, back to back.

The configuration names its architecture (``archs/<architecture>.py``:
the program's model config, the parameter leaves, the counts) and its plain
reference (``reference``, a module of ``reference/``); nothing here is of
one architecture.

Set-up draws the weights from the seed on the card (``harness/weights``),
builds the program's train step (``trainer.make_train_step`` through the
configuration's attention backend, AdamW, ``microbatches`` slices of each
batch) and drives that one object through ``check_steps`` steps on fresh
batches (``harness/gen.token_batch``, steps 0, 1, ...): the warm-up, and
the steps the reference follows. It records each of those steps' loss,
each leaf's norm of the first step's gradient as the optimizer took it
(its first moment after one step over ``1 - b1``) and each leaf's norm of
its change after the last of them (its start drawn again from the seed).
The window then runs the same object on the next batches, each step ending
in the read of its loss; ``train_tokens_per_s`` is every token of the
window's steps over the window, ``train_peak_bytes`` the allocator's peak
over it.

The check frees the program's state and runs the plain reference through the same steps from the same seed, and
compares, by the worst leaf, the gap of the two gradient norms and of the
two change norms, each over the larger of the reference's norm of that
leaf and of the median leaf; and the worst step's loss gap over the
reference's loss. Leaves whose reference gradient is under a thousandth of
the median leaf's are left out of the change (they move by round-off).
A cell compares the numbers its ``limits`` name; the others are printed
on standard error and not compared.
"""
from __future__ import annotations

import sys
import time
from typing import Any, Dict, List

import numpy as np
import torch

from perfbench.harness import gen, registry, weights


def program_config(m: Dict[str, Any]):
    """The program's ``ModelConfig`` for the configuration file ``m``: its
    architecture's part (``archs/<architecture>.program_config``) and the
    keywords every architecture shares."""
    from repro_torch.configs.base import ClusterKVConfig
    ck, tr = m["clusterkv"], m["training"]
    common = dict(
        clusterkv=ClusterKVConfig(
            enabled=True, embed_dim=ck["embed_dim"], block_q=ck["block_q"],
            block_k=ck["block_k"], blocks_per_query=ck["blocks_per_query"],
            local_window_blocks=ck["local_window_blocks"]),
        optimizer=tr["optimizer"], remat=tr["remat"] == "full",
        remat_policy="full", loss_chunk=tr["loss_chunk"],
        dtype=tr["compute_dtype"], param_dtype=tr["param_dtype"],
        long_context=m["attention_backend"])
    return registry.arch(m["architecture"]).program_config(m, common)


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              skip=()) -> float:
    """The worst leaf's ``|prog - ref|`` over ``max(ref, median ref)``."""
    keys = [k for k in ref if k not in skip]
    med = float(np.median([ref[k] for k in keys]))
    return max(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-300)
               for k in keys)


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        self.m, self.tr = ctx.config, ctx.traffic
        self.leaves = registry.arch(self.m["architecture"]).leaves(self.m)
        self.names = ["/".join(p) for p, _, _ in self.leaves]

    def _batch(self, step: int) -> Dict[str, torch.Tensor]:
        b = gen.token_batch(self.m["vocab_size"], step, self.tr["sequences"],
                            self.tr["seq_len"], self.ctx.seed)
        dev = self.ctx.device
        out = {}
        for k, v in b.items():
            t = torch.from_numpy(v)
            out[k] = (t.pin_memory().to(dev, non_blocking=True)
                      if dev.type == "cuda" else t)
        return out

    def _tree_leaf(self, tree, i):
        return weights.get(tree, self.leaves[i][0])

    def setup(self) -> None:
        from repro_torch.models import model_api
        from repro_torch.optim.optimizers import make_optimizer
        from repro_torch.train import trainer

        ctx, m, tr = self.ctx, self.m, self.m["training"]
        dev = ctx.device
        cfg = program_config(m)
        with ctx.phase("weights"):
            self.params = weights.nest(
                (path, weights.leaf(ctx.seed, i, shape, kind, dev))
                for i, (path, shape, kind) in enumerate(self.leaves))
        want = model_api.param_shapes(cfg)
        for path, shape, _ in self.leaves:
            if tuple(weights.get(want, path).shape) != shape:
                raise ValueError(f"the program's leaf {'/'.join(path)} is "
                                 f"{tuple(weights.get(want, path).shape)}, "
                                 f"the configuration's {shape}")
        self.opt = make_optimizer(tr["optimizer"], lr=tr["lr"],
                                  warmup=tr["warmup"],
                                  total=tr["total_steps"])
        self.step, _ = trainer.make_train_step(
            cfg, None, m["attention_backend"],
            microbatch=self.tr["microbatches"], optimizer=self.opt)
        self.state = self.opt.init(self.params)
        self.losses: List[float] = []
        self.next_step = 0
        for s in range(self.tr["check_steps"]):
            with ctx.phase("first_step" if s == 0 else "check_steps"):
                self._one()
            if self.next_step == 1:
                b1 = self.opt.b1
                self.grad1 = {
                    n: float(self._tree_leaf(self.state["m"], i).double()
                             .norm()) / (1 - b1)
                    for i, n in enumerate(self.names)}
        self.change = {}
        with ctx.phase("change_norms"):
            for i, (path, shape, kind) in enumerate(self.leaves):
                start = weights.leaf(ctx.seed, i, shape, kind, dev)
                self.change[self.names[i]] = float(
                    (weights.get(self.params, path) - start).double().norm())
                del start
        self.check_losses = list(self.losses)

    def _one(self) -> float:
        batch = self._batch(self.next_step)
        self.params, self.state, met = self.step(self.params, self.state,
                                                 batch)
        loss = float(met["loss"])
        self.losses.append(loss)
        self.next_step += 1
        return loss

    def window(self, seconds: float) -> Dict:
        n = 0
        t0 = time.perf_counter()
        steps = []
        while True:
            t1 = time.perf_counter()
            self._one()
            steps.append(time.perf_counter() - t1)
            n += 1
            if time.perf_counter() - t0 >= seconds:
                break
        window_s = time.perf_counter() - t0
        print("perfbench: steps (s) " + " ".join(f"{s:.3f}" for s in steps),
              file=sys.stderr)
        tokens = n * self.tr["sequences"] * self.tr["seq_len"]
        peak = (torch.cuda.max_memory_allocated(self.ctx.device)
                if self.ctx.device.type == "cuda" else 0)
        return {"units": n, "window_s": window_s, "tokens": tokens,
                "train_tokens_per_s": tokens / window_s,
                "train_peak_bytes": peak,
                "shape": {"batch": self.tr["sequences"],
                          "seq": self.tr["seq_len"],
                          "microbatches": self.tr["microbatches"]},
                "model": self.m}

    def traced_units(self) -> int:
        n = self.tr["traced_steps"]
        for _ in range(n):
            with torch.profiler.record_function("perfbench.train_step"):
                self._one()
        return n

    def reference_readings(self, low=None) -> Dict[str, Any]:
        """The plain reference through the check steps from the seed
        (``low``: the control's precision), the reference module the
        configuration names (``reference``)."""
        ref = registry.reference(self.m["reference"])
        dev = self.ctx.device
        params = {path: weights.leaf(self.ctx.seed, i, shape, kind, dev)
                  for i, (path, shape, kind) in enumerate(self.leaves)}
        batches = [self._batch(s) for s in range(self.tr["check_steps"])]
        out = ref.train(self.m, params, batches,
                             self.tr["microbatches"], low=low)
        names = dict(zip([p for p, _, _ in self.leaves], self.names))
        return {"losses": out["losses"],
                "grad1": {names[k]: v for k, v in out["grad1"].items()},
                "change": {names[k]: v for k, v in out["change"].items()}}

    def free_program(self) -> None:
        del self.params, self.state, self.step, self.opt
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def readings(self, ref: Dict[str, Any]) -> Dict[str, float]:
        """The numbers compared: the program's recorded check steps
        against ``ref`` (``reference_readings``)."""
        med = float(np.median(list(ref["grad1"].values())))
        still = {k for k, v in ref["grad1"].items() if v < 1e-3 * med}
        if still:
            print("perfbench: leaves left out of the change (gradient under "
                  "1e-3 of the median leaf's): " + ", ".join(sorted(still)),
                  file=sys.stderr)
        loss = max(abs(a - b) / abs(b)
                   for a, b in zip(self.check_losses, ref["losses"]))
        return {"loss_rel_gap": loss,
                "grad1_leaf_gap": leaf_gaps(self.grad1, ref["grad1"]),
                "change_leaf_gap": leaf_gaps(self.change, ref["change"],
                                             still)}

    def check(self):
        self.free_program()
        got = self.readings(self.reference_readings())
        lim = self.ctx.limits
        checks = [(k, v, lim[k]) for k, v in got.items() if k in lim]
        rest = [f"{k} {v!r}" for k, v in got.items() if k not in lim]
        if rest:
            print("perfbench: read, not compared: " + ", ".join(rest),
                  file=sys.stderr)
        failed = sum(v > l for _, v, l in checks)
        return checks, failed
