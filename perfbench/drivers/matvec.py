"""Traffic kind ``matvec``: the interaction loop of a plan's users.

Set-up builds the plan from the deployment's points (``api.build_plan``,
as the configuration states) and draws from the run's seed a pool of
``pool`` charge matrices (n, ``columns``) float32 on the card. The
window is a closed loop of ``plan.matvec`` over the pool in turn,
dispatched back to back, with a sync every ``sync_every`` calls and at
the end; ``matvec_ms`` is the window over the calls.

Answers checked: calls drawn from the seed among the first
``sample_span`` (those the window reached) and the last call; of each,
``sample_rows`` rows drawn from the seed, against the reference's own
``A X`` (``reference/knn.py``).
"""
from __future__ import annotations

import time
from typing import Dict

import torch

from perfbench.harness import gen, plans


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        self.cfg, self.tr = ctx.config, ctx.traffic

    def setup(self) -> None:
        ctx, tr = self.ctx, self.tr
        with ctx.phase("points"):
            self.x = plans.points(self.cfg, 0)
        with ctx.phase("build_plan"):
            self.plan = plans.build(self.cfg, self.x, ctx.device)
        self.counts = plans.storage_counts(self.plan)
        self.counts["f"] = tr["columns"]
        with ctx.phase("warm_up"):
            g = torch.Generator(device=ctx.device)
            g.manual_seed(gen.sub_seed(ctx.seed, 2))
            n = self.plan.n
            self.pool = torch.randn((tr["pool"], n, tr["columns"]),
                                    generator=g, device=ctx.device,
                                    dtype=torch.float32)
            for i in range(2 * tr["pool"]):
                self.plan.matvec(self.pool[i % tr["pool"]])
        self.keep = set(int(i) for i in gen.sample(
            ctx.seed, 3, tr["sample_span"], tr["sample_calls"]))
        self.kept: Dict[int, torch.Tensor] = {}

    def _sync(self) -> None:
        if self.ctx.device.type == "cuda":
            torch.cuda.synchronize(self.ctx.device)

    def window(self, seconds: float) -> Dict:
        plan, pool, tr = self.plan, self.pool, self.tr
        npool, every = tr["pool"], tr["sync_every"]
        i, y = 0, None
        t0 = time.perf_counter()
        while True:
            y = plan.matvec(pool[i % npool])
            if i in self.keep:
                self.kept[i] = y
            i += 1
            if i % every == 0:
                self._sync()
                if time.perf_counter() - t0 >= seconds:
                    break
        self._sync()
        window_s = time.perf_counter() - t0
        self.kept[i - 1] = y
        return {"units": i, "window_s": window_s,
                "matvec_ms": window_s / i * 1e3, "counts": self.counts}

    def traced_units(self) -> int:
        n = self.tr["traced_calls"]
        with torch.profiler.record_function("perfbench.matvec"):
            for i in range(n):
                self.plan.matvec(self.pool[i % self.tr["pool"]])
        return n

    def check(self):
        ctx = self.ctx
        dev = ctx.device
        x = torch.as_tensor(self.x, device=dev)
        del self.plan
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        rows = plans.sample_rows(self.cfg, self.tr, x, ctx.seed, 4)
        calls = sorted(self.kept)
        answers = [self.kept[i][rows] for i in calls]
        charges = [self.pool[i % self.tr["pool"]] for i in calls]
        errs = plans.compare(self.cfg, x, rows, answers, charges)
        lim = ctx.limits["matvec_rel_err"]
        failed = sum(e > lim for e in errs)
        return [("matvec_rel_err", max(errs), lim)], failed
