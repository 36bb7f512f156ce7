"""Traffic kind ``build``: time to plan.

Set-up makes the deployment's ``point_sets`` point sets (the same in
every run), each a host array as users hand one over, and builds one plan
to warm up. The window is a closed loop of ``api.build_plan`` over the
sets in turn, starting at the set the run's seed names; ``build_s`` is
the window over the builds. Each build's own stage timings (``knn``,
``embedding``, ``tree``, ``build_bsr``: the program drains the card at
each stage's end) are kept for the per-layer metrics, and show that
nothing is reused from one build to the next.

Answers checked: the first build of the window, one drawn from the seed
among the next ``sample_span`` that the window reached, and the last. Of
each, the ordering must be a bijection, and the plan's product with
``probe_columns`` charges drawn from the seed, at ``sample_rows`` rows
drawn from the seed, must match the reference's ``A X`` computed from the
points alone: that holds the kNN pattern, the values and the storage
(every edge in a kept tile once).
"""
from __future__ import annotations

import sys
import time
from typing import Dict, List

import torch

from perfbench.harness import gen, plans

class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        self.cfg, self.tr = ctx.config, ctx.traffic

    def setup(self) -> None:
        ctx = self.ctx
        with ctx.phase("points"):
            self.sets = [plans.points(self.cfg, i)
                         for i in range(self.tr["point_sets"])]
        self.first = ctx.seed % len(self.sets)
        with ctx.phase("warm_up"):
            plans.build(self.cfg, self._set(-1), ctx.device)
        pick = 1 + int(gen.sample(ctx.seed, 5, self.tr["sample_span"], 1)[0])
        self.keep = {0, pick}
        self.kept: Dict[int, object] = {}
        self.stages: List[Dict[str, float]] = []

    def _sync(self) -> None:
        if self.ctx.device.type == "cuda":
            torch.cuda.synchronize(self.ctx.device)

    def _set(self, i: int):
        return self.sets[(self.first + i) % len(self.sets)]

    def _build(self, i: int):
        plan = plans.build(self.cfg, self._set(i), self.ctx.device)
        self.stages.append(dict(plan.host.timings))
        return plan

    def window(self, seconds: float) -> Dict:
        i, plan = 0, None
        t0 = time.perf_counter()
        while True:
            plan = self._build(i)
            if i in self.keep:
                self.kept[i] = plan
            i += 1
            if time.perf_counter() - t0 >= seconds:
                break
        self._sync()
        window_s = time.perf_counter() - t0
        self.kept[i - 1] = plan
        for j, st in enumerate(self.stages):
            print(f"perfbench: build {j}: " + ", ".join(
                f"{k} {v:.3f}" for k, v in st.items()), file=sys.stderr)
        return {"units": i, "window_s": window_s, "build_s": window_s / i,
                "stages": list(self.stages)}

    def traced_units(self) -> int:
        n = self.tr["traced_builds"]
        for i in range(n):
            with torch.profiler.record_function("perfbench.build"):
                self._build(i)
        return n

    def check(self):
        ctx = self.ctx
        dev = ctx.device
        g = torch.Generator(device=dev)
        g.manual_seed(gen.sub_seed(ctx.seed, 6))
        n = self.cfg["n_points"]
        probe = torch.randn((n, self.tr["probe_columns"]), generator=g,
                            device=dev, dtype=torch.float32)
        results = []
        for i in sorted(self.kept):
            plan = self.kept.pop(i)
            pi = plan.pi
            bijective = bool(torch.equal(
                torch.sort(pi).values, torch.arange(n, device=pi.device)))
            results.append((i, bijective, plan.matvec(probe)))
            del plan, pi
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        errs, failed = [], 0
        lim = ctx.limits["build_rel_err"]
        for i, bijective, y in results:
            x = torch.as_tensor(self._set(i), device=dev)
            rows = plans.sample_rows(self.cfg, self.tr, x, ctx.seed, 7 + i)
            err = plans.compare(self.cfg, x, rows, [y[rows]], [probe])[0]
            errs.append(err)
            failed += (not bijective) or err > lim
        bad = float(sum(not b for _, b, _ in results))
        return [("build_rel_err", max(errs), lim),
                ("orderings_not_bijective", bad, 0.0)], failed
