"""One run of one cell: set-up, the measured window, an optional traced
sub-window, the correctness check, and the result line.

A driver (``drivers/<kind>.py``) implements the traffic kind:

    Driver(ctx)            ctx: seed, config, traffic, cell, device
      .setup()             everything before the first timed unit: inputs
                           and weights from the seed, the program's objects,
                           warm-up of the cell's own shapes
      .window(seconds)     closed loop for ``seconds``; returns the record
                           (``units``, ``window_s``, and what metrics read)
      .traced_units()      a few more units for the profiler; returns
                           their count
      .check()             frees the program's state and compares what the
                           timed path produced with the plain reference;
                           returns ``(checks, failed)``, each check
                           ``(name, value, limit)``, passing when
                           ``value <= limit``
"""
from __future__ import annotations

import sys
import time
from contextlib import contextmanager
from typing import Any, Dict, List, Optional, Tuple

import torch

from perfbench.harness import registry, trace

# top-level module names that no process of the benchmark may hold: JAX,
# its libraries, the JAX package of this repository and its benchmarks
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")


def forbidden_modules() -> List[str]:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


class Context:
    def __init__(self, workload: str, seed: int, device: torch.device,
                 sizes: Optional[Dict[str, Any]] = None):
        self.workload = workload
        self.cell = registry.cell(workload)
        self.seed = int(seed)
        self.device = device
        self.config = dict(registry.config(self.cell["config"]))
        self.config.update(sizes or {})
        self.traffic = dict(registry.traffic(self.cell["traffic"]))
        self.traffic.update((sizes or {}).get("traffic", {}))
        self.limits = self.cell["limits"]
        self.setup_phases: Dict[str, float] = {}

    @contextmanager
    def phase(self, name: str):
        """Times one part of the set-up (drained at its end)."""
        t0 = time.perf_counter()
        yield
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.setup_phases[name] = (self.setup_phases.get(name, 0.0)
                                   + time.perf_counter() - t0)


def _say(msg: str) -> None:
    print(f"perfbench: {msg}", file=sys.stderr, flush=True)


def run(workload: str, seed: int, seconds: float, traced: bool,
        t_start: float, device: torch.device,
        sizes: Optional[Dict[str, Any]] = None,
        bench: Optional[Dict[str, Any]] = None,
        phases: Optional[Dict[str, float]] = None
        ) -> Tuple[Dict[str, Any], List[Tuple[str, float, float]]]:
    """Returns ``(result, checks)``: the result line's object, with the
    checks last, and the checks themselves. ``phases`` are the set-up's
    parts timed before the call (imports, the CUDA context)."""
    bench = bench or registry.benchmark()
    entry = {w["name"]: w for w in bench["workloads"]}.get(workload)
    if entry is None:
        raise KeyError(f"BENCHMARK.json has no workload {workload!r}")
    ctx = Context(workload, seed, device, sizes)
    for key in ("config", "traffic", "chips"):
        if ctx.cell[key] != entry[key]:
            raise ValueError(f"cells/{workload}.json says {key}="
                             f"{ctx.cell[key]!r}, BENCHMARK.json "
                             f"{entry[key]!r}")
    cuda = device.type == "cuda"
    ctx.setup_phases.update(phases or {})
    if cuda:
        with ctx.phase("kernel_load"):
            from repro_torch.kernels import _build
            _build.load()
    drv = registry.driver(ctx.traffic["kind"]).Driver(ctx)
    drv.setup()
    setup_peak = 0
    if cuda:
        torch.cuda.synchronize()
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    record = {"setup_s": time.perf_counter() - t_start}
    _say(f"set-up {record['setup_s']:.3f} s: " + ", ".join(
        f"{k} {v:.3f}" for k, v in ctx.setup_phases.items()))
    record.update(drv.window(seconds))
    _say(f"window {record['window_s']:.3f} s, {record['units']} units")
    if traced:
        record["trace"] = trace.traced(drv.traced_units)
        _say(f"traced {record['trace']['units']} units in "
             f"{record['trace']['window_s']:.3f} s, reduced in "
             f"{record['trace']['reduce_s']:.3f} s")
    peak = max(setup_peak, torch.cuda.max_memory_allocated()) if cuda else 0
    found = forbidden_modules()
    if found:
        raise RuntimeError("modules of JAX or of the JAX package are loaded: "
                           + ", ".join(found))
    t_check = time.perf_counter()
    checks, failed = drv.check()
    _say(f"check {time.perf_counter() - t_check:.3f} s")

    metrics = {}
    for m in registry.metrics_for(bench, workload, traced):
        value = registry.metric_reader(m["name"])(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    result: Dict[str, Any] = {
        "correct": all(v <= lim for _, v, lim in checks) and failed == 0,
        "attempted": int(record["units"]), "failed": int(failed),
        "metrics": metrics, "device": dev}
    if traced:
        tr = record["trace"]
        dev["busy_s"] = tr["busy_s"]
        dev["window_s"] = tr["window_s"]
        result["breakdown"] = {"device_ops": tr["device_ops"],
                               "idle_gaps": tr["idle_gaps"]}
    result["setup_phases"] = ctx.setup_phases
    result["checks"] = {name: {"value": v, "limit": lim}
                        for name, v, lim in checks}
    return result, checks
