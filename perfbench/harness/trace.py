"""A traced sub-window: ``torch.profiler`` (CPU and CUDA activity) around a
few units of a cell's work, reduced to what the per-layer metrics read.

The reduction:

* ``kernels``: every device operation (kernels, copies, fills) by name,
  its summed seconds and its count;
* ``busy_s``: the union of the device operations' intervals inside the
  traced window, so overlapping operations count once;
* ``window_s``: the traced window's length (the span ``perfbench.window``
  that wraps the units);
* ``device_ops``: the ten device operations that took most time;
* ``idle_gaps``: the ten longest stretches with no device operation, each
  named by the innermost ``perfbench.*`` span and the innermost host
  operation running at its middle.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Tuple

import torch

WINDOW = "perfbench.window"


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def _label(t: float, host: List[Tuple[float, float, str]]) -> str:
    """The innermost perfbench span and host operation running at ``t``
    (the middle of an idle stretch)."""
    span, op, span_t0, op_t0 = "-", "no torch op (Python, numpy)", -1.0, -1.0
    for a, b, name in host:
        if a <= t < b:
            if name.startswith("perfbench."):
                if a >= span_t0:
                    span, span_t0 = name, a
            elif a >= op_t0:
                op, op_t0 = name, a
    return f"{span} / {op}"


def _events(prof):
    """(name, on the device, a span, start us, end us) of every recorded
    event, from the profiler's raw results (``prof.events()`` builds an
    event tree, which takes minutes for a training step)."""
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        a = e.start_ns() / 1e3
        yield (e.name(), e.device_type() == cuda, e.is_user_annotation(),
               a, a + e.duration_ns() / 1e3)


def traced(run_units: Callable[[], int]) -> Dict:
    """Runs ``run_units`` (which returns the number of units it ran) under
    the profiler and returns the reduction above."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW):
            units = run_units()
            torch.cuda.synchronize()
    t_red = time.perf_counter()
    dev: List[Tuple[float, float, str]] = []
    host: List[Tuple[float, float, str]] = []
    w0 = w1 = None
    for name, on_device, annotation, a, b in _events(prof):
        if on_device:
            if not annotation:           # the spans' device-side copies
                dev.append((a, b, name))
        else:
            host.append((a, b, name))
            if name == WINDOW:
                w0, w1 = a, b
    if w0 is None or not dev:
        raise RuntimeError("the profiler recorded no device operation in "
                           "the traced window (CUPTI unavailable?)")
    kernels: Dict[str, List[float]] = {}
    for a, b, name in dev:
        k = kernels.setdefault(name, [0.0, 0])
        k[0] += (b - a) * 1e-6
        k[1] += 1
    busy = _union([(max(a, w0), min(b, w1)) for a, b, _ in dev
                   if b > w0 and a < w1])
    busy_s = sum(b - a for a, b in busy) * 1e-6
    gaps = []
    prev = w0
    for a, b in busy + [(w1, w1)]:
        if a > prev:
            gaps.append((a - prev, (a + prev) / 2))
        prev = max(prev, b)
    gaps.sort(reverse=True)
    idle = [[_label(mid, host), dur * 1e-6] for dur, mid in gaps[:10]]
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:10]
    return {"units": units, "window_s": (w1 - w0) * 1e-6, "busy_s": busy_s,
            "kernels": kernels,
            "device_ops": [[name, v[0]] for name, v in top],
            "idle_gaps": idle,
            "reduce_s": time.perf_counter() - t_red}


def kernel_seconds(summary: Dict, fragments) -> Tuple[float, int]:
    """(seconds, launches) of the device operations whose name holds one
    of ``fragments``."""
    s, n = 0.0, 0
    for name, (sec, count) in summary["kernels"].items():
        if any(f in name for f in fragments):
            s += sec
            n += count
    return s, n
