"""Spans and counters inside the port, on the clock of ``torch.profiler``.

An operator turns tracing on for a block of work and reads what it
recorded when the block closes:

    from repro_torch import trace

    with trace.recording() as rec:
        plan = api.build_plan(x, device="cuda")
        for _ in range(100):
            plan.matvec(charges)
    rec.spans       # Span(name, start_ns, end_ns, parent, root, thread)
    rec.self_ns()   # each span's duration less what its children cover
    rec.counters    # {"b6.pairs_selected": ..., "b6.pairs_live": ...}

Run under ``torch.profiler.profile``, every span also stands in the
profiler's trace as a host event of its name (a ``record_function``), so
the trace shows which program step launched each device operation and
which one the host was in while the device sat idle. The program does
not reduce the trace itself: that is the reader's (the benchmark's).

Times are nanoseconds on the profiler's clock (the Unix epoch), so the
program's spans and the device's operations lie on one timeline.
``parent`` and ``root`` index ``rec.spans``. A span opened on a thread
with no open span of its own (autograd's device thread running a
backward) takes as parent the latest-opened span still open on any
thread. The ``root`` is one request: one ``plan.build``, one
``plan.matvec``, one ``train.step``. Spans and counters stay in memory;
nothing is written unless the caller writes it.

Off (the default, and outside ``recording()``) ``span`` returns one shared
object whose ``with`` does nothing, and ``count`` / ``count_device``
return at once: no allocation, no clock read, no tensor op.

The port's spans (a child indented under its parent). Each groups
several device operations, or host work that no kernel name separates:

    plan.build                      api.build_plan
      build.knn, build.values, build.embedding, build.tree,
      build.ordering, build.apply_ordering
      build.bsr                     the storage stage
        bsr.layout                  core.blocksparse: host ELL layout
        bsr.fill                    tiles filled on the device
    plan.matvec                     InteractionPlan.matvec; its own time
      plan.permute, plan.unpermute  holds the backend's call (B1 on a card)
    train.step                      train.trainer.make_train_step's step
      train.microbatch              forward and autograd.grad
      train.accumulate, train.optimizer
    ckv.attention                   models.attention.clusterkv_attention;
      ckv.cluster_perm              its own time holds B6's forward
        ckv.pca                     core.clusterkv.cluster_perm: the keys'
                                    embedding and Morton codes
                                    (ops.cluster_codes: one kernel launch
                                    on a card)
        ckv.morton_sort             the stable argsort of the codes
      ckv.permute_kv
      ckv.select                    centroids, tile bounds, select_blocks
    b6.backward                     B6's CUDA backward (four launches)

The ``build.*`` spans other than ``build.values`` and
``build.apply_ordering`` are ``api._stage``'s, which also fills
``plan.host.timings``. Counters: ``b6.pairs_selected`` (query-head tile
pairs ClusterKV handed B6), ``b6.pairs_live`` (those whose key tile
holds a key at or before the query tile's last position: the pairs
causality leaves any work in) and ``ckv.order_sets`` (key sets the
ordering kernel embedded and coded, one per (batch, head) a launch; none
on the CPU, where the plain version runs). Set against the sets a step's
shapes give (a minicpm3-4b training step at 8k: 21 layers x 2
microbatches x 2 with remat x 40 heads = 3 360), ``ckv.order_sets`` shows
that every ClusterKV key set of the step went through the kernel, which
the kernel's name in a trace does not. Under remat the recompute records
``ckv.*`` and the counters a second time.
"""
from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Dict, Iterator, List, NamedTuple, Optional

import torch


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    parent: Optional[int]   # index into Recording.spans; None for a root
    root: int
    thread: int             # threading.get_ident() of the opening thread


class _Off:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()
_rec: Optional["Recording"] = None


class _On:
    __slots__ = ("_rec", "_name", "_entry", "_i", "_rf")

    def __init__(self, rec: "Recording", name: str):
        self._rec, self._name = rec, name

    def __enter__(self):
        rec = self._rec
        stack = rec._stack()
        with rec._lock:
            i = len(rec._raw)
            up = stack[-1] if stack else (max(rec._live) if rec._live
                                          else None)
            root = i if up is None else rec._raw[up][4]
            self._entry = [self._name, 0, 0, up, root, threading.get_ident()]
            rec._raw.append(self._entry)
            rec._live[i] = None
        stack.append(i)
        self._i = i
        self._rf = None
        if torch._C._autograd._profiler_enabled():
            self._rf = torch.profiler.record_function(self._name)
            self._rf.__enter__()
        self._entry[1] = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        # the profiler stamps its event inside these calls: the clock is
        # read after ``record_function`` opens and after it closes
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
        self._entry[2] = time.perf_counter_ns()
        rec = self._rec
        rec._stack().pop()
        with rec._lock:
            del rec._live[self._i]
        return False


def span(name: str):
    """A context manager timing the block as span ``name`` while a
    recording is open; otherwise one shared object that does nothing."""
    rec = _rec
    if rec is None:
        return _OFF
    return _On(rec, name)


def count(name: str, n: int) -> None:
    """Adds the host integer ``n`` to counter ``name`` while recording."""
    rec = _rec
    if rec is not None:
        with rec._lock:
            rec.counters[name] = rec.counters.get(name, 0) + int(n)


def count_device(name: str, fn, *args) -> None:
    """While recording, adds ``fn(*args)`` (an integer scalar tensor on
    any device) into counter ``name``'s accumulator on that device, with
    no sync; the accumulators are read once, when the recording closes.
    Off, ``fn`` is not called."""
    rec = _rec
    if rec is None:
        return
    t = fn(*args).detach().to(torch.int64)
    with rec._lock:
        acc = rec._device.get(name)
        if acc is None:
            rec._device[name] = t.clone()
            return
    acc.add_(t)


@contextmanager
def recording() -> Iterator["Recording"]:
    """Turns tracing on for the block; yields the :class:`Recording`,
    complete once the block has closed. One recording at a time."""
    global _rec
    if _rec is not None:
        raise RuntimeError("a trace recording is already open")
    rec = Recording()
    _rec = rec
    try:
        yield rec
    finally:
        _rec = None
        rec._close()


class Recording:
    """What one :func:`recording` block recorded: ``spans`` in the order
    they opened, ``counters`` by name, ``start_ns`` / ``end_ns`` of the
    block, all on the profiler's clock."""

    def __init__(self):
        self.spans: List[Span] = []
        self.counters: Dict[str, int] = {}
        self._raw: list = []
        self._live: Dict[int, None] = {}
        self._device: Dict[str, torch.Tensor] = {}
        self._lock = threading.Lock()
        self._local = threading.local()
        self._offset = _epoch_offset()
        self.start_ns = time.perf_counter_ns() + self._offset
        self.end_ns = self.start_ns

    def _stack(self) -> list:
        s = getattr(self._local, "stack", None)
        if s is None:
            s = self._local.stack = []
        return s

    def _close(self) -> None:
        now = time.perf_counter_ns()
        off = self._offset
        self.end_ns = now + off
        self.spans = [Span(n, a + off, (b or now) + off, p, r, t)
                      for n, a, b, p, r, t in self._raw]
        for name, acc in self._device.items():
            self.counters[name] = self.counters.get(name, 0) + int(acc)
        self._raw, self._device = [], {}

    def self_ns(self) -> List[int]:
        """Each span's duration less what its children cover (their
        union: children on two threads may overlap)."""
        kids: Dict[int, list] = {}
        for s in self.spans:
            if s.parent is not None:
                kids.setdefault(s.parent, []).append((s.start_ns, s.end_ns))
        out = []
        for i, s in enumerate(self.spans):
            own, reach = s.end_ns - s.start_ns, s.start_ns
            for a, b in sorted(kids.get(i, ())):
                a, b = max(a, reach), min(b, s.end_ns)
                if b > a:
                    own -= b - a
                    reach = b
            out.append(own)
        return out


def _epoch_offset() -> int:
    """The profiler's clock (the Unix epoch) less ``perf_counter_ns``,
    from the tightest of a few bracketed reads."""
    best = None
    for _ in range(5):
        a = time.perf_counter_ns()
        t = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, t - (a + b) // 2)
    return best[1]
