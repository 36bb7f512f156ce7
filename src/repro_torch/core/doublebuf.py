"""Double-buffered streaming maintenance: serve the current plan while
its layout repair builds in the background, then swap atomically.

The streaming tiers split into two classes. The in-place tiers
(tombstone / append / patch) keep the ELL layout and re-dress touched
row-blocks with device scatters on a copy of the tiles — cheap enough to
stay on the serving critical path. The *layout* tiers (γ-drift rebucket,
debris/fill-drift compaction) rebuild the ordering or the whole plan —
hygiene, not correctness, and far too expensive to stall serving on.

:class:`DoubleBufferedPlan` runs the split: every ``update`` applies the
in-place tiers synchronously via ``api.update_plan(...,
defer_layout=True)``; when a layout tier fires, its repair
(``api.apply_pending_layout``) runs on a daemon thread against an
immutable snapshot while the foreground keeps serving matvecs (through
the SpMV kernel on a CUDA plan) from the current buffer. The successor is
adopted atomically at the next ``update``/``poll``, bumping
``generation``.

Consistency contract:

- ``update_plan`` is copy-on-write and ``apply_pending_layout`` is a
  pure function of its snapshot, so the serving plan is never mutated by
  the background build: a matvec issued mid-build returns the old
  generation's result **bit-exactly**.
- While a build is in flight, incoming updates are *queued*, not
  applied (applying them would fork the lineage the build snapshotted).
  They replay in order right after the swap; a compact swap first remaps
  their delete indices through ``host.compact_map``. Physical indices
  handed out before the swap (``last_inserted_idx``, events) stay valid
  across rebucket swaps and are remapped across compact swaps.
- The swapped-in successor is bit-identical to running the same repair
  synchronously on the snapshot.

CUDA in the worker: the current device and stream are per thread, so
the worker sets the snapshot's device explicitly and runs the repair on
that device's default stream — the stream the serving thread uses too.
The card then orders the repair's work and the serving launches on one
stream; both threads' host work (the repair is mostly numpy) overlaps.
Because the successor's tensors were written on the same stream that
serves them, the swap needs no extra synchronisation.

Downstream state absorbs a swap explicitly: re-shard via
``ShardedPlan.absorb(dbp.plan)``, re-attach a ``serve.LockstepInserter``
with the new ``generation`` (stale-generation claims raise).
"""
from __future__ import annotations

import threading
from contextlib import nullcontext
from typing import Optional

import numpy as np
import torch


class DoubleBufferedPlan:
    """Serve a streaming :class:`~repro_torch.api.InteractionPlan` while
    its layout repairs build on a background thread.

    Args:
        plan: the streamable plan to wrap (built by ``api.build_plan``
            from points).

    Attributes:
        generation: monotone counter, bumped once per adopted background
            repair (the swap). In-place updates do not bump it.
        events: append-only log of what actually happened, in order —
            ``("apply", inserted_phys)`` when an update was applied
            (``inserted_phys`` is ``host.last_inserted_idx`` or ``None``),
            ``("swap", kind, compact_map)`` when a background repair was
            adopted (``compact_map`` is ``None`` unless ``kind ==
            "compact"``). Callers tracking physical slots consume this
            instead of guessing.
        last_swap: ``(snapshot, successor, kind)`` of the most recent
            swap — the bit-exactness hook: ``api.apply_pending_layout(
            snapshot)`` re-run inline must equal ``successor``.
    """

    def __init__(self, plan):
        from repro_torch import api
        self._api = api
        self._plan = plan
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._result = None
        self._error: Optional[BaseException] = None
        self._snapshot = None
        self._queue: list = []
        self.generation = 0
        self.events: list = []
        self.last_swap = None

    # -- serving ----------------------------------------------------------

    @property
    def plan(self):
        """The current serving plan. Never advanced by the background
        thread — only ``update``/``poll``/``wait``/``flush`` (caller
        thread) swap a finished successor in."""
        return self._plan

    @property
    def building(self) -> bool:
        """True while a background layout repair is in flight."""
        return self._thread is not None and self._thread.is_alive()

    @property
    def queued(self) -> int:
        """Updates waiting for the in-flight repair to land."""
        return len(self._queue)

    def matvec(self, charges, **kw):
        """Matvec on the serving buffer (old generation mid-build)."""
        return self._plan.matvec(charges, **kw)

    def apply(self, charges, **kw):
        """`plan.apply` on the serving buffer (old generation mid-build)."""
        return self._plan.apply(charges, **kw)

    # -- streaming --------------------------------------------------------

    def update(self, *, insert=None, delete=None, policy=None):
        """One streaming step against the double buffer.

        Adopts a finished background repair first (swap + queued-update
        replay). Then: if a repair is still in flight, the op is queued —
        the serving state is frozen at the build's snapshot so mid-build
        reads stay bit-exact — otherwise the in-place tiers run
        synchronously and, when a layout tier fired, its repair is
        launched in the background.

        ``delete`` indices are interpreted against the serving plan as
        the caller last observed it: if this call adopts a compact swap,
        they are remapped through its ``compact_map`` before being
        applied or queued.

        Returns:
            ``"applied"`` or ``"queued"``.
        """
        n_ev = len(self.events)
        while True:
            self.poll()
            if delete is not None:
                # remap across any compact swap this call just adopted —
                # the caller picked these indices before the swap
                for ev in self.events[n_ev:]:
                    if ev[0] == "swap" and ev[2] is not None:
                        d = ev[2][np.asarray(delete, np.int64)]
                        d = d[d >= 0]
                        delete = d if d.size else None
                        if delete is None:
                            break
            n_ev = len(self.events)
            t = self._thread
            if t is None:
                break
            if t.is_alive():
                self._queue.append({"insert": insert, "delete": delete,
                                    "policy": policy})
                return "queued"
            # the build finished between poll() and here: loop to adopt
            # it first — applying now would be clobbered by the swap
        if insert is None and delete is None and policy is None:
            return "applied"        # op fully absorbed by the remap
        new = self._api.update_plan(self._plan, insert=insert,
                                    delete=delete, policy=policy,
                                    defer_layout=True)
        self._plan = new
        self.events.append(("apply", new.host.last_inserted_idx))
        if new.host.pending_layout is not None:
            self._launch(new)
        return "applied"

    def _launch(self, snapshot) -> None:
        """Start the background repair of ``snapshot.pending_layout`` on a
        daemon thread, on the snapshot's device."""
        # read at launch, from the module: a caller (or test) that swaps
        # api.apply_pending_layout is obeyed by the next repair
        apply_fn = self._api.apply_pending_layout
        dev = snapshot.device

        def work():
            try:
                with (torch.cuda.device(dev) if dev.type == "cuda"
                      else nullcontext()):
                    self._result = apply_fn(snapshot)
            except BaseException as e:           # re-raised at poll
                self._error = e

        self._snapshot = snapshot
        self._thread = threading.Thread(target=work, daemon=True,
                                        name="repro-plan-maintenance")
        self._thread.start()

    def poll(self) -> bool:
        """Adopt a finished background repair, if any.

        Swaps the successor in atomically (under the lock), bumps
        ``generation``, remaps queued delete indices through
        ``host.compact_map`` when the repair was a compaction, then
        replays the queued updates in order (which may launch the next
        repair). Returns True when a swap happened. Re-raises an
        exception the background build hit (the repair is dropped and the
        serving plan stays the snapshot).
        """
        with self._lock:
            if self._thread is None or self._thread.is_alive():
                return False
            self._thread.join()
            self._thread = None
            if self._error is not None:
                err, self._error = self._error, None
                raise err
            successor, self._result = self._result, None
            snapshot, self._snapshot = self._snapshot, None
            kind = snapshot.host.pending_layout
            cmap = successor.host.compact_map if kind == "compact" else None
            if cmap is not None:
                for op in self._queue:
                    if op["delete"] is not None:
                        d = cmap[np.asarray(op["delete"], np.int64)]
                        d = d[d >= 0]   # queued rows were alive: all map
                        op["delete"] = d if d.size else None
            self._plan = successor
            self.generation += 1
            self.last_swap = (snapshot, successor, kind)
            self.events.append(("swap", kind, cmap))
            replay, self._queue = self._queue, []
        for op in replay:
            self.update(**op)
        return True

    # -- barriers (tests, benchmarks, shutdown) ---------------------------

    def wait(self) -> None:
        """Block until the in-flight repair (if any) lands and its swap
        plus queued-update replay have run."""
        t = self._thread
        if t is not None:
            t.join()
        self.poll()

    def flush(self):
        """Drain everything: repeatedly wait/swap/replay until no repair
        is in flight, the queue is empty, and nothing is pending — then
        run any last recorded repair synchronously. Returns the fully
        repaired serving plan."""
        while True:
            self.wait()
            if self.building or self._queue:
                continue
            if self._plan.host.pending_layout is not None:
                # recorded on the very last applied update: no reason to
                # background it when the caller is blocking anyway
                snapshot = self._plan
                kind = snapshot.host.pending_layout
                self._plan = self._api.apply_pending_layout(snapshot)
                self.generation += 1
                cmap = (self._plan.host.compact_map
                        if kind == "compact" else None)
                self.last_swap = (snapshot, self._plan, kind)
                self.events.append(("swap", kind, cmap))
            return self._plan
