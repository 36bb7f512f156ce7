"""Fault tolerance for the step loop: heartbeat + deadline + restart, the
port's copy of the reference's ``launch/ft.py``.

The failure model: a host stops making progress (hardware fault,
straggler, preemption). The supervisor implements the standard recovery
contract around any step function:

  - HEARTBEAT: every completed step stamps a monotonic heartbeat;
  - DEADLINE: a watchdog thread flags the job unhealthy when no step
    completes within ``step_deadline_s``, and the loop aborts the stalled
    run rather than let one slow host wedge the job;
  - RESTART: ``run`` resumes from the latest checkpoint, and the
    deterministic data pipeline (``data.pipeline.token_batch``) skips
    ahead by step index, so recovery is exactly-once with no data replay
    bookkeeping.

One process cannot kill real hosts, so the tests exercise the supervisor
with injected faults.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional


class StepTimeout(RuntimeError):
    pass


@dataclass
class Supervisor:
    step_deadline_s: float = 600.0
    max_restarts: int = 3
    on_restart: Optional[Callable[[int], None]] = None
    _beat: float = field(default_factory=time.monotonic)
    _healthy: bool = True

    def heartbeat(self) -> None:
        self._beat = time.monotonic()

    def stalled(self) -> bool:
        return (time.monotonic() - self._beat) > self.step_deadline_s

    def run(self, *, n_steps: int, make_state: Callable[[], Any],
            step_fn: Callable[[Any, int], Any],
            save: Callable[[int, Any], None],
            restore: Callable[[], tuple[Any, int]],
            ckpt_every: int = 50) -> Any:
        """Run the loop with restart-from-checkpoint on failure.

        make_state() builds fresh state; restore() -> (state, step) or raises
        FileNotFoundError; step_fn(state, step) -> state (may raise);
        save(step, state) checkpoints.
        """
        restarts = 0
        while True:
            try:
                try:
                    state, start = restore()
                    start += 1
                except FileNotFoundError:
                    state, start = make_state(), 0
                watchdog_stop = threading.Event()

                def watchdog():
                    while not watchdog_stop.is_set():
                        if self.stalled():
                            self._healthy = False
                            return
                        time.sleep(min(self.step_deadline_s / 4, 1.0))

                wt = threading.Thread(target=watchdog, daemon=True)
                self.heartbeat()
                wt.start()
                try:
                    for step in range(start, n_steps):
                        if not self._healthy:
                            raise StepTimeout(
                                f"no heartbeat for {self.step_deadline_s}s "
                                f"at step {step}")
                        state = step_fn(state, step)
                        self.heartbeat()
                        if ckpt_every and (step + 1) % ckpt_every == 0:
                            save(step, state)
                finally:
                    watchdog_stop.set()
                save(n_steps - 1, state)
                return state
            except Exception:
                restarts += 1
                self._healthy = True
                if restarts > self.max_restarts:
                    raise
                if self.on_restart:
                    self.on_restart(restarts)
