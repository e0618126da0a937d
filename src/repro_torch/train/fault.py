"""Fault tolerance: restartable training driver with straggler monitoring —
a copy of the JAX package's ``train/fault.py``.

Design for thousands of nodes (DESIGN.md §6):

  * **checkpoint/restart** — step-atomic checkpoints (params + optimizer +
    data cursor); the driver always resumes from the newest readable one, so
    a preempted/failed job restarts with zero manual action.
  * **elastic re-shard** — checkpoints are logical (unsharded), so a restart
    may use a different device count/mesh; ``restore_checkpoint`` re-shards.
  * **straggler mitigation** — per-step wall times feed an EWMA monitor; a
    step slower than ``threshold x`` the EWMA flags the step (on real fleets
    this triggers hot-spare swap / re-slicing; here it is surfaced to the
    log and test hooks).
  * **failure injection** — the driver takes a ``fault_hook`` so tests can
    kill a step deterministically and assert recovery.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional


@dataclass
class StragglerMonitor:
    alpha: float = 0.2
    threshold: float = 3.0
    ewma: Optional[float] = None
    flagged: List[int] = field(default_factory=list)

    def observe(self, step: int, dt: float) -> bool:
        slow = self.ewma is not None and dt > self.threshold * self.ewma
        self.ewma = dt if self.ewma is None else (1 - self.alpha) * self.ewma + self.alpha * dt
        if slow:
            self.flagged.append(step)
        return slow


class SimulatedFailure(RuntimeError):
    pass


def run_with_restarts(
    *,
    total_steps: int,
    make_state: Callable[[], tuple],        # () -> (state, data, start_step)
    run_step: Callable[[object, object, int], tuple],  # (state, batch, step) -> (state, metrics)
    save: Callable[[object, object, int], None],
    ckpt_every: int = 50,
    max_restarts: int = 10,
    fault_hook: Optional[Callable[[int], None]] = None,
    log: Callable[[str], None] = lambda s: None,
) -> Dict:
    """Generic restartable loop; returns summary stats."""
    restarts = 0
    monitor = StragglerMonitor()
    history: List[float] = []
    while True:
        state, data, step = make_state()
        try:
            while step < total_steps:
                if fault_hook is not None:
                    fault_hook(step)
                batch = next(data)
                t0 = time.perf_counter()
                state, metrics = run_step(state, batch, step)
                dt = time.perf_counter() - t0
                if monitor.observe(step, dt):
                    log(f"step {step}: straggler ({dt:.3f}s vs ewma {monitor.ewma:.3f}s)")
                history.append(float(metrics.get("loss", 0.0)))
                step += 1
                if step % ckpt_every == 0 or step == total_steps:
                    save(state, data, step)
            return {
                "final_step": step,
                "restarts": restarts,
                "losses": history,
                "stragglers": monitor.flagged,
            }
        except SimulatedFailure:
            restarts += 1
            log(f"failure at step {step}; restart #{restarts}")
            if restarts > max_restarts:
                raise


__all__ = ["StragglerMonitor", "SimulatedFailure", "run_with_restarts"]
