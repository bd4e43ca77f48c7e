"""Fault tolerance + straggler mitigation for the training loop: the
port's own copy of `repro/runtime/fault.py` (standard library only, so
it imports nothing of the JAX package).

  * `run_resilient(step_fn)` — retries transient step failures, restores
    from the last good checkpoint after `max_retries` (the node-loss
    path; the restore path itself is exercised).
  * `StepWatchdog` — EMA step-timer; a step slower than `threshold x` the
    EMA flags a straggler (the detection half of straggler mitigation).
  * `Heartbeat` — liveness file another process can monitor.
"""
from __future__ import annotations

import pathlib
import time
from dataclasses import dataclass
from typing import Callable, Optional


@dataclass
class StepWatchdog:
    threshold: float = 3.0
    ema_decay: float = 0.9
    ema: Optional[float] = None
    stragglers: int = 0

    def observe(self, dt: float) -> bool:
        """Returns True if this step is a straggler."""
        if self.ema is None:
            self.ema = dt
            return False
        slow = dt > self.threshold * self.ema
        if slow:
            self.stragglers += 1
        else:  # only healthy steps update the baseline
            self.ema = self.ema_decay * self.ema + (1 - self.ema_decay) * dt
        return slow


@dataclass
class Heartbeat:
    path: str

    def beat(self, step: int):
        p = pathlib.Path(self.path)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(f"{step} {time.time()}\n")


class TransientError(RuntimeError):
    """Raised by step functions to simulate recoverable node failures."""


def run_resilient(step_fn: Callable, state, start_step: int, n_steps: int,
                  checkpointer=None, ckpt_every: int = 50,
                  max_retries: int = 2, watchdog: Optional[StepWatchdog] = None,
                  heartbeat: Optional[Heartbeat] = None,
                  on_metrics: Optional[Callable] = None):
    """Run `n_steps` of `step_fn(state, step) -> (state, metrics)` with
    retry -> restore-from-checkpoint escalation. Returns (state, stats)."""
    stats = {"retries": 0, "restores": 0, "stragglers": 0}
    step = start_step
    while step < start_step + n_steps:
        t0 = time.time()
        try:
            state, metrics = step_fn(state, step)
        except TransientError:
            stats["retries"] += 1
            if stats["retries"] % (max_retries + 1) == max_retries:
                # escalate: restore last good checkpoint (node-loss path)
                if checkpointer is not None and checkpointer.latest_step() is not None:
                    restored = checkpointer.latest_step()
                    state = checkpointer.restore(state)
                    step = restored
                    stats["restores"] += 1
            continue
        dt = time.time() - t0
        if watchdog is not None and watchdog.observe(dt):
            stats["stragglers"] += 1
        if heartbeat is not None:
            heartbeat.beat(step)
        if checkpointer is not None and (step + 1) % ckpt_every == 0:
            checkpointer.save_async(step + 1, state)
        if on_metrics is not None:
            on_metrics(step, metrics, dt)
        step += 1
    if checkpointer is not None:
        checkpointer.wait()
    return state, stats
