"""Serving metrics: latency distributions + admission counters per engine.

A copy of `repro/serving/metrics.py` (no framework import), kept in the port so that it
imports nothing of the JAX package.

One `EngineMetrics` object rides on every `Engine` (in-process and behind
the network front-end alike — the server's `GET /metrics` endpoint and a
plain `engine.metrics.snapshot()` read the same numbers).  The engine
records events at the points the SLO story cares about:

  * admission   — sessions opened / admitted / rejected (backpressure),
                  queue-wait latency, live + high-water queue depth
  * first result— time from `open()` to the first fused step that covers
                  the session's slot (ASR) or to prefill emitting the
                  first token (LM): the "first partial result exists"
                  moment a streaming client can observe
  * finalize    — time from `finish()` being signalled to the final
                  result being harvested off the slot
  * e2e         — open() -> final result, the whole-session latency
  * steps       — fused-step count and step-shape occupancy: the
                  fraction of dispatched sub-batch rows that carried a
                  real active slot (bucket padding and idle LM slots
                  burn compute without retiring work)

Latencies are held in bounded reservoirs (`LatencyStat`) so a long-lived
streaming engine does not grow without bound; percentiles are computed
over the retained window.  All hooks are O(1) appends — cheap enough for
the decode hot path.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Callable, Dict, Optional

import numpy as np


class LatencyStat:
    """Bounded latency reservoir with percentile readout (seconds in,
    milliseconds out)."""

    def __init__(self, maxlen: int = 65536):
        self._v: deque = deque(maxlen=maxlen)
        self.count = 0            # total ever recorded (reservoir may drop)

    def add(self, seconds: float) -> None:
        self._v.append(float(seconds))
        self.count += 1

    def percentile_ms(self, q: float) -> Optional[float]:
        if not self._v:
            return None
        return float(np.percentile(np.fromiter(self._v, float), q)) * 1e3

    def snapshot(self) -> Dict[str, float]:
        out: Dict[str, float] = {"count": self.count}
        if self._v:
            arr = np.fromiter(self._v, float) * 1e3
            out["mean_ms"] = round(float(arr.mean()), 3)
            for q in (50, 95, 99):
                out[f"p{q}_ms"] = round(float(np.percentile(arr, q)), 3)
        return out


class EngineMetrics:
    """Event sink for one engine; see module docstring for the fields.

    `clock` is injectable for tests (defaults to `time.monotonic`).
    Session handles carry their own timestamps (`_t_open` etc.), so the
    hooks stay idempotent — recording "first result" twice for the same
    session is a no-op."""

    def __init__(self, clock: Callable[[], float] = time.monotonic):
        self._clock = clock
        self.opened = 0
        self.admitted = 0
        self.rejected = 0
        self.finalized = 0
        self.faulted_sessions = 0     # quarantined (poison input / pool)
        self.deadline_evictions = 0   # reaped past session_deadline
        self.worker_restarts = 0      # supervisor rebuilt the worker
        self.queue_depth = 0
        self.max_queue_depth = 0
        self.steps = 0
        self.stepped_slots = 0        # real active slots across all steps
        self.dispatched_rows = 0      # sub-batch rows incl. bucket padding
        self.queue_wait = LatencyStat()
        self.first_result = LatencyStat()
        self.finalize = LatencyStat()
        self.e2e = LatencyStat()

    # ---- admission ---------------------------------------------------
    def on_open(self, session) -> None:
        session._t_open = self._clock()
        self.opened += 1

    def on_reject(self) -> None:
        self.rejected += 1

    def on_admit(self, session) -> None:
        t = self._clock()
        session._t_admit = t
        self.admitted += 1
        if session._t_open is not None:
            self.queue_wait.add(t - session._t_open)

    def sample_queue_depth(self, depth: int) -> None:
        self.queue_depth = depth
        if depth > self.max_queue_depth:
            self.max_queue_depth = depth

    # ---- progress ----------------------------------------------------
    def on_step(self, n_active: int, n_rows: int) -> None:
        """One fused step advanced `n_active` real slots through a
        dispatch shaped for `n_rows` sub-batch rows."""
        self.steps += 1
        self.stepped_slots += n_active
        self.dispatched_rows += n_rows

    def on_first_result(self, session) -> None:
        if session._t_first is not None or session._t_open is None:
            return
        t = self._clock()
        session._t_first = t
        self.first_result.add(t - session._t_open)

    def on_finish(self, session) -> None:
        if session._t_finish is None:
            session._t_finish = self._clock()

    def on_done(self, session) -> None:
        t = self._clock()
        self.finalized += 1
        if session._t_open is not None:
            self.e2e.add(t - session._t_open)
        if session._t_finish is not None:
            self.finalize.add(t - session._t_finish)

    # ---- faults ------------------------------------------------------
    def on_fault(self, session) -> None:
        """Session evicted with a typed `SessionFaulted` (poison input,
        failed prefill, or whole-pool quarantine)."""
        self.faulted_sessions += 1

    def on_deadline(self, session) -> None:
        """Session reaped past `EngineConfig.session_deadline`."""
        self.deadline_evictions += 1

    def on_worker_restart(self) -> None:
        """The supervisor detected a dead/wedged `EngineWorker` and
        rebuilt it (called from the event loop: a dead worker cannot
        record its own death)."""
        self.worker_restarts += 1

    # ---- readout -----------------------------------------------------
    def occupancy(self) -> Optional[float]:
        """Fraction of dispatched sub-batch rows holding a real active
        slot (1.0 = every step ran exactly full)."""
        if not self.dispatched_rows:
            return None
        return self.stepped_slots / self.dispatched_rows

    def snapshot(self) -> dict:
        occ = self.occupancy()
        return {
            "sessions": {
                "opened": self.opened, "admitted": self.admitted,
                "rejected": self.rejected, "finalized": self.finalized,
                "faulted": self.faulted_sessions,
                "deadline_evicted": self.deadline_evictions,
            },
            "workers": {"restarts": self.worker_restarts},
            "queue": {
                "depth": self.queue_depth,
                "max_depth": self.max_queue_depth,
            },
            "steps": {
                "count": self.steps,
                "stepped_slots": self.stepped_slots,
                "dispatched_rows": self.dispatched_rows,
                "occupancy": None if occ is None else round(occ, 4),
            },
            "latency": {
                "queue_wait": self.queue_wait.snapshot(),
                "first_result": self.first_result.snapshot(),
                "finalize": self.finalize.snapshot(),
                "e2e": self.e2e.snapshot(),
            },
        }
