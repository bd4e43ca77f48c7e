"""Deterministic fault injection for the serving stack.

A copy of `repro/serving/faults.py` (standard library only), kept in the
port so that it imports nothing of the JAX package.

A `FaultPolicy` is a list of `FaultSpec`s armed at named injection
*sites* the serving code consults at its hazard points
(`policy.check(site, **ctx)`):

  * ``"asr_step"``    — inside `AsrEngine._step_slots`, after batch
                        assembly and before the batch goes to the
                        device; ctx carries ``slots`` and ``sids`` of
                        the gathered sub-batch.
  * ``"lm_prefill"``  — inside `LmEngine._prefill_group`; ctx carries
                        the ``sids`` being prefilled.
  * ``"pump"``        — top of `EngineWorker._pump`, once per pump
                        iteration; the place to simulate a dying or
                        wedged worker thread.

Determinism contract: every decision is a pure function of the
per-site invocation counter (`nth`/`count`) and the injected context
(`match`) — never of wall-clock time or a global RNG — so a chaos test
replays identically and a bisected retry sees the same world minus the
spent injection.  Specs with ``count`` fire a bounded number of times
and then disarm, which is what lets quarantine tests observe recovery.

Actions:

  * ``"raise"`` — raise `InjectedFault` (an ordinary `Exception`): the
    quarantine machinery must contain it.
  * ``"die"``   — raise `WorkerKilled` (a `BaseException`): models the
    worker thread dying for reasons quarantine cannot contain (segfault
    stand-in); only the supervisor may recover from it.
  * ``"stall"`` — block on an event until `release()` (bounded by
    ``stall_timeout`` so a broken test cannot hang the suite): models a
    wedged worker the heartbeat watchdog must notice.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional


class InjectedFault(RuntimeError):
    """Raised by a ``"raise"`` fault spec: a synthetic per-step failure
    the quarantine machinery is expected to contain."""


class WorkerKilled(BaseException):
    """Raised by a ``"die"`` fault spec.  Deliberately NOT an
    `Exception` subclass: it escapes the engine's per-pump quarantine
    (`except Exception`) exactly like a real thread-killing failure
    would, so only the worker supervisor can observe and recover it."""


@dataclass
class FaultSpec:
    """One armed fault.

    site     injection-site name (see module docstring)
    action   "raise" | "die" | "stall"
    nth      fire starting at the nth *matching* check of this site
             (0-based over matching invocations)
    count    how many matching checks fire after `nth` (None = forever)
    match    optional predicate over the site's context kwargs; a check
             whose ctx does not match neither fires nor advances `nth`
    message  text carried by the raised InjectedFault/WorkerKilled
    """
    site: str
    action: str = "raise"
    nth: int = 0
    count: Optional[int] = 1
    match: Optional[Callable[[dict], bool]] = None
    message: str = "injected fault"
    _seen: int = field(default=0, repr=False)
    _fired: int = field(default=0, repr=False)

    def __post_init__(self):
        if self.action not in ("raise", "die", "stall"):
            raise ValueError(f"unknown fault action {self.action!r}")

    def should_fire(self, ctx: dict) -> bool:
        if self.match is not None and not self.match(ctx):
            return False
        seen = self._seen
        self._seen += 1
        if seen < self.nth:
            return False
        if self.count is not None and self._fired >= self.count:
            return False
        self._fired += 1
        return True


class FaultPolicy:
    """Armed fault specs + per-site counters + an injection log.

    Thread-safety: `check` is called from the engine-worker thread while
    tests `release()` stalls and read `log` from the main thread; a lock
    guards the counters and the log list (entries are appended once,
    never mutated)."""

    def __init__(self, specs: List[FaultSpec],
                 stall_timeout: float = 30.0):
        self.specs = list(specs)
        self.stall_timeout = stall_timeout
        self.log: List[dict] = []
        self._counters: Dict[str, int] = {}
        self._stall = threading.Event()
        self._lock = threading.Lock()

    def release(self) -> None:
        """Unblock every current and future ``"stall"`` injection."""
        self._stall.set()

    def check(self, site: str, **ctx) -> None:
        """Consult the policy at an injection site.  Raises / stalls if
        an armed spec fires; otherwise returns immediately (the no-op
        cost is one dict lookup, so production code may leave the hook
        wired unconditionally when no policy is configured)."""
        with self._lock:
            self._counters[site] = self._counters.get(site, 0) + 1
            spec = next((s for s in self.specs
                         if s.site == site and s.should_fire(ctx)), None)
            if spec is None:
                return
            self.log.append({
                "site": site, "action": spec.action,
                "invocation": self._counters[site] - 1,
                "ctx": {k: v for k, v in ctx.items()
                        if isinstance(v, (int, float, str, bool, tuple,
                                          list))},
            })
        if spec.action == "stall":
            # wait OUTSIDE the lock: release() and log readers must not
            # deadlock against a stalled worker
            self._stall.wait(self.stall_timeout)
            return
        if spec.action == "die":
            raise WorkerKilled(spec.message)
        raise InjectedFault(spec.message)
