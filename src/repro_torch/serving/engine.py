"""Engine/Session base: slot pool, admission queue, session lifecycle.

A framework-free copy of `repro/serving/engine.py` (numpy only), kept in
the port so that it imports nothing of the JAX package.

One `Engine` owns a fixed pool of `n_slots` decoding slots advanced by a
single fused, slot-batched step.  Callers never touch slots: they `open()` a `Session`, stream
input with `push`, read output with `poll`, and signal end-of-input with
`finish`.  The engine admits queued sessions into freed slots
(continuous batching), steps every slot that can make progress, and
harvests finished sessions back off the pool.

Scheduling contract: `push` only buffers and admits (so concurrently
opened sessions share batched steps instead of being drained one by
one); `poll`/`finish` drive the admit -> step -> harvest loop to
quiescence.  Per-slot trajectories are independent of scheduling, so
results are identical however pushes and polls interleave — that is the
parity property tests/test_serving.py and tests/test_multistream.py pin
down.

Subclasses implement the slot mechanics:
  _admit_to_slot(session, slot)  load a queued session's pending input
  _step() -> bool                one fused step; False = nothing to do.
                                 Which slots it advances (all of them,
                                 a gathered sub-batch, ...) is the
                                 subclass's scheduling policy — the
                                 only contract is that per-slot
                                 trajectories are schedule-independent
  _ready_to_close(session, slot) session's slot work is exhausted
  _finalize_slot(slot) -> dict   result payload for a closing session
  _readout(session) -> dict      live output for a session, without
                                 driving the pump (the server's poll)

Named commands: everything the network front-end changes in an engine
goes through `Engine.execute(op, session, data)` with `op` one of
`COMMANDS` (open, push, poll, finish, one pump round, reap(sids),
fail_all(reason)), never through a free thunk.  Under a serving mesh
that is what makes the server's decisions replayable: rank 0 sends each
command to the other ranks in the order it runs them, and every rank
applies them to its own copy of the engine (`serving.server.follow`).
Deadlines are the one decision that reads a clock: `_overdue()` reads
it, `_reap(sids)` acts on its answer, so rank 0 alone can decide them.
"""
from __future__ import annotations

import functools
import threading
from typing import Iterator, List, Optional

import numpy as np

from repro_torch.serving.metrics import EngineMetrics


# the named commands of `Engine.execute`
COMMANDS = ("open", "push", "poll", "finish", "pump", "reap", "fail_all")


def check_owner(engine, what: str) -> None:
    """Raise unless the calling thread may act on `engine`: any thread
    when no `EngineWorker` owns it, else only the owner thread."""
    owner = getattr(engine, "_owner_thread", None)
    if owner is not None and threading.current_thread() is not owner:
        raise RuntimeError(
            f"{type(engine).__name__}.{what} called from "
            f"thread {threading.current_thread().name!r}, but the "
            f"engine is owned by worker thread {owner.name!r}: "
            "submit a command through the EngineWorker instead")


def worker_only(method):
    """Marks an engine method that mutates pool state (the admit ->
    step -> harvest pump and reset): when the engine is owned by an
    `EngineWorker` thread (`_owner_thread` set), calling it from any
    other thread raises instead of racing the pump.  In-process use
    (tests, launchers, `Session.poll` driving `_advance`) has no owner
    thread and is unaffected."""
    @functools.wraps(method)
    def wrapper(self, *args, **kwargs):
        check_owner(self, method.__name__)
        return method(self, *args, **kwargs)
    wrapper._worker_only = True
    return wrapper


class AdmissionRejected(RuntimeError):
    """Typed backpressure error: the engine's admission queue is at
    `EngineConfig.max_queue` and no slot is free, so `open()` refuses
    the session instead of queueing it unboundedly.  Carries the depth
    observed and the configured bound so callers (e.g. the network
    front-end's 503 response) can report both."""

    def __init__(self, queue_depth: int, max_queue: int):
        super().__init__(
            f"admission rejected: queue depth {queue_depth} at "
            f"max_queue={max_queue} with every slot busy")
        self.queue_depth = queue_depth
        self.max_queue = max_queue


class SessionFaulted(RuntimeError):
    """Typed per-session failure: the engine evicted ONE session —
    poison input isolated by bisection retry, a failed prefill, or a
    whole-pool quarantine — without taking the pool down.  The session
    handle raises this from `push`/`poll`/`finish`, done-watchers
    resolve with it, and the network front-end maps it to an in-stream
    error chunk (`/asr`) or a 500 (`/lm`).  `__cause__` carries the
    original exception when one exists."""

    def __init__(self, sid: int, reason: str,
                 cause: Optional[BaseException] = None):
        super().__init__(f"session {sid} faulted: {reason}")
        self.sid = sid
        self.reason = reason
        if cause is not None:
            self.__cause__ = cause


class DeadlineExceeded(SessionFaulted):
    """A session outlived `EngineConfig.session_deadline` and was reaped
    by the pump to free its slot/queue entry."""


class SessionQueue:
    """Order-preserving admission queue with O(1) removal.

    `deque.remove(sess)` is O(position) — draining hundreds of queued
    sessions (the load-generator regime) went quadratic whenever the
    removed session was not at the head (LM sessions waiting on a
    prompt, the finished-but-unadmittable harvest path).  A dict keyed
    by the session handles preserves insertion order (guaranteed since
    Python 3.7) and deletes in O(1)."""

    def __init__(self):
        self._d: dict = {}

    def append(self, session) -> None:
        self._d[session] = None

    def remove(self, session) -> None:
        del self._d[session]

    def clear(self) -> None:
        self._d.clear()

    def __iter__(self) -> Iterator:
        return iter(self._d)

    def __len__(self) -> int:
        return len(self._d)

    def __contains__(self, session) -> bool:
        return session in self._d


def copy_result(res: dict) -> dict:
    """Defensive copy of a result payload.  The engine keeps the stored
    result for later polls; handing out the stored numpy arrays (or the
    LM token list) would let a caller's in-place mutation corrupt every
    subsequent poll of the same session."""
    return {k: v.copy() if isinstance(v, np.ndarray)
            else list(v) if isinstance(v, list) else v
            for k, v in res.items()}


class Session:
    """Handle for one connection to an engine's slot pool.

    States: queued (no slot yet) -> active (owns a slot) -> done
    (result available).  `push` feeds input, `poll` reads the current
    output, `finish` declares end-of-input and returns the final result
    once the engine has drained the session (None while it is still
    waiting on a slot held by other sessions)."""

    def __init__(self, engine: "Engine", sid: int):
        self._engine = engine
        self.sid = sid
        self.slot: Optional[int] = None
        self.finished = False          # finish() called; no more input
        self.detached = False          # engine was reset under the session
        self.fault: Optional[SessionFaulted] = None
        self.result: Optional[dict] = None
        self._pending = None           # mode-specific input awaiting a slot
        # metric timestamps, stamped by engine.metrics (see metrics.py)
        self._t_open = self._t_admit = None
        self._t_first = self._t_finish = None

    @property
    def admitted(self) -> bool:
        return self.slot is not None

    @property
    def done(self) -> bool:
        return self.result is not None

    @property
    def faulted(self) -> bool:
        return self.fault is not None

    def _check_attached(self):
        if self.fault is not None:
            raise self.fault
        if self.detached and not self.done:
            raise RuntimeError(
                f"session {self.sid}: engine was reset; session detached")

    def push(self, data):
        """Stream input into the session (audio chunk / token prompt)."""
        self._check_attached()
        if self.finished:
            raise RuntimeError(f"session {self.sid}: push after finish()")
        self._engine._push(self, data)
        return self

    def poll(self) -> dict:
        """Drive the engine and return this session's current output."""
        self._check_attached()
        out = self._engine._poll(self)
        if self.fault is not None:     # faulted during this very drive
            raise self.fault
        return out

    def finish(self, wait: bool = True) -> Optional[dict]:
        """End-of-input: flush, finalize, free the slot.  Returns the
        final result, or None if the session is still queued behind
        unfinished sessions (poll() later to collect it).  wait=False
        only marks end-of-input without driving the engine — the
        network front-end uses it so its dedicated engine thread keeps
        sole ownership of the step loop."""
        self._check_attached()
        self.finished = True
        self._engine.metrics.on_finish(self)
        if wait:
            self._engine._advance()
            if self.fault is not None:  # faulted during this very drive
                raise self.fault
        return None if self.result is None else copy_result(self.result)

    def __repr__(self):
        state = ("done" if self.done else
                 "active" if self.admitted else "queued")
        return f"<Session {self.sid} {state}>"


class Engine:
    """Slot pool + admission queue; see module docstring for the split
    between this base and the AsrEngine/LmEngine slot mechanics."""

    def __init__(self, config):
        self.config = config
        self.n_slots: int = config.n_slots
        self.max_queue: Optional[int] = getattr(config, "max_queue", None)
        self.session_deadline: Optional[float] = getattr(
            config, "session_deadline", None)
        self._faults = getattr(config, "faults", None)
        self._fault_log: List[dict] = []   # bounded by _fault_session
        self.n_steps = 0               # fused steps taken since reset
        self._queue = SessionQueue()
        self._owner: List[Optional[Session]] = [None] * self.n_slots
        self._next_sid = 0
        self._owner_thread = None      # set by EngineWorker (see worker_only)
        self.metrics = EngineMetrics()

    # ---- session front-end -------------------------------------------
    def open(self) -> Session:
        """Open a connection; the session queues for a slot immediately.
        With `EngineConfig.max_queue` set, a full queue while every slot
        is busy raises `AdmissionRejected` (typed backpressure) instead
        of queueing unboundedly."""
        if (self.max_queue is not None
                and len(self._queue) >= self.max_queue
                and all(o is not None for o in self._owner)):
            self.metrics.on_reject()
            raise AdmissionRejected(len(self._queue), self.max_queue)
        s = Session(self, self._next_sid)
        self._next_sid += 1
        self._queue.append(s)
        self.metrics.on_open(s)
        self.metrics.sample_queue_depth(len(self._queue))
        self._admit()
        return s

    def _push(self, session: Session, data) -> None:
        raise NotImplementedError

    def _poll(self, session: Session) -> dict:
        raise NotImplementedError

    def execute(self, op: str, session: Optional[Session] = None,
                data=None):
        """Apply the named command `op` (one of `COMMANDS`):

          open              -> the new Session (AdmissionRejected when full)
          push(session, data)   buffer an input chunk
          poll(session)     -> its live readout; does not drive the pump
          finish(session)      end of input (`finish(wait=False)`)
          pump              -> one pump round without deadline reaps (bool)
          reap(data = sids) -> fault those of the sids still live (bool)
          fail_all(data = cause or its text): quarantine the pool

        Its outcome depends only on the engine's host state and the
        arguments, so the same commands in the same order leave every
        copy of an engine in the same state."""
        if op == "open":
            return self.open()
        if op == "push":
            return session.push(data)
        if op == "poll":
            return self._readout(session)
        if op == "finish":
            return session.finish(wait=False)
        if op == "pump":
            return self._pump_once(by_clock=False)
        if op == "reap":
            return self._reap(data)
        if op == "fail_all":
            return self._fail_all(data if isinstance(data, BaseException)
                                  else RuntimeError(data))
        raise ValueError(f"unknown engine command {op!r}")

    def _readout(self, session: Session) -> dict:
        """A session's current output WITHOUT driving the engine (the
        network poll: the worker's pump loop owns stepping)."""
        raise NotImplementedError

    def _digest(self) -> tuple:
        """The host state every copy of a mesh's engine must hold alike
        after the same commands: sid counter, steps, faults, the queue's
        and the slots' sessions."""
        return (self._next_sid, self.n_steps, len(self._fault_log),
                tuple(s.sid for s in self._queue),
                tuple(-1 if o is None else o.sid for o in self._owner))

    # ---- the serve loop ----------------------------------------------
    @worker_only
    def _advance(self) -> None:
        """Admit -> step -> harvest until no progress is possible."""
        while self._pump_once():
            pass

    @worker_only
    def _pump_once(self, by_clock: bool = True) -> bool:
        """One quarantined admit -> step -> harvest round (the unit both
        `_advance` and the network `EngineWorker` loop drive).

        Fault containment is layered: the subclasses attribute step /
        prefill failures to a single session where possible (bisection
        retry in `AsrEngine._step_isolated` / `LmEngine._prefill_group`)
        and evict only it; anything that still escapes here is an
        UNATTRIBUTABLE pool failure — the pool state can no longer be
        trusted, so every live session is faulted and the pool is
        rebuilt (`_fail_all`).  Either way the pump survives: one bad
        session or one bad round never kills the serve loop.
        `BaseException`s (worker shutdown, injected `WorkerKilled`) pass
        through — those model thread death, which only the worker
        supervisor may handle.

        The round ends with the deadline reaps by this engine's clock,
        unless `by_clock` is False: under a mesh, rank 0's clock decides
        them and they arrive as a separate `reap` command."""
        try:
            did = self._admit()
            did |= self._step()
            did |= self._harvest()
        except Exception as exc:
            self._fail_all(exc)
            did = False
        reaped = self._reap_deadlines() if by_clock else False
        return reaped or did

    @worker_only
    def _fault_session(self, sess: Session, exc: SessionFaulted,
                       release: bool = True) -> None:
        """Evict ONE session with a typed fault: remove it from the
        queue or its slot, record the fault on the handle (push/poll/
        finish raise it; done-watchers resolve with it), and — when the
        pool state is still trustworthy — release the slot for reuse.
        `release=False` is the whole-pool quarantine path, where
        `_fail_all` rebuilds the pool instead of touching per-slot
        state that may itself be corrupt."""
        sess.fault = exc
        if sess in self._queue:
            self._queue.remove(sess)
        slot = sess.slot
        sess.slot = None
        if slot is not None:
            self._owner[slot] = None
            if release:
                self._release_slot(slot)
        if len(self._fault_log) < 4096:     # bounded forensic record
            self._fault_log.append({
                "sid": sess.sid, "slot": slot, "reason": exc.reason,
                "deadline": isinstance(exc, DeadlineExceeded)})
        if isinstance(exc, DeadlineExceeded):
            self.metrics.on_deadline(sess)
        else:
            self.metrics.on_fault(sess)
        self.metrics.sample_queue_depth(len(self._queue))

    @worker_only
    def _fail_all(self, cause: BaseException) -> None:
        """Unattributable pump failure: fault every live session and
        rebuild the pool from scratch.  Per-slot release is skipped —
        the failure may have corrupted arbitrary pool state, so nothing
        short of `_reset_pool` is safe to trust afterwards."""
        for sess in self._live():
            self._fault_session(
                sess, SessionFaulted(sess.sid,
                                     f"pool quarantined: {cause}",
                                     cause=cause),
                release=False)
        self._queue.clear()
        self._owner = [None] * self.n_slots
        self.n_steps = 0
        self._reset_pool()

    def _live(self) -> List[Session]:
        """Queued sessions, then those holding slots, in slot order."""
        return list(self._queue) + [o for o in self._owner
                                    if o is not None]

    def _overdue(self) -> List[int]:
        """Sids of the live sessions older than
        `EngineConfig.session_deadline` (open -> now, on the metrics
        clock so tests inject time), in `_live` order."""
        deadline = self.session_deadline
        if deadline is None:
            return []
        now = self.metrics._clock()
        return [s.sid for s in self._live()
                if s._t_open is not None and now - s._t_open > deadline]

    def _reap_deadlines(self) -> bool:
        """Evict the sessions this engine's clock finds overdue.  Runs
        every pump round; a stuck client or a session starved behind a
        pathological queue frees its slot/queue entry instead of
        holding it forever."""
        return self._reap(self._overdue())

    @worker_only
    def _reap(self, sids) -> bool:
        """Fault each session of `sids` still queued or holding a slot
        with `DeadlineExceeded`; True when one was."""
        want = set(sids)
        did = False
        for sess in self._live():
            if sess.sid in want:
                self._fault_session(sess, DeadlineExceeded(
                    sess.sid,
                    f"exceeded session_deadline={self.session_deadline}s"))
                did = True
        return did

    @worker_only
    def _admit(self) -> bool:
        did = False
        for slot in range(self.n_slots):
            if self._owner[slot] is None and self._queue:
                sess = next((s for s in self._queue if self._admittable(s)),
                            None)
                if sess is None:
                    break
                self._queue.remove(sess)
                self._owner[slot] = sess
                sess.slot = slot
                self._admit_to_slot(sess, slot)
                sess._pending = None
                self.metrics.on_admit(sess)
                did = True
        if did:
            self.metrics.sample_queue_depth(len(self._queue))
        return did

    @worker_only
    def _harvest(self) -> bool:
        did = False
        for slot, sess in enumerate(self._owner):
            if sess is not None and self._ready_to_close(sess, slot):
                sess.result = self._finalize_slot(slot)
                sess.slot = None
                self._owner[slot] = None
                self.metrics.on_done(sess)
                did = True
        # finished sessions that can never be admitted (e.g. an LM
        # session with no prompt) close from the queue with an empty
        # result instead of waiting forever
        for sess in [s for s in self._queue
                     if s.finished and not self._admittable(s)]:
            sess.result = self._empty_result()
            self._queue.remove(sess)
            self.metrics.on_done(sess)
            did = True
        if did:
            self.metrics.sample_queue_depth(len(self._queue))
        return did

    @worker_only
    def reset(self) -> None:
        """Drop all sessions (queued and active) and zero the pool.
        Dropped sessions are detached: their handles raise on further
        use instead of silently swallowing input."""
        for sess in list(self._queue) + self._owner:
            if sess is not None:
                sess.detached = True
                sess.slot = None
        self._queue.clear()
        self._owner = [None] * self.n_slots
        self.n_steps = 0
        self._reset_pool()

    # ---- slot mechanics (subclass responsibility) --------------------
    def _admittable(self, session: Session) -> bool:
        """Whether a queued session may take a slot now (LM sessions
        must have pushed their prompt first; ASR sessions always may)."""
        return True

    def _empty_result(self) -> dict:
        """Result for a session finished with no input at all."""
        raise NotImplementedError

    def _admit_to_slot(self, session: Session, slot: int) -> None:
        raise NotImplementedError

    def _step(self) -> bool:
        raise NotImplementedError

    def _ready_to_close(self, session: Session, slot: int) -> bool:
        raise NotImplementedError

    def _finalize_slot(self, slot: int) -> dict:
        raise NotImplementedError

    def _release_slot(self, slot: int) -> None:
        """Scrub one slot after its session was evicted mid-flight
        (fault/deadline) so the next admission sees a fresh slot."""
        raise NotImplementedError

    def _reset_pool(self) -> None:
        raise NotImplementedError
