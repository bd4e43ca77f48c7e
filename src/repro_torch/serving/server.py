"""Network serving front-end: asyncio server over the engine slot pools.

Port of `repro/serving/server.py`.  It imports numpy and the port's engine,
never the JAX package, and speaks the reference's wire protocol byte for
byte: either package's client helpers talk to either package's server.

One `EngineServer` exposes an `AsrEngine` and/or `LmEngine` over plain
HTTP/1.1 on an asyncio event loop — no third-party web framework, just
`asyncio.start_server` plus hand-rolled chunked transfer encoding (both
ends of the protocol live in this module, so the wire format only has
to be self-consistent).

Threading contract: the event loop NEVER touches an engine.  Each
engine is owned by one `EngineWorker` — a dedicated daemon thread that
executes submitted commands (open/push/finish/readout) between pump
iterations of the engine's admit -> step -> harvest loop.  Network I/O
therefore never blocks a fused decoding step and a slow fused step
never stalls accepting connections; the asyncio side bridges with
`asyncio.wrap_future` over `concurrent.futures.Future`s.

Wire protocol:

  * ``POST /asr`` with chunked request body — one streaming session.
    Each request chunk is a JSON command (``{"op": "push", "audio":
    [...]}``, ``{"op": "poll"}``, ``{"op": "finish"}``) and each
    response chunk is the JSON reply to the command in order (poll ->
    current best hypothesis; finish -> the final result).  The response
    status line is sent as soon as the session is admitted or queued,
    so rejection is visible before any audio is shipped.
  * ``POST /lm`` with a JSON body ``{"prompt": [...]}`` — one batched
    generation request; responds with the final token payload.
  * ``GET /metrics`` — JSON `EngineMetrics.snapshot()` per engine.
  * Admission backpressure (`AdmissionRejected`, i.e. the engine queue
    is at `EngineConfig.max_queue` with every slot busy) maps to a
    ``503`` JSON response carrying the observed depth and the bound;
    the client helpers raise it as `ServerRejected`.

Client helpers (`AsrClient`, `lm_generate`, `fetch_healthz`,
`fetch_metrics`) speak the same protocol.

Device: an engine on a card is built on the caller's thread and then
driven only from its `EngineWorker` thread.  PyTorch's current device is
per thread, so the worker binds its thread to the engine's card before
its first pump; the event loop never touches a tensor (everything a
worker hands back is host data: numpy arrays, lists, numbers).  The
engines' steps run under the host-sync guard
(`analysis.guards.no_implicit_transfers`), which on a card is one
setting of the process: the workers of engines on a card take turns
(`guards.card_turn`), one iteration (commands, pump round) at a time,
so that the ASR worker's guarded step never overlaps the LM worker's
readouts or prefills, nor the other way round.  A worker abandoned by
the supervisor gives up its turn and its open guard (`guards.release`).

Commands: the handlers change an engine only through the named commands
of `serving.engine.COMMANDS` (`EngineWorker.command` / `run`: open,
push, poll, finish; the supervisor's fail_all).  Thunks
(`EngineWorker.submit`) only read engine state or register done-watchers.

Mesh (`EngineServer(channel=...)`): an ASR engine sharded over a mesh of
ranks (`EngineConfig.mesh`) is served by rank 0 alone, which runs the
server, its workers and the supervisor and leads every engine decision;
every other rank runs `follow`, replaying rank 0's command stream
(`launch.mesh.CommandChannel`) on its own copy of the engine.  Each
iteration of rank 0's worker that has work sends ONE message, before it
runs it: the commands on live sessions in order, a pump round, and the
sids rank 0's clock finds past their deadline (`Engine._overdue`; no
other rank reads a clock).  So every rank applies the same commands to
the same state in the same order and makes the same collectives (the
step's all-reduces, the 'data'-axis readouts).  Each message carries a
sequence number and rank 0's outcome of the previous one (each
command's result kind and the engine's state digest), which the
followers check against their own.  An iteration that changed nothing
sends nothing; a quiet stream gets a keep-alive every
`Leader.keepalive_s`, well inside the channel's timeout, so an idle
server never ends the run.  A worker restart quarantines the pool
through the new worker's stream, so every rank quarantines at the same
point; a restart waits for the iteration in flight, and a fenced
(zombie) thread never sends.  `/metrics` and `/healthz` are rank 0's.
Failures that only some ranks see cannot be mended in SPMD: a follower
that loses rank 0, falls out of step or fails a replay raises
`FollowerFailed` (its launcher exits non-zero), and a rank 0 whose
stream breaks stops serving (`EngineServer.fatal`).
"""
from __future__ import annotations

import asyncio
import concurrent.futures
import contextlib
import json
import queue
import random
import threading
import time
import warnings
from typing import Callable, List, Optional, Tuple

import numpy as np

import torch

from repro_torch.analysis import guards
from repro_torch.serving.engine import (COMMANDS, AdmissionRejected, Engine,
                                        SessionFaulted, check_owner,
                                        copy_result)
from repro_torch.serving.faults import WorkerKilled


# ---- JSON payloads ----------------------------------------------------

def jsonable(x):
    """Result payloads carry numpy arrays/scalars; the wire carries
    JSON.  Both ends are Python's json module, so non-finite floats
    (-inf hypothesis scores) survive as ``-Infinity`` literals."""
    if isinstance(x, dict):
        return {k: jsonable(v) for k, v in x.items()}
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, np.generic):
        return x.item()
    if isinstance(x, (list, tuple)):
        return [jsonable(v) for v in x]
    return x


class ProtocolError(ValueError):
    """Malformed bytes on the wire (garbage chunk-size line, unparsable
    status line, bad content-length).  A `ValueError` subclass so
    callers that already guard ValueError keep working, but typed so
    the server can answer 400 where a response is still possible
    instead of leaking an unretrieved task exception."""


# ---- chunked-transfer framing ----------------------------------------

async def _write_chunk(writer: asyncio.StreamWriter, data: bytes) -> None:
    writer.write(b"%x\r\n" % len(data) + data + b"\r\n")
    await writer.drain()


async def _write_last_chunk(writer: asyncio.StreamWriter) -> None:
    writer.write(b"0\r\n\r\n")
    await writer.drain()


async def _read_chunk(reader: asyncio.StreamReader) -> Optional[bytes]:
    """One chunk of a chunked body; None on the terminating 0-chunk."""
    line = await reader.readline()
    if not line:
        raise ConnectionError("peer closed mid-stream")
    try:
        n = int(line.strip().split(b";")[0], 16)
    except (ValueError, IndexError):
        raise ProtocolError(
            f"malformed chunk-size line: {line[:64]!r}") from None
    if n == 0:
        await reader.readline()        # blank line after last-chunk
        return None
    data = await reader.readexactly(n)
    await reader.readexactly(2)        # trailing \r\n
    return data


async def _read_head(reader: asyncio.StreamReader) -> Tuple[str, dict]:
    """Request/response head: first line + lowercased header dict."""
    head = await reader.readuntil(b"\r\n\r\n")
    lines = head.decode("latin-1").split("\r\n")
    headers = {}
    for ln in lines[1:]:
        if ":" in ln:
            k, v = ln.split(":", 1)
            headers[k.strip().lower()] = v.strip()
    return lines[0], headers


async def _read_sized_body(reader: asyncio.StreamReader,
                           headers: dict) -> bytes:
    try:
        n = int(headers.get("content-length", 0))
    except ValueError:
        raise ProtocolError(
            "malformed content-length: "
            f"{headers.get('content-length')!r}") from None
    return await reader.readexactly(n)


_STATUS = {200: "OK", 400: "Bad Request", 404: "Not Found",
           500: "Internal Server Error", 503: "Service Unavailable"}


def _head_bytes(status: int, chunked: bool,
                content_length: Optional[int] = None) -> bytes:
    lines = [f"HTTP/1.1 {status} {_STATUS[status]}",
             "Content-Type: application/json"]
    if chunked:
        lines.append("Transfer-Encoding: chunked")
    else:
        lines.append(f"Content-Length: {content_length}")
        lines.append("Connection: close")
    return ("\r\n".join(lines) + "\r\n\r\n").encode()


async def _respond_json(writer: asyncio.StreamWriter, status: int,
                        payload: dict) -> None:
    body = json.dumps(jsonable(payload)).encode()
    writer.write(_head_bytes(status, chunked=False,
                             content_length=len(body)) + body)
    await writer.drain()


# ---- the engine thread -----------------------------------------------

class WorkerDied(RuntimeError):
    """Typed error resolved into every in-flight future/watcher of an
    `EngineWorker` whose thread died or wedged: the callers' work was
    lost, not merely delayed, and they must not wait on the old
    thread."""


class _Command:
    """A named engine command (`engine.COMMANDS`) queued on a worker;
    `session` is the handle it acts on (None for open and fail_all)."""
    __slots__ = ("op", "session", "data")

    def __init__(self, op: str, session=None, data=None):
        if op not in COMMANDS:
            raise ValueError(f"unknown engine command {op!r}")
        self.op, self.session, self.data = op, session, data

    def __call__(self, engine: Engine):
        return engine.execute(self.op, self.session, self.data)

    def ended(self) -> bool:
        """Whether it acts on a session that has ended (done, faulted or
        detached): such a command reads only the handle and changes no
        engine state."""
        s = self.session
        return s is not None and (s.done or s.fault is not None
                                  or s.detached)

    def wire(self) -> tuple:
        """(op, sid, data) as the other ranks replay it (a cause as its
        text)."""
        data = (str(self.data) if isinstance(self.data, BaseException)
                else self.data)
        return (self.op, None if self.session is None else self.session.sid,
                data)


class Leader:
    """Rank 0's end of a mesh's command stream: the `CommandChannel` its
    other ranks replay (`follow`), kept across worker restarts.  `lock`
    is held by a worker's iteration while it sends and runs a message,
    so a supervisor restart (which takes it too) never lands inside one,
    and a thread fenced out by the restart never sends.  `check` is the
    outcome of the last message, sent with the next.  A stream quiet for
    `keepalive_s` (a quarter of the channel's timeout) gets a keep-alive
    from the next idle iteration.  `failure` holds the error that broke
    the stream; `stats` counts command messages, their commands and
    bytes, keep-alives, and the seconds spent sending them all."""

    def __init__(self, engine: Engine, channel):
        self.engine = engine
        self.channel = channel
        self.keepalive_s = channel.timeout_s / 4
        self.lock = threading.Lock()
        self.check = None
        self.failure: Optional[BaseException] = None
        self.stopped = False
        self._last = time.monotonic()
        self.stats = {"messages": 0, "commands": 0, "bytes": 0,
                      "keepalives": 0, "send_s": 0.0}

    def send(self, cmds: list) -> None:
        """(lock held) One message of `cmds`, each (op, sid, data)."""
        self.stats["bytes"] += self._send("cmds", cmds)
        self.stats["messages"] += 1
        self.stats["commands"] += len(cmds)

    def keepalive_if_quiet(self) -> None:
        """(lock held) A keep-alive when nothing went out for
        `keepalive_s`."""
        if time.monotonic() - self._last >= self.keepalive_s:
            self._send("alive")
            self.stats["keepalives"] += 1

    def stop(self) -> bool:
        """Send the stop message (the followers return), once; a thread
        fenced out of the engine sends nothing.  True once stopped."""
        with self.lock:
            owner = self.engine._owner_thread
            if (not self.stopped and self.failure is None
                    and owner in (None, threading.current_thread())):
                self._send("stop")
                self.stopped = True
            return self.stopped

    def _send(self, kind: str, cmds=()) -> int:
        if self.stopped:
            raise RuntimeError("the mesh's command stream was stopped")
        t0 = time.monotonic()
        try:
            n = self.channel.send((kind, list(cmds), self.check))
        except Exception as exc:
            self.failure = exc
            raise
        self._last = time.monotonic()
        self.stats["send_s"] += self._last - t0
        return n


class FollowerFailed(RuntimeError):
    """A rank replaying rank 0's command stream lost it or fell out of
    step with it: rank 0 is gone, the stream broke its order, a command
    named a session this rank does not hold, a command's outcome or the
    engine's state differs from rank 0's, or the replay raised.  The
    message names the rank, the message's sequence number and its
    commands."""


def follow(engine: Engine, channel) -> dict:
    """Replay rank 0's command stream on this rank's copy of `engine`
    (every rank but the channel's source runs this while rank 0 serves)
    until rank 0's stop message; returns counts of messages, commands
    and keep-alives.

    Each message's commands run in order on the sessions this rank holds
    by sid (a session leaves the map once it has ended: rank 0 sends no
    command for it after that).  A command's own error (a full queue, a
    rejected chunk) is its outcome, as on rank 0; the next message
    carries rank 0's outcomes and state digest, which must equal this
    rank's.  Anything else raises `FollowerFailed`."""
    rank = channel.rank
    sessions: dict = {}
    mine, last, errors = None, [], []
    stats = {"messages": 0, "commands": 0, "keepalives": 0}
    while True:
        try:
            kind, cmds, check = channel.recv()
        except Exception as exc:
            raise FollowerFailed(
                f"rank {rank}: lost rank 0's command stream after message "
                f"{channel.seq}: {exc!r}") from exc
        seq = channel.seq
        if check != mine:
            raise FollowerFailed(
                f"rank {rank}: message {seq - 1} {last} left this rank at "
                f"{mine}, rank 0 at {check}"
                + (f"; this rank's errors: {errors}" if errors else ""))
        if kind == "stop":
            return stats
        if kind == "alive":
            stats["keepalives"] += 1
            continue
        if kind != "cmds":
            raise FollowerFailed(f"rank {rank}: message {seq} of unknown "
                                 f"kind {kind!r}")
        outcomes, errors = [], []
        last = [(op, sid) for op, sid, _ in cmds]
        for op, sid, data in cmds:
            if sid is not None and sid not in sessions:
                raise FollowerFailed(
                    f"rank {rank}: message {seq}: {op} names session {sid}, "
                    f"which this rank does not hold")
            try:
                out = engine.execute(op, sessions.get(sid), data)
            except Exception as exc:
                if op in ("pump", "reap"):
                    raise FollowerFailed(
                        f"rank {rank}: message {seq}: {op} raised "
                        f"{exc!r}") from exc
                outcomes.append(type(exc).__name__)
                errors.append(f"{op}({sid}): {exc!r}")
                continue
            if op in ("pump", "reap"):
                outcomes.append(bool(out))
                continue
            outcomes.append("ok")
            if op == "open":
                sessions[out.sid] = out
        mine = (tuple(outcomes), engine._digest())
        for sid in [sid for sid, x in sessions.items()
                    if x.done or x.fault is not None or x.detached]:
            del sessions[sid]
        stats["messages"] += 1
        stats["commands"] += len(cmds)


def takes_turns(engine: Engine) -> bool:
    """Whether `engine`'s worker takes turns on the card with the other
    workers of the process: an engine on a card, where the host-sync
    guard of its steps is the process's sync debug mode."""
    device = getattr(engine, "device", None)
    return device is not None and device.type == "cuda"


class EngineWorker:
    """Dedicated thread owning ONE engine: the only code that ever calls
    into the engine.  Submitted commands (`command`: the engine's named
    commands; `submit`: thunks that only read) run between pump
    iterations of admit -> step -> harvest, and registered done-watchers
    resolve as soon as their session's result is harvested — so a
    finish command plus a watcher replaces the in-process blocking
    `finish()` without the network side ever driving the step loop.
    With a `leader` (rank 0 of a mesh) every iteration goes out on the
    mesh's command stream first (`_lead`).

    Liveness contract: `heartbeat` is bumped once per loop iteration;
    `EngineServer._supervise` reads `heartbeat_age()` + `is_alive()` to
    detect a wedged or dead worker and restart it.  A crashing thread
    fails its own in-flight futures on the way out (`_crash`) so no
    caller ever blocks on a thread that will never run again, and
    `submit` fast-fails once the worker is known dead."""

    def __init__(self, engine: Engine, name: str = "engine-worker",
                 idle_wait: float = 0.02, leader: Optional[Leader] = None):
        self.engine = engine
        self.leader = leader
        self._idle_wait = idle_wait
        self._cmds: queue.SimpleQueue = queue.SimpleQueue()
        self._watchers: List[Tuple[object, concurrent.futures.Future]] = []
        self._stopping = threading.Event()
        self._dead = False
        self._death: Optional[BaseException] = None
        self.heartbeat = time.monotonic()
        self._thread = threading.Thread(target=self._run, name=name,
                                        daemon=True)
        # claim the engine: @worker_only methods now refuse every other
        # thread (claimed before start so no pump can beat the claim).
        # On a supervisor restart this RECLAIMS the engine from the
        # dead/wedged predecessor — if that thread ever wakes again, its
        # next engine call raises instead of racing the new owner.
        engine._owner_thread = self._thread
        self._thread.start()

    @property
    def name(self) -> str:
        return self._thread.name

    def is_alive(self) -> bool:
        return self._thread.is_alive() and not self._dead

    def heartbeat_age(self) -> float:
        return time.monotonic() - self.heartbeat

    # -- submission (any thread) --
    def submit(self, fn: Callable[[Engine], object]
               ) -> concurrent.futures.Future:
        fut: concurrent.futures.Future = concurrent.futures.Future()
        if self._dead:
            fut.set_exception(self._death)
            return fut
        self._cmds.put((fn, fut))
        if self._dead:
            # lost race with a concurrent crash: the dying thread may
            # have drained before our put landed, so drain again
            self._fail_pending(self._death)
        return fut

    async def call(self, fn: Callable[[Engine], object]):
        return await asyncio.wrap_future(self.submit(fn))

    def command(self, op: str, session=None,
                data=None) -> concurrent.futures.Future:
        """Submit the engine's named command `op` (`engine.COMMANDS`) on
        `session` with `data`."""
        return self.submit(_Command(op, session, data))

    async def run(self, op: str, session=None, data=None):
        return await asyncio.wrap_future(self.command(op, session, data))

    def watch_done(self, session) -> concurrent.futures.Future:
        """Future resolving with a defensive copy of `session.result`
        once the engine harvests it (exception if the session faults or
        is detached by a reset first)."""
        fut: concurrent.futures.Future = concurrent.futures.Future()
        reg = self.submit(lambda eng: self._watchers.append((session, fut)))

        def _propagate(rf: concurrent.futures.Future) -> None:
            # registration itself failed (dead worker): the watcher
            # would otherwise never resolve
            exc = None if rf.cancelled() else rf.exception()
            if exc is not None and not fut.done():
                fut.set_exception(exc)

        reg.add_done_callback(_propagate)
        return fut

    def close(self, timeout: float = 5.0) -> None:
        self._stopping.set()
        self._thread.join(timeout=timeout)
        if self._thread.is_alive():
            # wedged: the join timed out.  KEEP the engine ownership
            # claim — releasing it would let other threads race a pump
            # that may still wake up — and say so instead of silently
            # leaking the thread.
            warnings.warn(
                f"EngineWorker thread {self._thread.name!r} did not stop "
                f"within {timeout}s; leaking it with the engine ownership "
                "claim held so worker_only keeps fencing the pool",
                RuntimeWarning, stacklevel=2)
            return
        if self.engine._owner_thread is self._thread:
            self.engine._owner_thread = None   # release for in-process use

    def abandon(self, exc: BaseException) -> None:
        """Supervisor path: declare this worker lost.  Marks it dead
        (submit fast-fails), asks a merely-wedged thread to exit when
        it wakes, and fails every in-flight future/watcher with `exc`
        so no caller waits on work that will never run."""
        self._death = exc
        self._dead = True
        self._stopping.set()
        # a thread wedged inside a step holds its turn on the card and
        # its open guard: both would outlive it
        guards.release(self._thread)
        self._fail_pending(exc)

    def _fail_pending(self, exc: BaseException) -> None:
        while True:
            try:
                _, fut = self._cmds.get_nowait()
            except queue.Empty:
                break
            if fut.set_running_or_notify_cancel():
                fut.set_exception(exc)
        for _, fut in list(self._watchers):
            if not fut.done():
                fut.set_exception(exc)
        self._watchers = []

    # -- the loop (worker thread only) --
    def _run(self) -> None:
        try:
            # PyTorch's current device is per thread: launch on the
            # engine's card, whichever thread built the engine
            device = getattr(self.engine, "device", None)
            if device is not None and device.type == "cuda":
                torch.cuda.set_device(device)
            busy = False
            while not self._stopping.is_set():
                busy = (self._iterate(busy) if self.leader is None
                        else self._lead(busy))
                self._resolve_watchers()
                self.heartbeat = time.monotonic()
            self._drain_on_stop()
            if self.leader is not None:
                self.leader.stop()
        except BaseException as exc:
            # the pump itself died (per-session faults are contained
            # inside Engine._pump_once; what reaches here is thread
            # death — e.g. an injected WorkerKilled, or a broken mesh
            # command stream).  Fail in-flight work on the way out so
            # nobody blocks on this thread.
            self._crash(exc)

    def _iterate(self, busy: bool) -> bool:
        """One iteration: the queued items in order, then a pump round,
        on the card's turn."""
        try:
            item = self._cmds.get(timeout=0.001 if busy else self._idle_wait)
        except queue.Empty:
            item = None
        with self._card_turn():
            while item is not None:
                self._exec(*item)
                try:
                    item = self._cmds.get_nowait()
                except queue.Empty:
                    item = None
            return self._pump()

    def _card_turn(self):
        """The card's turn for one iteration (`guards.card_turn`), for an
        engine on a card; waiting for it is not being wedged, so the wait
        keeps the heartbeat."""
        if not takes_turns(self.engine):
            return contextlib.nullcontext()
        return guards.card_turn(self._beat)

    def _beat(self) -> None:
        self.heartbeat = time.monotonic()

    def _lead(self, busy: bool) -> bool:
        """One iteration of rank 0's worker on a mesh.  The pump's fault
        check comes first (rank 0's alone, outside the stream); then,
        under the leader's lock and the ownership fence, the queued
        commands on live sessions, a pump round and the sids rank 0's
        clock finds overdue go out as ONE message before rank 0 runs
        them, so the other ranks make the same collectives beside it.
        Thunks and commands on ended sessions run here alone.  With no
        such command, no overdue sid and a last pump round that did
        nothing, the state cannot change: nothing is sent (a keep-alive
        when the stream has been quiet), nothing pumped."""
        faults = getattr(self.engine, "_faults", None)
        if faults is not None:
            faults.check("pump", worker=self._thread.name)
        items = self._take(0.001 if busy else self._idle_wait)
        try:
            with self._card_turn():
                return self._lead_items(items, busy)
        except BaseException as exc:
            # the stream broke or the thread was fenced out: the items it
            # claimed will never run
            lost = WorkerDied(f"engine worker {self._thread.name!r} lost "
                              f"its command stream: {exc!r}")
            for _, fut in items:
                if not fut.done():
                    fut.set_exception(lost)
            raise

    def _lead_items(self, items: list, busy: bool) -> bool:
        eng, leader = self.engine, self.leader
        with leader.lock:
            check_owner(eng, "execute")
            sent = [isinstance(fn, _Command) and not fn.ended()
                    for fn, _ in items]
            reap = eng._overdue()
            if not (any(sent) or reap or busy):
                for fn, fut in items:
                    self._call(fn, fut)
                leader.keepalive_if_quiet()
                return False
            leader.send([fn.wire() for (fn, _), out in zip(items, sent)
                         if out] + [("pump", None, None)]
                        + ([("reap", None, reap)] if reap else []))
            outcomes = []
            for (fn, fut), out in zip(items, sent):
                exc = self._call(fn, fut)
                if out:
                    outcomes.append("ok" if exc is None
                                    else type(exc).__name__)
            busy = bool(eng.execute("pump"))
            outcomes.append(busy)
            if reap:
                outcomes.append(bool(eng.execute("reap", data=reap)))
                busy = True
            leader.check = (tuple(outcomes), eng._digest())
        return busy

    def _take(self, timeout: float) -> list:
        """The queued (item, future) pairs, waiting up to `timeout` for
        the first; each future is claimed (set running), and one its
        caller already cancelled is dropped, so every item taken runs."""
        items = []
        try:
            item = self._cmds.get(timeout=timeout)
            while True:
                if item[1].set_running_or_notify_cancel():
                    items.append(item)
                item = self._cmds.get_nowait()
        except queue.Empty:
            pass
        return items

    def _crash(self, cause: BaseException) -> None:
        self._death = WorkerDied(
            f"engine worker {self._thread.name!r} died: {cause!r}")
        self._death.__cause__ = cause
        self._dead = True
        self._fail_pending(self._death)

    def _exec(self, fn, fut: concurrent.futures.Future) -> None:
        if fut.set_running_or_notify_cancel():
            self._call(fn, fut)

    def _call(self, fn, fut: concurrent.futures.Future
              ) -> Optional[BaseException]:
        """Run a claimed item; returns the error it resolved its future
        with, if any."""
        try:
            fut.set_result(fn(self.engine))
        except WorkerKilled as exc:
            # injected thread death must kill the LOOP, not the thunk —
            # resolve the future with the typed death first so its
            # awaiter is not left hanging
            fut.set_exception(WorkerDied(
                f"engine worker {self._thread.name!r} died: {exc!r}"))
            raise
        except BaseException as exc:          # typed errors cross the bridge
            fut.set_exception(exc)
            return exc
        return None

    def _pump(self) -> bool:
        faults = getattr(self.engine, "_faults", None)
        if faults is not None:
            faults.check("pump", worker=self._thread.name)
        return self.engine._pump_once()

    def _resolve_watchers(self) -> None:
        if not self._watchers:
            return
        keep = []
        for sess, fut in self._watchers:
            if sess.done:
                fut.set_result(copy_result(sess.result))
            elif sess.fault is not None:
                fut.set_exception(sess.fault)
            elif sess.detached:
                fut.set_exception(RuntimeError(
                    f"session {sess.sid}: engine reset before finalize"))
            else:
                keep.append((sess, fut))
        self._watchers = keep

    def _drain_on_stop(self) -> None:
        self._fail_pending(RuntimeError("engine worker stopped"))


# ---- the server -------------------------------------------------------

class EngineServer:
    """Asyncio front-end over an `AsrEngine` and/or `LmEngine` (each on
    its own `EngineWorker` thread).  `await start()` binds the socket
    (port 0 picks a free port, read back from `.port`); `await
    aclose()` stops the listener and the workers — `aclose(drain=True)`
    first lets in-flight connections finish and the engines go
    quiescent (graceful drain: no admitted session loses its result).

    Supervision: a background task watches each worker's thread
    liveness and heartbeat age (`EngineConfig.worker_watchdog`); a dead
    or wedged worker has its in-flight futures failed with `WorkerDied`,
    its engine's pool quarantined and rebuilt, and a fresh worker
    thread started in its place.  `GET /healthz` reports 200/503 with
    per-engine heartbeat ages.

    `asr_idle_timeout` bounds how long `/asr` waits for the next
    command chunk: a silent client gets an in-stream error chunk and
    its slot freed instead of holding the pool hostage.

    `channel` (rank 0 of a mesh; `launch.mesh.make_channel` over the
    ASR engine's mesh ranks) makes the ASR worker lead the mesh (see the
    module docstring); an ASR engine on a mesh of several ranks needs
    it, and its `worker_watchdog` must stay under half the channel's
    timeout (a wedged worker sends no keep-alive).  If the stream
    breaks, the server stops listening and `fatal` says why."""

    def __init__(self, asr_engine: Optional[Engine] = None,
                 lm_engine: Optional[Engine] = None,
                 host: str = "127.0.0.1", port: int = 0,
                 asr_idle_timeout: Optional[float] = None,
                 watch_interval: float = 0.1, channel=None):
        if asr_engine is None and lm_engine is None:
            raise ValueError("EngineServer needs at least one engine")
        mesh = getattr(getattr(asr_engine, "config", None), "mesh", None)
        ranks = (() if mesh is None or mesh.size < 2
                 else mesh.axis(tuple(mesh.axis_names)).ranks)
        if ranks and (channel is None or channel.ranks != ranks
                      or not channel.is_source):
            raise ValueError(
                f"an ASR engine on a mesh of ranks {ranks} is served by "
                f"the first of them with a command channel over them "
                f"(launch.mesh.make_channel), which the others follow; "
                f"got {None if channel is None else channel.ranks}")
        if channel is not None and not ranks:
            raise ValueError("a command channel leads an ASR engine on a "
                             "mesh of several ranks; this one has none")
        watchdog = getattr(getattr(asr_engine, "config", None),
                           "worker_watchdog", None)
        if ranks and watchdog is not None and \
                watchdog >= channel.timeout_s / 2:
            raise ValueError(
                f"worker_watchdog={watchdog}s must stay under half the "
                f"command channel's timeout ({channel.timeout_s}s): the "
                f"other ranks wait on a wedged worker until its restart")
        self._leader = (Leader(asr_engine, channel) if channel is not None
                        else None)
        self.fatal: Optional[str] = None
        self._asr_engine = asr_engine
        self._lm_engine = lm_engine
        self.host = host
        self.port = port
        self.asr_idle_timeout = asr_idle_timeout
        self._watch_interval = watch_interval
        self._asr_worker: Optional[EngineWorker] = None
        self._lm_worker: Optional[EngineWorker] = None
        self._server: Optional[asyncio.AbstractServer] = None
        self._supervisor: Optional[asyncio.Task] = None
        self._conns: set = set()
        self._restarts = {"asr": 0, "lm": 0}
        self._draining = False
        self._closing = False

    def _workers(self):
        for role in ("asr", "lm"):
            worker = getattr(self, f"_{role}_worker")
            if worker is not None:
                yield role, worker

    async def start(self) -> "EngineServer":
        if self._asr_engine is not None:
            self._asr_worker = EngineWorker(self._asr_engine, "asr-worker",
                                            leader=self._leader)
        if self._lm_engine is not None:
            self._lm_worker = EngineWorker(self._lm_engine, "lm-worker")
        self._server = await asyncio.start_server(self._handle, self.host,
                                                  self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        self._supervisor = asyncio.create_task(self._supervise())
        return self

    # -- worker supervision --
    async def _supervise(self) -> None:
        """Detect dead/wedged workers and restart them.  A dead thread
        (`is_alive()` False outside a clean close) restarts
        immediately; a wedged one only when its heartbeat outages the
        engine's `worker_watchdog` (None = wedge detection off).  A
        broken mesh command stream is fatal: no restart can bring the
        ranks back into step, so the server stops listening."""
        while not self._closing:
            await asyncio.sleep(self._watch_interval)
            for role, worker in list(self._workers()):
                if self._closing:
                    return
                if worker.leader is not None and \
                        worker.leader.failure is not None:
                    self.fatal = (f"the mesh's command stream broke: "
                                  f"{worker.leader.failure!r}")
                    self._server.close()
                    return
                watchdog = getattr(worker.engine.config,
                                   "worker_watchdog", None)
                if not worker.is_alive():
                    self._watchdog_restart(role, worker, "thread died")
                elif (watchdog is not None
                      and worker.heartbeat_age() > watchdog):
                    self._watchdog_restart(
                        role, worker,
                        f"wedged: heartbeat {worker.heartbeat_age():.2f}s "
                        f"> worker_watchdog={watchdog}s")

    def _watchdog_restart(self, role: str, old: EngineWorker,
                          why: str) -> None:
        """Replace a lost worker: fail its in-flight work, reclaim the
        engine from the old thread, start a fresh worker (whose
        construction takes the ownership claim — a wedged old thread
        that wakes later is fenced out by worker_only), and quarantine
        the pool through the NEW worker so in-flight sessions resolve
        with a typed fault instead of hanging (on a mesh: through its
        command stream, so every rank quarantines at the same point).  A
        leading worker inside an iteration holds the leader's lock: the
        restart waits for the next supervision tick."""
        leader = old.leader
        if leader is not None and not leader.lock.acquire(blocking=False):
            return
        try:
            eng = old.engine
            exc = WorkerDied(f"{role} engine worker {old.name!r} {why}")
            old.abandon(exc)
            eng._owner_thread = None      # reclaim from the lost thread
            self._restarts[role] += 1
            new = EngineWorker(
                eng, f"{role}-worker-r{self._restarts[role]}",
                leader=leader)
            new.command("fail_all", data=exc)
            setattr(self, f"_{role}_worker", new)
            eng.metrics.on_worker_restart()
        finally:
            if leader is not None:
                leader.lock.release()

    # -- shutdown --
    async def aclose(self, drain: bool = False,
                     timeout: Optional[float] = None) -> None:
        """Stop the server.  `drain=True` stops ACCEPTING first, then
        waits for in-flight connections to complete and the engines to
        go quiescent (every admitted/queued session harvested) before
        stopping the workers — no result is lost.  `timeout` bounds the
        drain wait (None = wait as long as the clients take)."""
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
        if drain:
            self._draining = True
            await self._drain(timeout)
        self._closing = True
        if self._supervisor is not None:
            self._supervisor.cancel()
            try:
                await self._supervisor
            except asyncio.CancelledError:
                pass
            self._supervisor = None
        for _, worker in self._workers():
            worker.close()
        # a worker that exits cleanly stops the mesh's stream itself; one
        # that died did not
        if self._leader is not None and not self._leader.stop() \
                and self.fatal is None:
            self.fatal = ("the mesh's command stream could not be "
                          "stopped: " + (repr(self._leader.failure)
                                         if self._leader.failure
                                         else "the ASR worker is wedged"))

    async def _drain(self, timeout: Optional[float]) -> None:
        deadline = (None if timeout is None
                    else asyncio.get_running_loop().time() + timeout)

        def remaining():
            if deadline is None:
                return None
            return max(0.0, deadline - asyncio.get_running_loop().time())

        conns = {t for t in self._conns if t is not asyncio.current_task()}
        if conns:
            await asyncio.wait(conns, timeout=remaining())
        for _, worker in self._workers():
            while worker.is_alive():
                if await worker.call(
                        lambda eng: not eng._queue
                        and all(o is None for o in eng._owner)):
                    break
                if deadline is not None and remaining() == 0.0:
                    break
                await asyncio.sleep(0.01)

    async def serve_forever(self) -> None:
        assert self._server is not None, "call start() first"
        await self._server.serve_forever()

    # -- connection handling --
    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        task = asyncio.current_task()
        if task is not None:
            self._conns.add(task)   # aclose(drain=True) awaits these
        try:
            first, headers = await _read_head(reader)
            parts = first.split()
            method, path = (parts[0], parts[1]) if len(parts) >= 2 else \
                ("", "")
            if method == "POST" and path == "/asr":
                await self._handle_asr(reader, writer)
            elif method == "POST" and path == "/lm":
                await self._handle_lm(reader, writer, headers)
            elif method == "GET" and path == "/metrics":
                await self._handle_metrics(writer)
            elif method == "GET" and path == "/healthz":
                await self._handle_healthz(writer)
            else:
                await _respond_json(writer, 404, {"error": "not found"})
        except (ConnectionError, asyncio.IncompleteReadError,
                asyncio.LimitOverrunError):
            pass                    # client went away mid-request
        except ProtocolError as exc:
            # garbage bytes in the framing (chunk-size line,
            # content-length): answer 400 if the head has not been
            # committed yet; if it has, the connection just closes
            try:
                await _respond_json(writer, 400, {"error": str(exc)})
            except (ConnectionError, OSError):
                pass
        finally:
            if task is not None:
                self._conns.discard(task)
            try:
                writer.close()
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass

    async def _handle_asr(self, reader: asyncio.StreamReader,
                          writer: asyncio.StreamWriter) -> None:
        worker = self._asr_worker
        if worker is None:
            await _respond_json(writer, 404, {"error": "no ASR engine"})
            return
        try:
            sess = await worker.run("open")
        except AdmissionRejected as exc:
            await _respond_json(writer, 503, {
                "error": "admission_rejected",
                "queue_depth": exc.queue_depth,
                "max_queue": exc.max_queue})
            return
        writer.write(_head_bytes(200, chunked=True))
        await writer.drain()
        try:
            while True:
                try:
                    if self.asr_idle_timeout is not None:
                        data = await asyncio.wait_for(
                            _read_chunk(reader), self.asr_idle_timeout)
                    else:
                        data = await _read_chunk(reader)
                except asyncio.TimeoutError:
                    # silent client: free the slot, tell it why
                    await _write_chunk(writer, json.dumps({
                        "error": "idle timeout: no command within "
                                 f"{self.asr_idle_timeout}s",
                        "final": True}).encode())
                    break
                except ProtocolError as exc:
                    # garbage in the chunk framing: the byte stream is
                    # unrecoverable, but the head is already committed —
                    # best-effort in-stream error, then terminate
                    await _write_chunk(writer, json.dumps(
                        {"error": str(exc), "final": True}).encode())
                    break
                if data is None:              # client hung up cleanly
                    break
                final = False
                try:
                    cmd = json.loads(data)
                    if not isinstance(cmd, dict):
                        raise ValueError(
                            f"command must be a JSON object, got "
                            f"{type(cmd).__name__}")
                    op = cmd.get("op")
                    if op == "push":
                        audio = np.asarray(cmd["audio"], np.float32)
                        await worker.run("push", sess, audio)
                        out = {"ok": True}
                    elif op == "poll":
                        out = jsonable(await worker.run("poll", sess))
                    elif op == "finish":
                        watcher = worker.watch_done(sess)
                        await worker.run("finish", sess)
                        out = jsonable(await asyncio.wrap_future(watcher))
                        final = True
                    else:
                        out = {"error": f"unknown op: {op!r}"}
                except (json.JSONDecodeError, UnicodeDecodeError, KeyError,
                        TypeError, ValueError) as exc:
                    # malformed command (bad JSON, missing/non-numeric
                    # audio, validation reject): in-stream error reply,
                    # session stays alive for well-formed commands
                    out = {"error": f"bad command: {exc}"}
                except SessionFaulted as exc:
                    # the engine evicted this session (poison step,
                    # deadline, pool quarantine): typed final error chunk
                    out = {"error": str(exc), "faulted": True}
                    final = True
                except WorkerDied as exc:
                    out = {"error": str(exc), "faulted": True}
                    final = True
                await _write_chunk(writer, json.dumps(out).encode())
                if final:
                    break
            await _write_last_chunk(writer)
        finally:
            if not sess.done and not sess.detached and sess.fault is None:
                # disconnect mid-stream: free the slot/queue entry (a
                # failed submit on a dead worker resolves the future
                # with WorkerDied; nothing awaits it)
                worker.command("finish", sess)

    async def _handle_lm(self, reader: asyncio.StreamReader,
                         writer: asyncio.StreamWriter,
                         headers: dict) -> None:
        worker = self._lm_worker
        if worker is None:
            await _respond_json(writer, 404, {"error": "no LM engine"})
            return
        body = await _read_sized_body(reader, headers)
        try:
            prompt = np.asarray(json.loads(body)["prompt"], np.int32)
        except (KeyError, ValueError, json.JSONDecodeError) as exc:
            await _respond_json(writer, 400, {"error": str(exc)})
            return
        try:
            sess = await worker.run("open")
        except AdmissionRejected as exc:
            await _respond_json(writer, 503, {
                "error": "admission_rejected",
                "queue_depth": exc.queue_depth,
                "max_queue": exc.max_queue})
            return
        try:
            watcher = worker.watch_done(sess)
            await worker.run("push", sess, prompt)
            await worker.run("finish", sess)
            res = await asyncio.wrap_future(watcher)
        except (SessionFaulted, WorkerDied) as exc:
            # engine-side failure (quarantined session / lost worker),
            # not a bad request: 500, typed
            await _respond_json(writer, 500,
                                {"error": str(exc), "faulted": True})
            return
        except Exception as exc:
            await _respond_json(writer, 400, {"error": str(exc)})
            if sess.fault is None:
                worker.command("finish", sess)
            return
        await _respond_json(writer, 200, res)

    async def _handle_healthz(self, writer: asyncio.StreamWriter) -> None:
        """Liveness: 200 iff every engine worker is alive and within
        its heartbeat watchdog and the server is not draining, else
        503.  Reads thread state and counters directly — a health
        check must not queue behind (or hang on) the very worker it is
        diagnosing."""
        engines, ok = {}, True
        for role, worker in self._workers():
            watchdog = getattr(worker.engine.config,
                               "worker_watchdog", None)
            age = worker.heartbeat_age()
            alive = worker.is_alive()
            healthy = alive and (watchdog is None or age <= watchdog)
            engines[role] = {
                "alive": alive,
                "healthy": healthy,
                "heartbeat_age_s": round(age, 4),
                "watchdog_s": watchdog,
                "restarts": self._restarts[role],
                "faulted_sessions":
                    worker.engine.metrics.faulted_sessions,
            }
            ok = ok and healthy
        status = 200 if ok and not self._draining else 503
        await _respond_json(writer, status, {
            "ok": status == 200, "draining": self._draining,
            "engines": engines})

    async def _handle_metrics(self, writer: asyncio.StreamWriter) -> None:
        out = {}
        for role, worker in self._workers():
            try:
                out[role] = await worker.call(
                    lambda eng: eng.metrics.snapshot())
            except WorkerDied:
                # dead worker isn't mutating anything: read directly
                out[role] = worker.engine.metrics.snapshot()
            if worker.leader is not None:
                out[role]["command_stream"] = dict(worker.leader.stats)
        await _respond_json(writer, 200, out)


# ---- client helpers ---------------------------------------------------

class ServerRejected(RuntimeError):
    """Client-side image of a 503 admission rejection."""

    def __init__(self, payload: dict):
        self.queue_depth = payload.get("queue_depth")
        self.max_queue = payload.get("max_queue")
        super().__init__(
            f"server rejected session: queue depth {self.queue_depth} "
            f"at max_queue={self.max_queue}")


def _parse_status(first_line: str) -> int:
    try:
        return int(first_line.split()[1])
    except (IndexError, ValueError):
        raise ProtocolError(
            f"malformed status line: {first_line[:64]!r}") from None


def _backoff_delay(rng: random.Random, attempt: int, base: float,
                   cap: float) -> float:
    """Jittered exponential backoff: min(cap, base * 2^attempt) scaled
    by a uniform [0.5, 1.5) draw from the caller's seeded rng (no
    wall-clock, no global RNG — retry schedules replay exactly)."""
    return min(cap, base * (2 ** attempt)) * (0.5 + rng.random())


async def _raise_for_error(status: int, reader: asyncio.StreamReader,
                           headers: dict) -> None:
    body = await _read_sized_body(reader, headers)
    payload = json.loads(body) if body else {}
    if status == 503:
        raise ServerRejected(payload)
    raise RuntimeError(f"server error {status}: {payload}")


class AsrClient:
    """One streaming ASR session over the wire: lockstep JSON-chunk RPC
    (each command chunk gets exactly one response chunk)."""

    def __init__(self, reader: asyncio.StreamReader,
                 writer: asyncio.StreamWriter):
        self._reader = reader
        self._writer = writer
        self._closed = False

    @classmethod
    async def open(cls, host: str, port: int, retries: int = 0,
                   backoff: float = 0.05, backoff_cap: float = 2.0,
                   seed: int = 0) -> "AsrClient":
        """Open a session; with `retries` > 0, 503 backpressure
        rejections and connection failures (a worker restart / drain
        window) are retried with seeded jittered exponential backoff —
        deterministic per `seed`, so a load harness replays the same
        schedule."""
        rng = random.Random(seed)
        attempt = 0
        while True:
            try:
                return await cls._open_once(host, port)
            except (ServerRejected, ConnectionError, OSError):
                if attempt >= retries:
                    raise
                await asyncio.sleep(_backoff_delay(
                    rng, attempt, backoff, backoff_cap))
                attempt += 1

    @classmethod
    async def _open_once(cls, host: str, port: int) -> "AsrClient":
        reader, writer = await asyncio.open_connection(host, port)
        writer.write((f"POST /asr HTTP/1.1\r\nHost: {host}:{port}\r\n"
                      "Content-Type: application/json\r\n"
                      "Transfer-Encoding: chunked\r\n\r\n").encode())
        await writer.drain()
        first, headers = await _read_head(reader)
        status = _parse_status(first)
        if status != 200:
            try:
                await _raise_for_error(status, reader, headers)
            finally:
                writer.close()
        return cls(reader, writer)

    async def _rpc(self, obj: dict) -> dict:
        await _write_chunk(self._writer, json.dumps(obj).encode())
        data = await _read_chunk(self._reader)
        if data is None:
            raise ConnectionError("server ended the response stream")
        return json.loads(data)

    async def push(self, audio) -> dict:
        return await self._rpc(
            {"op": "push",
             "audio": np.asarray(audio, np.float32).tolist()})

    async def poll(self) -> dict:
        return await self._rpc({"op": "poll"})

    async def finish(self) -> dict:
        res = await self._rpc({"op": "finish"})
        await _read_chunk(self._reader)       # server's terminating chunk
        await self.aclose()
        return res

    async def aclose(self) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            await _write_last_chunk(self._writer)
        except (ConnectionError, OSError):
            pass
        self._writer.close()
        try:
            await self._writer.wait_closed()
        except (ConnectionError, OSError):
            pass


async def _post_json(host: str, port: int, path: str,
                     payload: dict) -> dict:
    reader, writer = await asyncio.open_connection(host, port)
    try:
        body = json.dumps(jsonable(payload)).encode()
        writer.write((f"POST {path} HTTP/1.1\r\nHost: {host}:{port}\r\n"
                      "Content-Type: application/json\r\n"
                      f"Content-Length: {len(body)}\r\n\r\n").encode()
                     + body)
        await writer.drain()
        first, headers = await _read_head(reader)
        status = _parse_status(first)
        if status != 200:
            await _raise_for_error(status, reader, headers)
        return json.loads(await _read_sized_body(reader, headers))
    finally:
        writer.close()
        try:
            await writer.wait_closed()
        except (ConnectionError, OSError):
            pass


async def lm_generate(host: str, port: int, prompt, retries: int = 0,
                      backoff: float = 0.05, backoff_cap: float = 2.0,
                      seed: int = 0) -> dict:
    """One-shot LM generation over the wire; `retries` > 0 retries 503
    backpressure / connection failures with seeded jittered backoff
    (same schedule contract as `AsrClient.open`)."""
    rng = random.Random(seed)
    attempt = 0
    while True:
        try:
            return await _post_json(host, port, "/lm",
                                    {"prompt": np.asarray(prompt).tolist()})
        except (ServerRejected, ConnectionError, OSError):
            if attempt >= retries:
                raise
            await asyncio.sleep(_backoff_delay(
                rng, attempt, backoff, backoff_cap))
            attempt += 1


async def fetch_healthz(host: str, port: int) -> Tuple[int, dict]:
    """GET /healthz, returning (status, payload) WITHOUT raising on 503
    — a health probe wants the degraded payload, not an exception."""
    reader, writer = await asyncio.open_connection(host, port)
    try:
        writer.write((f"GET /healthz HTTP/1.1\r\nHost: {host}:{port}"
                      "\r\n\r\n").encode())
        await writer.drain()
        first, headers = await _read_head(reader)
        status = _parse_status(first)
        body = await _read_sized_body(reader, headers)
        return status, (json.loads(body) if body else {})
    finally:
        writer.close()
        try:
            await writer.wait_closed()
        except (ConnectionError, OSError):
            pass


async def fetch_metrics(host: str, port: int) -> dict:
    reader, writer = await asyncio.open_connection(host, port)
    try:
        writer.write((f"GET /metrics HTTP/1.1\r\nHost: {host}:{port}"
                      "\r\n\r\n").encode())
        await writer.drain()
        first, headers = await _read_head(reader)
        status = _parse_status(first)
        if status != 200:
            await _raise_for_error(status, reader, headers)
        return json.loads(await _read_sized_body(reader, headers))
    finally:
        writer.close()
        try:
            await writer.wait_closed()
        except (ConnectionError, OSError):
            pass
