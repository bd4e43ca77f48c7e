"""Chaos suite for the port's fault-isolated serving stack, on the CPU.

The first sixteen tests mirror tests/test_faults.py against the port
(`repro_torch.serving.faults.FaultPolicy`, the port's engines with
`device="cpu"` and its `EngineServer`): per-session quarantine (poison
isolated by bisection, co-batched survivors bitwise identical),
whole-pool quarantine, session deadlines on an injected clock, worker
supervision (dead and wedged threads detected and restarted, `/healthz`
flipping 200 -> 503 -> 200), graceful drain under load, idle timeouts
and client retry.  Every injection is counter-driven, never
wall-clock-driven; where the reference's copy sleeps before an assertion
(the idle timeout) or waits on a tight watchdog (0.4 s), the port's
waits on a condition with `_poll_until` (at least 10 s) and arms a
watchdog of 2 s, so that a loaded host does not decide the outcome.

Two more hold the port to the JAX package: the same `FaultSpec` script
gives the same `FaultPolicy.log` and counters in both packages, and a
stalled ``asr_step`` zombie, released after a watchdog restart, behaves
the same in both (it commits one step over the new pool before the
ownership fence stops it: the reference's semantics).
"""
import asyncio
import json
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.data.pipeline import SyntheticASR as JSyntheticASR  # noqa: E402
from repro.serving import faults as jfaults  # noqa: E402
from repro.serving import server as jserver  # noqa: E402
from repro.serving import AsrEngine as JAsrEngine  # noqa: E402
from repro.serving import AsrProgram as JAsrProgram  # noqa: E402
from repro.serving import EngineConfig as JEngineConfig  # noqa: E402
from repro_torch.data.pipeline import SyntheticASR  # noqa: E402
from repro_torch.serving import (DeadlineExceeded,  # noqa: E402
                                 EngineMetrics, FaultPolicy, FaultSpec,
                                 InjectedFault, SessionFaulted, WorkerKilled)
from repro_torch.serving import faults as tfaults  # noqa: E402
from repro_torch.serving import server as tserver  # noqa: E402
from repro_torch.serving.server import (AsrClient, EngineServer,  # noqa: E402
                                        ServerRejected, _read_chunk,
                                        fetch_healthz, fetch_metrics)
from test_serving import FEAT16, TINY_TDS, _asr_system, _same  # noqa: E402
from test_torch_serving_server import (_as_result,  # noqa: E402
                                       _asr_engine, _lm_engine,
                                       _poll_until, _with_server)

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# the injection harness itself: deterministic, replayable
# ---------------------------------------------------------------------------

def test_fault_policy_counters_are_deterministic():
    """nth/count/match arithmetic over per-site counters: two identical
    policies driven by the same check sequence produce the same firings
    and the same log."""
    def build():
        return FaultPolicy([
            FaultSpec("s", nth=1, count=2, message="mid"),
            FaultSpec("t", match=lambda ctx: ctx.get("sid") == 7,
                      count=None, message="sid7"),
        ])

    def drive(policy):
        fired = []
        for i in range(5):
            try:
                policy.check("s", i=i)
                fired.append(False)
            except InjectedFault:
                fired.append(True)
        for sid in (5, 7, 7, 6):
            try:
                policy.check("t", sid=sid)
                fired.append(False)
            except InjectedFault:
                fired.append(True)
        return fired

    a, b = build(), build()
    fired = drive(a)
    assert fired == [False, True, True, False, False,
                     False, True, True, False]
    assert drive(b) == fired
    assert [e["site"] for e in a.log] == ["s", "s", "t", "t"]
    assert a.log == b.log
    with pytest.raises(ValueError, match="unknown fault action"):
        FaultSpec("s", action="explode")


def test_fault_spec_match_does_not_advance_nth():
    """A non-matching check neither fires nor consumes the spec's nth
    budget."""
    policy = FaultPolicy([FaultSpec(
        "s", nth=1, match=lambda ctx: ctx["hot"], message="x")])
    policy.check("s", hot=False)       # ignored entirely
    policy.check("s", hot=True)        # first matching check: skipped
    with pytest.raises(InjectedFault):
        policy.check("s", hot=True)    # second matching check: fires
    policy.check("s", hot=True)        # count=1 exhausted


# ---------------------------------------------------------------------------
# input validation: poison rejected at push, before anything is buffered
# ---------------------------------------------------------------------------

def test_asr_push_rejects_poison_before_buffering():
    engine, words = _asr_engine(1)
    audio = SyntheticASR(words).utterance(2)["audio"]
    sess = engine.open()
    with pytest.raises(ValueError, match="NaN/Inf"):
        sess.push(np.array([0.1, np.nan, 0.2], np.float32))
    with pytest.raises(ValueError, match="1-D"):
        sess.push(np.zeros((4, 4), np.float32))
    with pytest.raises(ValueError, match="max_push_samples"):
        sess.push(np.zeros((engine.program.max_push_samples + 1,),
                           np.float32))
    res = sess.push(audio).finish()
    ref = _asr_engine(1)[0].open().push(audio).finish()
    _same(res, ref, tol=0.0)
    assert engine.metrics.faulted_sessions == 0


def test_lm_push_rejects_poison_prompts():
    engine, program = _lm_engine(1)
    vocab = program.model_cfg.vocab_size
    sess = engine.open()
    with pytest.raises(ValueError, match="integer token ids"):
        sess.push(np.array([1.5, 2.5]))
    with pytest.raises(ValueError, match="1-D"):
        sess.push(np.array([[1, 2]], np.int32))
    with pytest.raises(ValueError, match=r"in \[0,"):
        sess.push(np.array([1, vocab + 3], np.int32))
    with pytest.raises(ValueError, match="cache_len"):
        sess.push(np.arange(1, 40, dtype=np.int32))
    out = sess.push(np.array([1, 2, 3], np.int32)).poll()
    assert out["done"] and len(out["tokens"]) == program.max_new


# ---------------------------------------------------------------------------
# per-session quarantine: bisection pins the poison slot
# ---------------------------------------------------------------------------

def test_poison_session_in_full_pool_quarantined_survivors_bitwise():
    """8 co-batched sessions, one poisoned (every step containing its
    sid faults): bisection pins the fault to that session; the other 7
    finish bitwise equal to a fault-free engine on the same schedule."""
    poison_sid = 3
    policy = FaultPolicy([FaultSpec(
        "asr_step", count=None,
        match=lambda ctx: poison_sid in ctx.get("sids", ()),
        message="poison slot")])
    engine, words = _asr_engine(8, faults=policy)
    data = SyntheticASR(words)
    utts = [data.utterance(i % 4)["audio"] for i in range(8)]

    sessions = [engine.open() for _ in utts]
    for sess, audio in zip(sessions, utts):
        sess.push(audio)
    for sess in sessions:
        sess.finish(wait=False)
    with pytest.raises(SessionFaulted, match="decoding step failed"):
        sessions[poison_sid].finish()

    ref_engine, _ = _asr_engine(8)
    ref_sessions = [ref_engine.open() for _ in utts]
    for sess, audio in zip(ref_sessions, utts):
        sess.push(audio)
    for sess in ref_sessions:
        sess.finish(wait=False)
    refs = [sess.finish() for sess in ref_sessions]
    for i, sess in enumerate(sessions):
        if i == poison_sid:
            assert sess.faulted
            with pytest.raises(SessionFaulted):
                sess.poll()
            continue
        res = sess.finish()
        _same(res, refs[i], tol=0.0)   # bitwise: same trajectory
        assert res["steps"] == refs[i]["steps"]

    assert len(policy.log) >= 2        # at least one split happened
    assert all(poison_sid in e["ctx"]["sids"] for e in policy.log)
    assert tuple(policy.log[-1]["ctx"]["sids"]) == (poison_sid,)
    assert engine.metrics.faulted_sessions == 1
    assert engine._fault_log[0]["sid"] == poison_sid
    late = engine.open().push(utts[0]).finish()
    _same(late, refs[0])


def test_slot_level_api_has_no_session_to_evict():
    """The slot-level API (feed_slot/pump) has no session to attribute a
    singleton fault to: the raise propagates."""
    policy = FaultPolicy([FaultSpec("asr_step", message="boom")])
    engine, words = _asr_engine(1, faults=policy)
    engine.feed_slot(0, SyntheticASR(words).utterance(0)["audio"])
    with pytest.raises(InjectedFault, match="boom"):
        engine.pump()


def test_worker_killed_escapes_session_quarantine():
    """`WorkerKilled` is a BaseException: the per-session and per-pump
    quarantine (`except Exception`) does not contain it."""
    policy = FaultPolicy([FaultSpec("asr_step", action="die")])
    engine, words = _asr_engine(1, faults=policy)
    sess = engine.open().push(SyntheticASR(words).utterance(0)["audio"])
    with pytest.raises(WorkerKilled):
        sess.finish()


def test_lm_prefill_poison_isolated_from_cobatched_prompt():
    """Two prompts admitted in one bucketed prefill batch, one poisoned:
    bisection evicts only it; the other generates the clean tokens."""
    poison_sid = 2
    policy = FaultPolicy([FaultSpec(
        "lm_prefill", count=None,
        match=lambda ctx: poison_sid in ctx.get("sids", ()))])
    engine, program = _lm_engine(2, faults=policy)
    p2, p3 = (np.array([1, 2, 3], np.int32),
              np.array([4, 5, 6, 7], np.int32))

    blockers = [engine.open().push(np.array([9, 8], np.int32))
                for _ in range(2)]
    s2 = engine.open()
    s3 = engine.open()
    s2.push(p2)                        # queued: no free slot yet
    s3.push(p3)
    for b in blockers:
        assert b.poll()["done"]        # drains -> batched admit of s2+s3

    with pytest.raises(SessionFaulted, match="prefill failed"):
        s2.poll()
    out = s3.poll()
    assert out["done"]
    ref_engine, _ = _lm_engine(1)
    assert out["tokens"] == ref_engine.serve([p3])[0]
    assert engine.metrics.faulted_sessions == 1
    assert [sorted(e["ctx"]["sids"]) for e in policy.log] == [[2, 3], [2]]


# ---------------------------------------------------------------------------
# whole-pool quarantine: unattributable pump failure
# ---------------------------------------------------------------------------

def test_unattributable_pump_failure_quarantines_pool_and_recovers():
    engine, words = _asr_engine(2)
    audio = SyntheticASR(words).utterance(1)["audio"]
    s_active = engine.open().push(audio)

    orig = engine._harvest
    state = {"armed": False}

    def corrupt_harvest():
        if state["armed"]:
            state["armed"] = False
            raise RuntimeError("synthetic pool corruption")
        return orig()

    engine._harvest = corrupt_harvest
    state["armed"] = True
    with pytest.raises(SessionFaulted, match="pool quarantined"):
        s_active.poll()
    assert s_active.faulted
    assert s_active.fault.__cause__.args == ("synthetic pool corruption",)
    assert engine.metrics.faulted_sessions == 1
    assert engine.n_steps == 0         # pool rebuilt from scratch

    res = engine.open().push(audio).finish()
    ref = _asr_engine(1)[0].open().push(audio).finish()
    _same(res, ref, tol=0.0)


# ---------------------------------------------------------------------------
# deadlines on the injected metrics clock
# ---------------------------------------------------------------------------

def test_session_deadline_reaps_active_and_queued():
    engine, words = _asr_engine(1, session_deadline=10.0)
    clk = [100.0]
    engine.metrics = EngineMetrics(clock=lambda: clk[0])
    audio = SyntheticASR(words).utterance(0)["audio"]

    active = engine.open().push(audio[:2000])
    queued = engine.open()             # 1 slot: waits in the queue
    clk[0] += 11.0
    with pytest.raises(DeadlineExceeded, match="session_deadline"):
        active.poll()
    with pytest.raises(DeadlineExceeded):
        queued.poll()
    assert engine.metrics.deadline_evictions == 2
    snap = engine.metrics.snapshot()["sessions"]
    assert snap["deadline_evicted"] == 2 and snap["faulted"] == 0

    res = engine.open().push(audio).finish()
    ref = _asr_engine(1)[0].open().push(audio).finish()
    _same(res, ref, tol=0.0)


# ---------------------------------------------------------------------------
# worker supervision over the wire: dead + wedged threads
# ---------------------------------------------------------------------------

async def _suspend_supervisor(server):
    """Park the supervisor so that a dead or wedged worker stays
    unrestarted until the test resumes supervision."""
    server._supervisor.cancel()
    try:
        await server._supervisor
    except asyncio.CancelledError:
        pass


def _resume_supervisor(server):
    server._supervisor = asyncio.get_running_loop().create_task(
        server._supervise())


async def _healthz_ok(server, fetch=fetch_healthz):
    status, payload = await fetch(server.host, server.port)
    return (status, payload) if status == 200 else None


def test_server_dead_worker_healthz_flips_and_restart_serves():
    """Kill the engine worker mid-service: /healthz flips 200 -> 503 ->
    200, the in-flight session resolves with a typed error, and the
    restarted worker completes new sessions."""
    arm = {"on": False}
    policy = FaultPolicy([FaultSpec(
        "pump", action="die", count=1,
        match=lambda ctx: arm["on"], message="killed by test")])
    engine, words = _asr_engine(1, faults=policy)
    audio = SyntheticASR(words).utterance(1)["audio"]

    async def go(server):
        status, payload = await fetch_healthz(server.host, server.port)
        assert status == 200 and payload["ok"]

        inflight = await AsrClient.open(server.host, server.port)
        assert (await inflight.push(audio[:4000]))["ok"]

        await _suspend_supervisor(server)
        arm["on"] = True               # next pump iteration dies
        await _poll_until(
            lambda: asyncio.sleep(0, not server._asr_worker.is_alive()))
        arm["on"] = False
        status, payload = await fetch_healthz(server.host, server.port)
        assert status == 503
        assert not payload["engines"]["asr"]["alive"]

        res = await inflight.push(audio[4000:8000])
        assert "error" in res
        await inflight.aclose()

        _resume_supervisor(server)
        status, payload = await _poll_until(
            lambda: _healthz_ok(server), timeout=15.0)
        assert payload["engines"]["asr"]["restarts"] == 1
        assert server._asr_worker.name == "asr-worker-r1"

        fresh = await AsrClient.open(server.host, server.port)
        await fresh.push(audio)
        final = await fresh.finish()
        metrics = await fetch_metrics(server.host, server.port)
        return final, metrics

    final, metrics = asyncio.run(_with_server(
        EngineServer(asr_engine=engine, watch_interval=0.05), go))
    ref = _asr_engine(1)[0].open().push(audio).finish()
    _same(_as_result(final), ref)
    assert metrics["asr"]["workers"]["restarts"] == 1
    assert metrics["asr"]["sessions"]["faulted"] >= 1


def test_server_wedged_worker_watchdog_restart():
    """A stalled (not dead) worker: its heartbeat ages past the watchdog,
    /healthz reports alive-but-unhealthy 503, the supervisor restarts
    it, and the released zombie is fenced off the pool by the ownership
    reclaim.  Every wait is a condition (`_poll_until`, >= 10 s)."""
    watchdog = 2.0
    arm = {"on": False}
    policy = FaultPolicy(
        [FaultSpec("pump", action="stall", count=1,
                   match=lambda ctx: arm["on"])],
        stall_timeout=60.0)
    engine, words = _asr_engine(1, faults=policy, worker_watchdog=watchdog)
    audio = SyntheticASR(words).utterance(2)["audio"]

    async def go(server):
        old = server._asr_worker
        await _suspend_supervisor(server)
        warm = await AsrClient.open(server.host, server.port)
        await warm.push(audio)
        warm_res = await warm.finish()
        assert not warm_res.get("error"), warm_res
        arm["on"] = True               # next pump iteration blocks
        await _poll_until(lambda: asyncio.sleep(
            0, old.heartbeat_age() > watchdog), timeout=30.0)
        arm["on"] = False
        status, payload = await fetch_healthz(server.host, server.port)
        eng_h = payload["engines"]["asr"]
        assert status == 503           # wedged: alive but unhealthy
        assert eng_h["alive"] and not eng_h["healthy"]

        _resume_supervisor(server)
        await _poll_until(lambda: asyncio.sleep(
            0, server._asr_worker is not old), timeout=30.0)
        policy.release()               # wake the zombie: worker_only fences it

        status, payload = await _poll_until(
            lambda: _healthz_ok(server), timeout=30.0)
        assert payload["engines"]["asr"]["restarts"] >= 1

        fresh = await AsrClient.open(server.host, server.port)
        await fresh.push(audio)
        return await fresh.finish()

    final = asyncio.run(_with_server(
        EngineServer(asr_engine=engine, watch_interval=0.1), go))
    ref = _asr_engine(1)[0].open().push(audio).finish()
    _same(_as_result(final), ref)
    assert engine.metrics.worker_restarts >= 1



def test_worker_wedged_inside_the_guard_is_released_on_restart(
        monkeypatch):
    """A worker wedged INSIDE its guarded step (the engines' workers
    taking turns as on a card, the card's sync debug mode recorded):
    while it hangs the mode is error and it holds the card's turn; the
    watchdog restart releases both, so the new worker serves and the
    mode comes back once it is idle, and the zombie, woken, changes
    neither."""
    from repro_torch.analysis import guards
    mode = ["default"]
    monkeypatch.setattr(guards, "_has_cuda", lambda: True)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode",
                        lambda m: mode.__setitem__(0, m))
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: mode[0])
    monkeypatch.setattr(tserver, "takes_turns", lambda engine: True)
    watchdog = 2.0
    engine, words = _asr_engine(1, worker_watchdog=watchdog)
    audio = SyntheticASR(words).utterance(2)["audio"]
    arm, wedged, wake = {"on": False}, threading.Event(), threading.Event()
    real_run = engine._run_step

    def run_step(*args, **kw):            # inside no_implicit_transfers
        if arm["on"]:
            arm["on"] = False
            wedged.set()
            wake.wait(60)
        return real_run(*args, **kw)
    engine._run_step = run_step

    async def go(server):
        old = server._asr_worker
        warm = await AsrClient.open(server.host, server.port)
        await warm.push(audio)
        assert not (await warm.finish()).get("error")
        await _suspend_supervisor(server)
        arm["on"] = True
        inflight = await AsrClient.open(server.host, server.port)
        await inflight.push(audio[:8000])
        await _poll_until(lambda: asyncio.sleep(0, wedged.is_set()),
                          timeout=30.0)
        assert mode == ["error"] and guards._turn is old._thread
        await _poll_until(lambda: asyncio.sleep(
            0, old.heartbeat_age() > watchdog), timeout=30.0)
        _resume_supervisor(server)
        await _poll_until(lambda: asyncio.sleep(
            0, server._asr_worker is not old), timeout=30.0)
        assert old._thread not in guards._owners
        assert guards._turn is not old._thread
        await inflight.aclose()
        fresh = await AsrClient.open(server.host, server.port)
        await fresh.push(audio)
        final = await fresh.finish()
        await _poll_until(lambda: asyncio.sleep(0, mode == ["default"]),
                          timeout=30.0)
        wake.set()                         # the zombie wakes
        await _poll_until(lambda: asyncio.sleep(
            0, not old._thread.is_alive()), timeout=30.0)
        assert mode == ["default"] and old._thread not in guards._owners
        return final

    final = asyncio.run(_with_server(
        EngineServer(asr_engine=engine, watch_interval=0.05), go))
    assert guards._owners == {} and guards._turn is None
    ref = _asr_engine(1)[0].open().push(audio).finish()
    _same(_as_result(final), ref)
    assert engine.metrics.worker_restarts == 1

def test_server_poison_session_errors_in_stream_others_unaffected():
    """Over the wire: the poisoned session gets an in-stream `faulted`
    error chunk, the co-batched session completes with the clean
    transcript, the worker survives, and /healthz stays 200."""
    poison_sid = 0
    policy = FaultPolicy([FaultSpec(
        "asr_step", count=None,
        match=lambda ctx: poison_sid in ctx.get("sids", ()))])
    engine, words = _asr_engine(2, faults=policy)
    data = SyntheticASR(words)
    bad_audio = data.utterance(0)["audio"]
    good_audio = data.utterance(3)["audio"]

    async def go(server):
        bad = await AsrClient.open(server.host, server.port)
        good = await AsrClient.open(server.host, server.port)
        await bad.push(bad_audio)
        await good.push(good_audio)
        res = await bad.finish()
        assert res.get("faulted") and "faulted" in res["error"]
        final = await good.finish()
        status, _ = await fetch_healthz(server.host, server.port)
        assert status == 200           # worker survived the poison
        assert server._asr_worker.is_alive()
        metrics = await fetch_metrics(server.host, server.port)
        return final, metrics

    final, metrics = asyncio.run(_with_server(
        EngineServer(asr_engine=engine), go))
    ref = _asr_engine(1)[0].open().push(good_audio).finish()
    _same(_as_result(final), ref)
    assert metrics["asr"]["sessions"]["faulted"] == 1
    assert metrics["asr"]["workers"]["restarts"] == 0


# ---------------------------------------------------------------------------
# graceful drain, idle timeout, client retry
# ---------------------------------------------------------------------------

def test_server_drain_under_load_returns_every_result():
    """aclose(drain=True) while sessions are mid-stream: every active
    session still gets its final transcript, and the listener refuses
    new connections."""
    engine, words = _asr_engine(2)
    data = SyntheticASR(words)
    utts = [data.utterance(i)["audio"] for i in range(4)]

    async def stream(server, audio, started: asyncio.Event):
        client = await AsrClient.open(server.host, server.port)
        chunks = [audio[off:off + 4000]
                  for off in range(0, len(audio), 4000)]
        await client.push(chunks[0])
        started.set()
        for chunk in chunks[1:]:
            await client.push(chunk)
            await asyncio.sleep(0.01)  # keep the stream mid-flight
        return await client.finish()

    async def go(server):
        started = [asyncio.Event() for _ in utts]
        tasks = [asyncio.create_task(stream(server, a, ev))
                 for a, ev in zip(utts, started)]
        for ev in started:
            await ev.wait()            # every session is open + pushing
        await server.aclose(drain=True, timeout=60.0)
        finals = await asyncio.gather(*tasks)
        with pytest.raises((ConnectionError, OSError)):
            await AsrClient.open(server.host, server.port)
        return finals

    async def run():
        server = EngineServer(asr_engine=engine)
        await server.start()
        try:
            return await go(server)
        finally:
            await server.aclose()      # idempotent cleanup
    finals = asyncio.run(run())

    ref_engine, _ = _asr_engine(1)
    for audio, final in zip(utts, finals):
        _same(_as_result(final), ref_engine.open().push(audio).finish())
    assert engine.metrics.finalized == len(utts)


def test_server_idle_timeout_frees_slot():
    """A silent client gets an in-stream idle-timeout error and its slot
    back; the next session decodes normally.  The test waits for the
    server's error chunk (up to 15 s) instead of sleeping past the
    0.25 s timeout."""
    engine, words = _asr_engine(1)
    audio = SyntheticASR(words).utterance(1)["audio"]

    async def go(server):
        quiet = await AsrClient.open(server.host, server.port)
        await quiet.push(audio[:4000])
        res = json.loads(await asyncio.wait_for(
            _read_chunk(quiet._reader), 15.0))
        assert "idle timeout" in res.get("error", "")
        await quiet.aclose()

        fresh = await AsrClient.open(server.host, server.port)
        await fresh.push(audio)
        return await fresh.finish()

    final = asyncio.run(_with_server(
        EngineServer(asr_engine=engine, asr_idle_timeout=0.25), go))
    ref = _asr_engine(1)[0].open().push(audio).finish()
    _same(_as_result(final), ref)


def test_client_retry_rides_out_backpressure():
    """With retries armed, a 503 rejection is retried with jittered
    backoff until the busy slot frees."""
    engine, words = _asr_engine(1, max_queue=0)
    audio = SyntheticASR(words).utterance(0)["audio"]

    async def go(server):
        first = await AsrClient.open(server.host, server.port)
        await first.push(audio)
        with pytest.raises(ServerRejected):
            await AsrClient.open(server.host, server.port)   # no retries

        retry_task = asyncio.create_task(AsrClient.open(
            server.host, server.port, retries=40, backoff=0.02, seed=7))
        await asyncio.sleep(0.1)
        assert not retry_task.done()   # still backing off against 503
        r1 = await first.finish()      # frees the slot
        second = await retry_task
        await second.push(audio)
        r2 = await second.finish()
        metrics = await fetch_metrics(server.host, server.port)
        return r1, r2, metrics

    r1, r2, metrics = asyncio.run(_with_server(
        EngineServer(asr_engine=engine), go))
    _same(_as_result(r1), _as_result(r2))
    assert metrics["asr"]["sessions"]["rejected"] >= 2
    assert metrics["asr"]["sessions"]["finalized"] == 2


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

def _script(mod):
    """One fault script over every action, run through package `mod`'s
    `FaultPolicy`: returns (what each check did, the log, the per-site
    counters, each spec's seen/fired counters)."""
    policy = mod.FaultPolicy([
        mod.FaultSpec("asr_step", nth=1, count=2,
                      match=lambda ctx: 3 in ctx.get("sids", ()),
                      message="poison"),
        mod.FaultSpec("lm_prefill", action="die", nth=2, count=1),
        mod.FaultSpec("pump", action="stall", nth=3, count=None,
                      match=lambda ctx: ctx["worker"].endswith("r1")),
        mod.FaultSpec("asr_step", count=None, message="late",
                      match=lambda ctx: ctx.get("slots") == (9,)),
    ], stall_timeout=5.0)
    policy.release()                   # a firing stall returns at once
    checks = ([("asr_step", dict(slots=(s,), sids=(s, 3) if s % 2 else (s,)))
               for s in range(8)]
              + [("lm_prefill", dict(sids=(i,))) for i in range(5)]
              + [("pump", dict(worker=f"asr-worker-r{i % 2}"))
                 for i in range(12)]
              + [("asr_step", dict(slots=(9,), sids=())) for _ in range(3)])
    did = []
    for site, ctx in checks:
        try:
            policy.check(site, **ctx)
            did.append("ok")
        except mod.InjectedFault as exc:
            did.append(f"raise {exc}")
        except mod.WorkerKilled as exc:
            did.append(f"die {exc}")
    specs = [(s._seen, s._fired) for s in policy.specs]
    return did, policy.log, dict(policy._counters), specs


def test_fault_script_replays_identically_in_both_packages():
    """The same `FaultSpec` script, run through the JAX package's
    `FaultPolicy` and the port's, fires the same checks and leaves the
    same log, per-site counters and per-spec counters."""
    got, want = _script(tfaults), _script(jfaults)
    assert got == want
    did, log, counters, _ = got
    assert {d.split()[0] for d in did} == {"ok", "raise", "die"}
    assert {e["action"] for e in log} == {"raise", "die", "stall"}
    assert counters == {"asr_step": 11, "lm_prefill": 5, "pump": 12}


def _zombie_scenario(server_mod, engine, audio, chunk):
    """Warm the step shapes, wedge the worker in an ``asr_step`` stall
    (session A), let the supervisor restart it, stream part of a fresh
    session B through the new worker, then release the zombie.  Returns
    ((pool steps, B's slot steps) before the release, the same after it,
    the old worker's death), and the zombie step's slots."""
    async def go(server):
        old = server._asr_worker
        await _suspend_supervisor(server)
        warm = await server_mod.AsrClient.open(server.host, server.port)
        await warm.push(audio[:chunk])
        assert not (await warm.finish()).get("error")
        a = await server_mod.AsrClient.open(server.host, server.port)
        arm["on"] = True               # A's first step stalls
        await a.push(audio[:chunk])
        await _poll_until(lambda: asyncio.sleep(
            0, len(policy.log) == 1 and old.heartbeat_age() > 1.0),
            timeout=30.0)
        arm["on"] = False
        _resume_supervisor(server)
        await _poll_until(lambda: asyncio.sleep(
            0, server._asr_worker is not old), timeout=30.0)
        b = await server_mod.AsrClient.open(server.host, server.port)
        await b.push(audio[:chunk])

        async def b_stepped():
            return (await b.poll())["steps"] == 2
        await _poll_until(b_stepped, timeout=30.0)
        before = (engine.n_steps, int(engine._slot_steps[0]))
        policy.release()               # the zombie wakes
        await _poll_until(lambda: asyncio.sleep(
            0, not old._thread.is_alive()), timeout=30.0)
        after = (engine.n_steps, int(engine._slot_steps[0]))
        await a.aclose()
        await b.aclose()
        return before, after, old._death

    arm = {"on": False}
    policy = engine._faults
    policy.specs[0].match = lambda ctx: arm["on"]
    res = asyncio.run(_with_server(
        server_mod.EngineServer(asr_engine=engine, watch_interval=0.05), go))
    return res, policy.log[0]["ctx"]["slots"]


@pytest.mark.parametrize("package", ["jax", "port"])
def test_released_asr_step_zombie_commits_over_new_pool(package):
    """A worker stalled inside ``asr_step`` is replaced by the watchdog;
    the new worker rebuilds the pool and serves a fresh session B.  When
    the stalled thread is released it is inside `_step_slots`, past the
    `worker_only` check of `_step`: it runs its step on B's pool state
    and commits it (the pool's step count and B's slot step count move
    with no push from B), and only its next fenced engine call stops it
    (the old worker dies with `WorkerDied`).  The port's injection site
    sits before any device work, so the zombie had launched nothing
    while it stalled.  Both packages behave alike: the reference's
    semantics (ROADMAP Queue 3)."""
    spec = dict(site="asr_step", action="stall", count=1)
    if package == "jax":
        words, lex, lm, dcfg, params = _asr_system()
        policy = jfaults.FaultPolicy([jfaults.FaultSpec(**spec)],
                                     stall_timeout=60.0)
        engine = JAsrEngine(JEngineConfig(
            JAsrProgram(TINY_TDS, lex, lm, FEAT16, dcfg), n_slots=1,
            faults=policy, worker_watchdog=1.0), params)
        audio = JSyntheticASR(words).utterance(2)["audio"]
        server_mod = jserver
    else:
        policy = FaultPolicy([FaultSpec(**spec)], stall_timeout=60.0)
        engine, words = _asr_engine(1, faults=policy, worker_watchdog=1.0)
        audio = SyntheticASR(words).utterance(2)["audio"]
        server_mod = tserver
    chunk = 2 * engine.plan.samples_per_step + 400
    (before, after, death), zombie_slots = _zombie_scenario(
        server_mod, engine, audio, chunk)
    n_steps, slot_steps = before
    assert zombie_slots == (0,)
    assert slot_steps == 2 and n_steps == 1   # B's one step, w = 2
    # the zombie committed one step of w windows over B's slot
    assert after[0] == n_steps + 1
    assert after[1] > slot_steps
    assert isinstance(death, server_mod.WorkerDied)
    assert "owned by worker thread" in repr(death.__cause__)
