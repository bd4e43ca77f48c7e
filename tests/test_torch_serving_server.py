"""The port's network front-end (`repro_torch.serving.server`) on the CPU.

The first twelve tests mirror tests/test_serving_server.py against the
port's `EngineServer` with `device="cpu"`: wire-protocol parity against
in-process decoding, concurrent streams over one engine-worker thread,
typed 503 backpressure, /metrics, one-shot LM generation, and the
malformed-input / abrupt-disconnect containment paths.  The rest hold
the port against the JAX package:

  (a) the same three staggered streams through the JAX `EngineServer`
      and the port's: words, tokens and steps equal, scores rtol 1e-4
      (fp32 sums in another order, and the pump schedule over the wire
      depends on timing);
  (b) `lm_generate` tokens equal between the two servers for tiny fp32
      mamba2-1.3b;
  (c) each package's client against the other's server: the wire
      format is the same;
  (d) nothing the engine worker hands the event loop is a
      `torch.Tensor`;
  (e) `python -m repro_torch.launch.serve --serve --port 0 --device cpu`
      serves, and SIGTERM drains it: "drained; server stopped", rc 0;
  (f) the workers of engines on a card take turns (forced on here):
      each guarded step runs on its worker's turn.

Both packages get the same weights: the reference's tiny TDS system
(`test_serving._asr_system`) and `LM.init` parameters, carried across
through numpy.  The port's results are held to `test_serving._same`
(words and tokens equal, scores within 1e-3), as the reference holds its
own.
"""
import asyncio
import contextlib
import dataclasses
import functools
import json
import os
import pathlib
import signal
import subprocess
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.models import LM as JLM  # noqa: E402
from repro.serving import AsrEngine as JAsrEngine  # noqa: E402
from repro.serving import AsrProgram as JAsrProgram  # noqa: E402
from repro.serving import EngineConfig as JEngineConfig  # noqa: E402
from repro.serving import LmEngine as JLmEngine  # noqa: E402
from repro.serving import LmProgram as JLmProgram  # noqa: E402
from repro.serving import server as jserver  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs import tds_asr as tcfg  # noqa: E402
from repro_torch.core import lexicon as tlx  # noqa: E402
from repro_torch.data.pipeline import SyntheticASR  # noqa: E402
from repro_torch.models import tds as ttds  # noqa: E402
from repro_torch.serving import (AsrEngine, AsrProgram,  # noqa: E402
                                 EngineConfig, LmEngine, LmProgram)
from repro_torch.serving import server as tserver  # noqa: E402
from repro_torch.serving.server import (AsrClient, EngineServer,  # noqa: E402
                                        ServerRejected, fetch_metrics,
                                        lm_generate)
from test_serving import FEAT16, TINY_TDS, _asr_system, _same  # noqa: E402

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
LM_ARCH = "mamba2-1.3b"


def _port_dataclass(cls, obj, **over):
    return cls(**{f.name: over.get(f.name, getattr(obj, f.name))
                  for f in dataclasses.fields(obj)})


@functools.lru_cache(maxsize=None)
def _port_system():
    """The reference's tiny ASR system carried across to the port:
    (words, lex, lm, dec_cfg, params, tds_cfg, feat_cfg)."""
    words, lex, lm, dcfg, params = _asr_system()
    tds_cfg = _port_dataclass(
        tcfg.TDSConfig, TINY_TDS,
        stages=tuple(_port_dataclass(tcfg.TDSStage, s)
                     for s in TINY_TDS.stages))
    feat = _port_dataclass(tcfg.FeatureConfig, FEAT16)
    t_lex = tlx.Lexicon.from_numpy(np.asarray(lex.children),
                                   np.asarray(lex.child_token),
                                   np.asarray(lex.word_id), lex.n_nodes,
                                   lex.max_children)
    t_lm = tlx.BigramLM.from_numpy(np.asarray(lm.table), lm.n_words)
    t_dcfg = tcfg.DecoderConfig(**dcfg.__dict__)
    t_params = ttds.params_from_numpy(jax.tree.map(np.asarray, params))
    return words, t_lex, t_lm, t_dcfg, t_params, tds_cfg, feat


def _asr_engine(n_slots, **cfg):
    """The port's engine over the tiny system, on the CPU."""
    words, lex, lm, dcfg, params, tds_cfg, feat = _port_system()
    program = AsrProgram(tds_cfg, lex, lm, feat, dcfg)
    engine = AsrEngine(EngineConfig(program, n_slots=n_slots, **cfg),
                       params, device="cpu")
    return engine, words


def _jax_asr_engine(n_slots):
    words, lex, lm, dcfg, params = _asr_system()
    program = JAsrProgram(TINY_TDS, lex, lm, FEAT16, dcfg)
    return JAsrEngine(JEngineConfig(program, n_slots=n_slots), params)


@functools.lru_cache(maxsize=None)
def _lm_setup():
    """(jax cfg, port cfg, the reference's parameters) of tiny fp32
    mamba2-1.3b."""
    jc = dataclasses.replace(jget(LM_ARCH).tiny(), dtype="float32")
    tc = dataclasses.replace(get_config(LM_ARCH).tiny(), dtype="float32")
    return jc, tc, JLM(jc).init(jax.random.PRNGKey(0))


def _lm_engine(n_slots, **cfg):
    _, tc, params = _lm_setup()
    program = LmProgram(tc, cache_len=16, max_new=4)
    return LmEngine(EngineConfig(program, n_slots=n_slots, **cfg), params,
                    device="cpu"), program


def _jax_lm_engine(n_slots):
    jc, _, params = _lm_setup()
    return JLmEngine(JEngineConfig(JLmProgram(jc, cache_len=16, max_new=4),
                                   n_slots=n_slots), params)


def _as_result(payload: dict) -> dict:
    """Wire payload (JSON lists) -> the in-process result shape."""
    return {"words": np.asarray(payload["words"], np.int32),
            "tokens": np.asarray(payload["tokens"], np.int32),
            "score": float(payload["score"]),
            "steps": payload["steps"]}


async def _with_server(server, coro_fn):
    await server.start()
    try:
        return await coro_fn(server)
    finally:
        await server.aclose()


async def _poll_until(pred, timeout=10.0, interval=0.02):
    """Await `pred()` until it returns something true; fail after
    `timeout` seconds."""
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout
    while loop.time() < deadline:
        res = await pred()
        if res:
            return res
        await asyncio.sleep(interval)
    raise AssertionError(f"condition not reached within {timeout}s")


def test_server_asr_stream_matches_inprocess_and_metrics():
    """One streaming session over the wire — chunked pushes, live
    polls, finish — returns the in-process decode, and /metrics reports
    the session's lifecycle."""
    engine, words = _asr_engine(1)
    audio = SyntheticASR(words).utterance(3)["audio"]

    async def go(server):
        client = await AsrClient.open(server.host, server.port)
        saw_live_poll = False
        for off in range(0, len(audio), 4000):
            assert (await client.push(audio[off:off + 4000]))["ok"]
            live = await client.poll()
            assert {"words", "tokens", "score", "steps"} <= set(live)
            saw_live_poll |= live["steps"] > 0
        final = await client.finish()
        metrics = await fetch_metrics(server.host, server.port)
        return final, saw_live_poll, metrics

    final, saw_live_poll, metrics = asyncio.run(
        _with_server(EngineServer(asr_engine=engine), go))
    assert saw_live_poll           # the worker stepped between pushes

    ref = _asr_engine(1)[0].open().push(audio).finish()
    _same(_as_result(final), ref)
    assert final["steps"] == ref["steps"]

    m = metrics["asr"]
    assert m["sessions"] == {"opened": 1, "admitted": 1, "rejected": 0,
                             "finalized": 1, "faulted": 0,
                             "deadline_evicted": 0}
    assert m["workers"] == {"restarts": 0}
    assert m["latency"]["first_result"]["count"] == 1
    assert m["latency"]["finalize"]["count"] == 1
    assert m["steps"]["occupancy"] > 0


def test_server_concurrent_streams_all_match_dedicated_decode():
    """Five concurrent staggered client streams over a 2-slot engine:
    every transcript equals its dedicated in-process decode."""
    n_utts = 5
    engine, words = _asr_engine(2)
    data = SyntheticASR(words)
    utts = [data.utterance(i)["audio"] for i in range(n_utts)]

    async def one_stream(server, audio, stagger):
        await asyncio.sleep(stagger)
        client = await AsrClient.open(server.host, server.port)
        for off in range(0, len(audio), 3000):
            await client.push(audio[off:off + 3000])
            await asyncio.sleep(0)
        return await client.finish()

    async def go(server):
        return await asyncio.gather(*[
            one_stream(server, audio, 0.01 * i)
            for i, audio in enumerate(utts)])

    finals = asyncio.run(_with_server(EngineServer(asr_engine=engine), go))

    single, _ = _asr_engine(1)
    for audio, final in zip(utts, finals):
        _same(_as_result(final), single.open().push(audio).finish())


def test_server_overload_rejects_503_and_bounds_queue():
    """With the slot busy and the queue at max_queue, a new connection
    gets a 503 (`ServerRejected` carrying depth and bound), the queue
    depth never exceeds the bound, and rejections are counted; once
    streams drain, admission opens again."""
    engine, words = _asr_engine(1, max_queue=1)
    audio = SyntheticASR(words).utterance(0)["audio"]

    async def go(server):
        active = await AsrClient.open(server.host, server.port)
        queued = await AsrClient.open(server.host, server.port)
        with pytest.raises(ServerRejected) as exc:
            await AsrClient.open(server.host, server.port)
        assert exc.value.queue_depth == 1 and exc.value.max_queue == 1

        await active.push(audio)
        await queued.push(audio)
        r_active = await active.finish()     # frees the slot -> admits
        r_queued = await queued.finish()

        late = await AsrClient.open(server.host, server.port)
        await late.push(audio)
        r_late = await late.finish()
        metrics = await fetch_metrics(server.host, server.port)
        return [r_active, r_queued, r_late], metrics

    finals, metrics = asyncio.run(
        _with_server(EngineServer(asr_engine=engine), go))

    m = metrics["asr"]
    assert m["sessions"]["rejected"] == 1
    assert m["sessions"]["opened"] == m["sessions"]["finalized"] == 3
    assert m["queue"]["max_depth"] <= 1      # bounded under overload
    ref = _asr_engine(1)[0].open().push(audio).finish()
    for final in finals:
        _same(_as_result(final), ref)


def test_server_lm_generate_matches_inprocess():
    engine, _ = _lm_engine(2)
    prompts = [np.arange(1, 6, dtype=np.int32),
               np.arange(2, 9, dtype=np.int32)]

    async def go(server):
        return await asyncio.gather(*[
            lm_generate(server.host, server.port, p) for p in prompts])

    outs = asyncio.run(_with_server(EngineServer(lm_engine=engine), go))

    ref_engine, _ = _lm_engine(1)
    for prompt, out in zip(prompts, outs):
        assert out["done"]
        assert out["tokens"] == ref_engine.serve([prompt])[0]


def test_server_unknown_route_and_missing_engine():
    """An LM request against an ASR-only server 404s: typed errors cross
    the wire, they do not hang the connection."""
    engine, _ = _asr_engine(1)

    async def go(server):
        with pytest.raises(RuntimeError, match="404"):
            await lm_generate(server.host, server.port, [1, 2, 3])
        return True

    assert asyncio.run(_with_server(EngineServer(asr_engine=engine), go))


# ---------------------------------------------------------------------------
# malformed input: bad commands, garbage framing
# ---------------------------------------------------------------------------

async def _session_counts(host, port, role="asr"):
    return (await fetch_metrics(host, port))[role]["sessions"]


async def _await_reclaimed(server, opened, timeout=30.0):
    """Poll /metrics until every opened session left the engine
    (finalized or faulted)."""
    async def reclaimed():
        m = await _session_counts(server.host, server.port)
        done = m["finalized"] + m["faulted"] + m["deadline_evicted"]
        return m if done >= opened else None
    return await _poll_until(reclaimed, timeout=timeout)


def test_server_malformed_command_chunks_keep_session_alive():
    """Bad JSON / missing audio / non-numeric audio / NaN samples each
    get an in-stream {"error": ...} reply and the session survives: the
    same connection then streams a clean utterance to the in-process
    transcript."""
    from repro_torch.serving.server import _read_chunk, _write_chunk

    engine, words = _asr_engine(1)
    audio = SyntheticASR(words).utterance(2)["audio"]

    async def bad_cmd(client, raw: bytes) -> dict:
        await _write_chunk(client._writer, raw)
        return json.loads(await _read_chunk(client._reader))

    async def go(server):
        client = await AsrClient.open(server.host, server.port)
        for raw in (b"{not json",
                    b"[1, 2, 3]",
                    b'{"op": "push"}',
                    b'{"op": "push", "audio": "zebra"}',
                    b'{"op": "push", "audio": [[0.1], [0.2]]}',
                    b'{"op": "push", "audio": [0.1, NaN, 0.2]}',
                    b'{"op": "frobnicate"}'):
            res = await bad_cmd(client, raw)
            assert "error" in res, (raw, res)
        for off in range(0, len(audio), 4000):
            assert (await client.push(audio[off:off + 4000]))["ok"]
        final = await client.finish()
        m = await _session_counts(server.host, server.port)
        return final, m

    final, m = asyncio.run(_with_server(EngineServer(asr_engine=engine), go))
    _same(_as_result(final), _asr_engine(1)[0].open().push(audio).finish())
    assert m["opened"] == m["finalized"] == 1 and m["faulted"] == 0


def test_server_garbage_chunk_framing_ends_stream_with_error():
    """Garbage bytes where a chunk-size line belongs: a final in-stream
    error, a clean terminator, and the session reclaimed."""
    from repro_torch.serving.server import _read_chunk

    engine, _ = _asr_engine(1)

    async def go(server):
        client = await AsrClient.open(server.host, server.port)
        client._writer.write(b"THIS IS NOT HEX\r\n")
        await client._writer.drain()
        err = json.loads(await _read_chunk(client._reader))
        assert "malformed chunk-size" in err["error"] and err["final"]
        assert await _read_chunk(client._reader) is None
        await client.aclose()
        return await _await_reclaimed(server, opened=1)

    m = asyncio.run(_with_server(EngineServer(asr_engine=engine), go))
    assert m["finalized"] == 1


def test_server_bad_content_length_responds_400():
    """A garbage Content-Length on /lm is answered with a 400."""
    engine, _ = _lm_engine(1)

    async def go(server):
        reader, writer = await asyncio.open_connection(server.host,
                                                       server.port)
        writer.write((f"POST /lm HTTP/1.1\r\nHost: {server.host}\r\n"
                      "Content-Length: banana\r\n\r\n").encode())
        await writer.drain()
        head = await reader.readuntil(b"\r\n\r\n")
        writer.close()
        return head.decode("latin-1").split("\r\n")[0]

    status_line = asyncio.run(_with_server(EngineServer(lm_engine=engine),
                                           go))
    assert " 400 " in status_line


def test_parse_status_rejects_garbage():
    from repro_torch.serving.server import ProtocolError, _parse_status

    assert _parse_status("HTTP/1.1 200 OK") == 200
    with pytest.raises(ProtocolError, match="malformed status line"):
        _parse_status("complete garbage")


# ---------------------------------------------------------------------------
# abrupt client disconnects: slot + queue reclaimed, metrics consistent
# ---------------------------------------------------------------------------

def test_server_disconnect_mid_push_reclaims_slot():
    """TCP reset in the middle of an admitted stream: the engine frees
    the slot and the next client gets it."""
    engine, words = _asr_engine(1)
    audio = SyntheticASR(words).utterance(1)["audio"]

    async def go(server):
        rude = await AsrClient.open(server.host, server.port)
        await rude.push(audio[:8000])
        rude._writer.transport.abort()         # RST, no clean last-chunk
        await _await_reclaimed(server, opened=1)

        fresh = await AsrClient.open(server.host, server.port)
        await fresh.push(audio)
        final = await fresh.finish()
        m = await _session_counts(server.host, server.port)
        return final, m

    final, m = asyncio.run(_with_server(EngineServer(asr_engine=engine), go))
    _same(_as_result(final), _asr_engine(1)[0].open().push(audio).finish())
    assert m["opened"] == m["finalized"] == 2
    assert m["faulted"] == 0


def test_server_disconnect_while_queued_reclaims_queue_entry():
    """A client that vanishes while waiting for a slot does not wedge
    the pool: its finished-empty session closes as soon as a slot
    frees."""
    engine, words = _asr_engine(1)
    audio = SyntheticASR(words).utterance(0)["audio"]

    async def go(server):
        active = await AsrClient.open(server.host, server.port)
        await active.push(audio[:8000])
        queued = await AsrClient.open(server.host, server.port)
        queued._writer.transport.abort()       # dies in the queue
        await active.push(audio[8000:])
        r_active = await active.finish()
        await _await_reclaimed(server, opened=2)

        late = await AsrClient.open(server.host, server.port)
        await late.push(audio)
        r_late = await late.finish()
        m = await _session_counts(server.host, server.port)
        return r_active, r_late, m

    r_active, r_late, m = asyncio.run(
        _with_server(EngineServer(asr_engine=engine), go))
    _same(_as_result(r_active), _as_result(r_late))
    assert m["opened"] == m["finalized"] == 3  # queued one closed empty
    assert m["faulted"] == 0


def test_server_disconnect_between_finish_and_final_chunk():
    """The client sends `finish` and drops before reading the result:
    the engine still finalizes the session and the pool stays clean.
    The reclaim is awaited as a condition (up to 30 s), not a sleep."""
    from repro_torch.serving.server import _write_chunk

    engine, words = _asr_engine(1)
    audio = SyntheticASR(words).utterance(3)["audio"]

    async def go(server):
        rude = await AsrClient.open(server.host, server.port)
        await rude.push(audio)
        await _write_chunk(rude._writer,
                           json.dumps({"op": "finish"}).encode())
        rude._writer.transport.abort()         # never reads the result
        await _await_reclaimed(server, opened=1)

        fresh = await AsrClient.open(server.host, server.port)
        await fresh.push(audio)
        final = await fresh.finish()
        m = await _session_counts(server.host, server.port)
        return final, m

    final, m = asyncio.run(_with_server(EngineServer(asr_engine=engine), go))
    _same(_as_result(final), _asr_engine(1)[0].open().push(audio).finish())
    assert m["opened"] == m["finalized"] == 2
    assert m["faulted"] == 0


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

async def _stream(client_cls, host, port, audio, stagger, chunk=3000):
    await asyncio.sleep(stagger)
    client = await client_cls.open(host, port)
    for off in range(0, len(audio), chunk):
        assert (await client.push(audio[off:off + chunk]))["ok"]
        await client.poll()
    return await client.finish()


def _staggered(server, client_cls, utts):
    async def go(server):
        return await asyncio.gather(*[
            _stream(client_cls, server.host, server.port, audio, 0.01 * i)
            for i, audio in enumerate(utts)])
    return asyncio.run(_with_server(server, go))


def _assert_wire_equal(got, want, rel=1e-4):
    assert got["words"] == want["words"], (got, want)
    assert got["tokens"] == want["tokens"], (got, want)
    assert got["steps"] == want["steps"], (got, want)
    assert got["score"] == pytest.approx(want["score"], rel=rel)


def test_port_server_streams_match_jax_server():
    """(a) Three staggered streams over 2 slots (one queued) through the
    JAX server and the port's: equal words, tokens and steps, scores
    within rtol 1e-4."""
    words = _port_system()[0]
    data = SyntheticASR(words)
    utts = [data.utterance(i)["audio"] for i in range(3)]
    got = _staggered(EngineServer(asr_engine=_asr_engine(2)[0]),
                     AsrClient, utts)
    want = _staggered(jserver.EngineServer(asr_engine=_jax_asr_engine(2)),
                      jserver.AsrClient, utts)
    assert any(len(w["tokens"]) for w in want)
    for g, w in zip(got, want):
        _assert_wire_equal(g, w)


def test_port_server_lm_generate_matches_jax_server():
    """(b) `lm_generate` over the wire: the port's server returns the JAX
    server's tokens for tiny fp32 mamba2-1.3b."""
    prompts = [np.arange(1, 6, dtype=np.int32),
               np.arange(2, 9, dtype=np.int32),
               np.array([7, 3, 250, 1], np.int32)]

    def run(server, gen):
        async def go(server):
            return await asyncio.gather(*[
                gen(server.host, server.port, p) for p in prompts])
        return asyncio.run(_with_server(server, go))

    got = run(EngineServer(lm_engine=_lm_engine(2)[0]), lm_generate)
    want = run(jserver.EngineServer(lm_engine=_jax_lm_engine(2)),
               jserver.lm_generate)
    assert [o["tokens"] for o in got] == [o["tokens"] for o in want]
    assert all(o["done"] and len(o["tokens"]) == 4 for o in got)


@pytest.mark.parametrize("pairing", ["jax client, port server",
                                     "port client, jax server"])
def test_wire_format_is_shared(pairing):
    """(c) Each package's client helpers against the other's server: an
    ASR stream, /metrics, /healthz and (against an LM engine) a
    generation and a 503 all read the same."""
    words = _port_system()[0]
    audio = SyntheticASR(words).utterance(1)["audio"]
    if pairing.startswith("jax client"):
        client, server_mod = jserver, tserver
        asr = _asr_engine(1, max_queue=0)[0]
        lm = _lm_engine(1)[0]
    else:
        client, server_mod = tserver, jserver
        words_, lex, lm_, dcfg, params = _asr_system()
        asr = JAsrEngine(JEngineConfig(
            JAsrProgram(TINY_TDS, lex, lm_, FEAT16, dcfg), n_slots=1,
            max_queue=0), params)
        lm = _jax_lm_engine(1)

    async def go(server):
        c = await client.AsrClient.open(server.host, server.port)
        with pytest.raises(client.ServerRejected) as exc:
            await client.AsrClient.open(server.host, server.port)
        assert exc.value.queue_depth == 0 and exc.value.max_queue == 0
        for off in range(0, len(audio), 4000):
            assert (await c.push(audio[off:off + 4000]))["ok"]
        live = await c.poll()
        final = await c.finish()
        gen = await client.lm_generate(server.host, server.port, [1, 2, 3])
        status, health = await client.fetch_healthz(server.host, server.port)
        metrics = await client.fetch_metrics(server.host, server.port)
        return live, final, gen, status, health, metrics

    live, final, gen, status, health, metrics = asyncio.run(_with_server(
        server_mod.EngineServer(asr_engine=asr, lm_engine=lm), go))
    assert {"words", "tokens", "score", "steps"} <= set(live)
    ref = _asr_engine(1)[0].open().push(audio).finish()
    _same(_as_result(final), ref)
    assert final["steps"] == ref["steps"]
    assert gen["done"] and gen["tokens"] == _lm_engine(1)[0].serve(
        [np.array([1, 2, 3], np.int32)])[0]
    assert status == 200 and health["ok"] and set(health["engines"]) == {
        "asr", "lm"}
    assert metrics["asr"]["sessions"]["rejected"] == 1
    assert metrics["asr"]["sessions"]["finalized"] == 1
    assert metrics["lm"]["sessions"]["finalized"] == 1


def _holds_tensor(x) -> bool:
    if isinstance(x, torch.Tensor):
        return True
    if isinstance(x, dict):
        return any(_holds_tensor(v) for v in x.values())
    if isinstance(x, (list, tuple)):
        return any(_holds_tensor(v) for v in x)
    return False


def test_worker_hands_the_loop_no_tensor(monkeypatch):
    """(d) Every value an engine worker resolves a future with (command
    results and harvested-session watchers), over an ASR stream with
    polls, an LM generation, /metrics and a drain, is host data: no
    `torch.Tensor` anywhere in it."""
    handed = []
    exec_, resolve = tserver.EngineWorker._exec, \
        tserver.EngineWorker._resolve_watchers

    def record(fut):
        if fut.done() and not fut.cancelled() and fut.exception() is None:
            handed.append(fut.result())

    def exec_recording(self, fn, fut):
        try:
            exec_(self, fn, fut)
        finally:
            record(fut)

    def resolve_recording(self):
        watched = [fut for _, fut in self._watchers]
        resolve(self)
        for fut in watched:
            record(fut)

    monkeypatch.setattr(tserver.EngineWorker, "_exec", exec_recording)
    monkeypatch.setattr(tserver.EngineWorker, "_resolve_watchers",
                        resolve_recording)
    engine, words = _asr_engine(2)
    audio = SyntheticASR(words).utterance(2)["audio"]

    async def go(server):
        final = await _stream(AsrClient, server.host, server.port, audio, 0)
        gen = await lm_generate(server.host, server.port, [4, 5, 6])
        await fetch_metrics(server.host, server.port)
        await server.aclose(drain=True, timeout=30.0)
        return final, gen

    final, gen = asyncio.run(_with_server(
        EngineServer(asr_engine=engine, lm_engine=_lm_engine(1)[0]), go))
    assert final["tokens"] is not None and gen["done"]
    kinds = {type(v).__name__ for v in handed}
    assert {"Session", "dict", "bool"} <= kinds, kinds
    assert any(isinstance(v, dict) and "words" in v for v in handed)
    assert not [v for v in handed if _holds_tensor(v)]


def test_launcher_serve_drains_on_sigterm(tmp_path):
    """(e) `--serve --port 0 --device cpu` in a subprocess: it prints the
    address it bound, answers an ASR stream and an LM request, and
    SIGTERM drains it: "drained; server stopped" and exit code 0."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), HOME=str(tmp_path))
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "--serve",
         "--port", "0", "--device", "cpu", "--max-new", "4"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        lines = []
        for line in proc.stdout:
            lines.append(line)
            if line.startswith("serving ASR"):
                break
        assert lines and lines[-1].startswith("serving ASR"), "".join(lines)
        port = int(lines[-1].split("http://127.0.0.1:")[1].split()[0])
        audio = SyntheticASR(
            {f"w{i}": [1 + (i * 3 + j) % 30 for j in range(2 + i % 3)]
             for i in range(12)}).utterance(0)["audio"]

        async def go():
            final = await _stream(AsrClient, "127.0.0.1", port, audio, 0,
                                  chunk=1280)
            gen = await lm_generate("127.0.0.1", port, [1, 2, 3])
            return final, gen

        final, gen = asyncio.run(go())
        assert final["steps"] > 0 and np.isfinite(final["score"])
        assert gen["done"] and len(gen["tokens"]) == 4
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert "drained; server stopped" in out, out
    assert proc.returncode == 0, out


def test_engine_device_names_the_card_index(monkeypatch):
    """An engine on a card records the card's index (the building
    thread's current device), so that its `EngineWorker` can bind the
    worker thread to that card: ``torch.cuda.set_device`` refuses a
    device without one.  The CPU stays the CPU."""
    from repro_torch.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 3)
    assert resolve_device() == torch.device("cuda", 3)
    assert resolve_device("cuda") == torch.device("cuda", 3)
    assert resolve_device("cuda:1") == torch.device("cuda", 1)
    assert resolve_device("cpu") == torch.device("cpu")


def test_workers_on_a_card_take_turns_around_guarded_steps(monkeypatch):
    """(f) The host-sync guard is one setting of the process on a card,
    so the ASR and LM workers of one server take turns there: every
    guarded step (an ASR step, an LM decode) runs while its worker holds
    the card's turn, and so never beside the other worker's readouts.
    Turns forced on the CPU; two ASR streams and two LM requests at
    once, each result equal to its in-process run."""
    from repro_torch.analysis import guards
    from repro_torch.serving import asr as asrmod, lm as lmmod

    monkeypatch.setattr(tserver, "takes_turns", lambda engine: True)
    steps = {"asr-worker": 0, "lm-worker": 0}

    def turn_checked(module):
        real = module.no_implicit_transfers

        @contextlib.contextmanager
        def guard(strict=False):
            me = threading.current_thread()
            if me.name in steps:            # a server's worker
                assert guards._turn is me, f"{me.name}: a step off its turn"
                steps[me.name] += 1
            with real(strict):
                yield
        monkeypatch.setattr(module, "no_implicit_transfers", guard)
    turn_checked(asrmod)
    turn_checked(lmmod)
    engine, words = _asr_engine(2)
    data = SyntheticASR(words)
    utts = [data.utterance(i)["audio"] for i in range(2)]
    prompts = [[4, 5, 6], [7, 8, 9, 10]]

    async def go(server):
        return await asyncio.gather(
            *[_stream(AsrClient, server.host, server.port, audio, 0.01 * i)
              for i, audio in enumerate(utts)],
            *[lm_generate(server.host, server.port, p) for p in prompts])

    outs = asyncio.run(_with_server(
        EngineServer(asr_engine=engine, lm_engine=_lm_engine(2)[0]), go))
    assert steps["asr-worker"] > 0 and steps["lm-worker"] > 0, steps
    assert guards._turn is None and guards._owners == {}
    single, _ = _asr_engine(1)
    for audio, final in zip(utts, outs[:2]):
        _same(_as_result(final), single.open().push(audio).finish())
    ref_lm, _ = _lm_engine(1)
    for prompt, out in zip(prompts, outs[2:]):
        assert out["done"]
        assert out["tokens"] == ref_lm.serve(
            [np.asarray(prompt, np.int32)])[0]
