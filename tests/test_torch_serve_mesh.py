"""The port's network server on a serving mesh (`EngineServer(channel=)`
on rank 0, `serving.server.follow` on the others), on the CPU, against
the JAX package.

One module-scoped world of 4 ranks (spawned through
`_torch_mesh_ranks`, job `serve_mesh`) runs the scenarios of
`SERVE_SCENARIOS` in order, each on its mesh of the world's first ranks:
rank 0 serves the scenario's sharded engine and runs its client script
in process, over TCP; the other ranks replay rank 0's command stream.
Both packages get the reference's tiny system (`test_serving._asr_system`)
carried across through numpy.  The unsharded JAX server is the reference
because the reference's own 2D wrapper fails under jax 0.9 (ROADMAP
Queue 3).  Held:

  (a) three staggered streams over 2 slots on meshes 2 and 2x2: words,
      tokens and steps equal the JAX `EngineServer`'s on the same
      streams, scores within 1e-3 (`test_serving._same`);
  (b) a deadline script on an injected clock on rank 0 (the others'
      clocks run away: by their own reading every session is overdue)
      faults the sessions the JAX engine faults under the same script;
  (c) a `pump` stall with the watchdog: one restart, /healthz 503 then
      200, the in-flight session quarantined;
  (d) an `asr_step` raise at 2x2 quarantines its stream alone;
  (e) a server idle for twice its channel's timeout sends keep-alives,
      no command message, and then serves a stream;
  and in every scenario every rank's fault log, step counts and engine
  state digest equal rank 0's, and each follower replayed every
  message rank 0 sent.  (f) `torch.distributed.run --nproc-per-node 2
  -m repro_torch.launch.serve --serve --mesh 2 --port 0 --device cpu`
  answers a stream and drains on SIGTERM, every rank exiting 0; (g) a
  `stall` or `die` at `asr_step` under a multi-rank mesh is refused at
  construction.
"""
import asyncio
import os
import pathlib
import signal
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import _torch_mesh_ranks as ranks  # noqa: E402
from repro.serving import AsrProgram as JAsrProgram  # noqa: E402
from repro.serving import EngineConfig as JEngineConfig  # noqa: E402
from repro.serving import AsrEngine as JAsrEngine  # noqa: E402
from repro.serving import server as jserver  # noqa: E402
from repro.serving.engine import DeadlineExceeded  # noqa: E402
from repro.serving.metrics import EngineMetrics as JEngineMetrics  # noqa: E402
from repro_torch.data.pipeline import SyntheticASR  # noqa: E402
from repro_torch.serving import (AsrProgram, EngineConfig,  # noqa: E402
                                 FaultPolicy, FaultSpec)
from repro_torch.serving.server import (AsrClient, EngineServer,  # noqa: E402
                                        fetch_metrics, lm_generate)
from test_serving import FEAT16, TINY_TDS, _asr_system, _same  # noqa: E402
from test_torch_serving_server import (_as_result, _jax_asr_engine,  # noqa: E402
                                       _port_system, _staggered)

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
SCORE_ATOL = 1e-3          # test_serving._same: the reference's own bound
MESH_RANKS = {"2": 2, "2x2": 4}
SCENARIO_MESH = {name: spec for name, spec, _, _ in ranks.SERVE_SCENARIOS}


@pytest.fixture(scope="module")
def utts():
    data = SyntheticASR(_port_system()[0])
    return [data.utterance(i)["audio"] for i in range(4)]


@pytest.fixture(scope="module")
def served(utts, tmp_path_factory):
    """Each rank's {scenario: results} of the 4-rank world."""
    words, lex, lm, dcfg, _, tds_cfg, feat = _port_system()
    params = jax.tree.map(np.asarray, _asr_system()[4])
    return ranks.run(4, tmp_path_factory.mktemp("serve_mesh"), "serve_mesh",
                     {"system": (tds_cfg, feat, lex, lm, dcfg, params),
                      "utts": utts})


@pytest.fixture(scope="module")
def jax_engine():
    """One JAX engine of 2 slots for the references (its compiled steps
    shared)."""
    return _jax_asr_engine(2)


@pytest.fixture(scope="module")
def jax_wave(jax_engine, utts):
    """The JAX EngineServer's results of the three staggered streams."""
    return _staggered(jserver.EngineServer(asr_engine=jax_engine),
                      jserver.AsrClient, utts[:3])


@pytest.fixture(scope="module")
def jax_results(jax_engine, jax_wave, utts):
    """The JAX engine's in-process result of each utterance (after its
    server closed)."""
    return jax_engine.serve(utts)


def _same_wire(got: dict, want: dict):
    """A stream's final payload against a result: words, tokens and
    steps equal, scores within SCORE_ATOL."""
    assert not got.get("error"), got
    res = _as_result(got)
    _same(res, want, tol=SCORE_ATOL)
    assert res["steps"] == int(want["steps"]), (got, want)


def _every_rank_alike(served, name):
    """Every rank of the scenario's mesh ends in rank 0's engine state,
    and each follower replayed every message rank 0 sent."""
    mine = [r[name] for r in served[:MESH_RANKS[SCENARIO_MESH[name]]]]
    lead = mine[0]
    for r in mine[1:]:
        for key in ("fault_log", "digest", "n_steps", "slot_steps"):
            assert r[key] == lead[key], (name, key, r[key], lead[key])
        if "stream" in lead:
            for key in ("messages", "commands", "keepalives"):
                assert r["follow"][key] == lead["stream"][key], (name, key)
    return lead


@pytest.mark.parametrize("mesh", ["2", "2x2"])
def test_mesh_server_streams_match_jax_server(served, jax_wave, mesh):
    """(a) Three staggered streams over 2 slots (one queued) through the
    mesh server and the JAX server: words, tokens and steps equal, scores
    within 1e-3; every rank ends alike."""
    want = jax_wave
    lead = _every_rank_alike(served, f"wave {mesh}")
    assert lead["fatal"] is None and lead["stream"]["messages"] > 0
    assert any(len(w["tokens"]) for w in want)
    for got, w in zip(lead["finals"], want):
        assert got["words"] == w["words"] and got["tokens"] == w["tokens"]
        assert got["steps"] == w["steps"]
        assert abs(got["score"] - w["score"]) <= SCORE_ATOL, (got, w)


def _jax_deadline_log(utts):
    """The deadline script of `_torch_mesh_ranks._deadline`, in process
    on the JAX engine: sessions opened at 100, 104 and 106 over 2 slots,
    deadline 10 s; polls at 111, 115 and 117."""
    words, lex, lm, dcfg, params = _asr_system()
    eng = JAsrEngine(JEngineConfig(JAsrProgram(TINY_TDS, lex, lm, FEAT16,
                                               dcfg), n_slots=2,
                                   session_deadline=10.0), params)
    clk = [100.0]
    eng.metrics = JEngineMetrics(clock=lambda: clk[0])
    a = eng.open().push(utts[0][:2000])
    clk[0] = 104.0
    b = eng.open().push(utts[1][:2000])
    clk[0] = 106.0
    c = eng.open()
    clk[0] = 111.0
    b.poll()
    clk[0] = 115.0
    c.poll()
    clk[0] = 117.0
    with pytest.raises(DeadlineExceeded):
        c.poll()
    assert a.faulted and b.faulted and c.faulted
    return eng._fault_log


def test_deadline_reaps_match_jax_engine_on_every_rank(served, utts,
                                                       jax_results):
    """(b) The same deadline script through the mesh server (2x2; rank 0's
    injected clock) and the JAX engine: the same sids faulted from the
    same slots, on every rank; each reaped client sees its fault, and a
    fresh stream serves."""
    want = _jax_deadline_log(utts)
    lead = _every_rank_alike(served, "deadline")
    assert [e["sid"] for e in want] == [0, 1, 2]
    assert lead["fault_log"] == want
    for err in lead["errors"]:
        assert err.get("faulted") and "session_deadline" in err["error"]
    _same_wire(lead["fresh"], jax_results[3])


def test_watchdog_restart_quarantines_alike_on_every_rank(served,
                                                          jax_results):
    """(c) A `pump` stall with the watchdog armed on a 2x2 mesh: /healthz
    503 while wedged, one restart, 200 after it; the pool's quarantine
    went through the new worker's stream, so every rank's fault log
    holds the in-flight session's.  Its client, whose handler holds the
    lost worker, gets that worker's `WorkerDied` (as without a mesh);
    the warm and the fresh stream equal the JAX engine's results."""
    lead = _every_rank_alike(served, "watchdog")
    assert lead["wedged_healthz"] == 503 and lead["healthz"] == 200
    assert lead["restarts"] == 1
    q = lead["quarantined"]
    assert q.get("faulted") and "engine worker 'asr-worker'" in q["error"]
    assert [e["sid"] for e in lead["fault_log"]] == [1]
    assert lead["fault_log"][0]["reason"].startswith("pool quarantined: ")
    _same_wire(lead["warm"], jax_results[0])
    _same_wire(lead["fresh"], jax_results[2])


def test_asr_step_raise_quarantines_one_stream(served, jax_results):
    """(d) An `asr_step` raise matched on one session at 2x2 (every rank
    holds the same policy and counters): that stream ends faulted, the
    other three equal the JAX engine's results, /healthz stays 200, and
    every rank's fault log holds that session alone."""
    lead = _every_rank_alike(served, "raise")
    bad = lead["finals"][ranks.POISON_SID]
    assert bad.get("faulted") and "poisoned session" in bad["error"], bad
    for i, (got, want) in enumerate(zip(lead["finals"], jax_results)):
        if i != ranks.POISON_SID:
            _same_wire(got, want)
    assert lead["healthz"] == 200 and lead["restarts"] == 0
    assert [e["sid"] for e in lead["fault_log"]] == [ranks.POISON_SID]


def test_idle_server_outlives_its_channel_timeout(served, jax_results):
    """(e) With the channel's timeout at 3 s, the server idles for twice
    that: no command message goes out, keep-alives do (every follower
    counts the same), and then a stream serves."""
    lead = _every_rank_alike(served, "keepalive")
    assert lead["idle"]["messages"] == lead["before"]["messages"] == 0
    assert lead["idle"]["keepalives"] >= 2
    _same_wire(lead["final"], jax_results[0])


def test_in_process_deadline_is_rank_zeros(served, jax_results):
    """In process, under a deadline, on mesh 2: rank 0's clock decides
    (broadcast over the mesh); the other rank's own clock, by which the
    session is overdue at once, decides nothing."""
    outs = [r["in-process deadline"] for r in served[:2]]
    for out in outs:
        assert out["reaped"] == 0 and out["steps_before"] > 0
        _same(out["fresh"], jax_results[1], tol=SCORE_ATOL)
    assert outs[0]["fault_log"] == outs[1]["fault_log"]
    assert len(outs[0]["fault_log"]) == 1


def test_command_channel_carries_long_and_short_messages(served):
    """A message longer than the channel's head buffer (two broadcasts),
    short ones, and ones that fill the buffer's room exactly and by one
    byte more arrive in order on every rank."""
    from repro_torch.launch.mesh import CHANNEL_HEAD_BYTES
    sizes = served[0]["channel"]
    assert sizes[0] > 100_000 > sizes[1]
    assert sizes[3:] == [CHANNEL_HEAD_BYTES - 8, CHANNEL_HEAD_BYTES - 7]
    for r in served[1:]:
        assert r["channel"] == served[0]["channel sent"]


def _children(pid: int) -> list:
    """The pids whose parent is `pid` (from /proc)."""
    out = []
    for d in pathlib.Path("/proc").iterdir():
        if d.name.isdigit():
            try:
                stat = (d / "stat").read_text()
            except OSError:
                continue
            if int(stat.rsplit(")", 1)[1].split()[1]) == pid:
                out.append(int(d.name))
    return out


def test_launcher_serve_mesh_drains_on_sigterm(tmp_path):
    """(f) `torch.distributed.run --nproc-per-node 2 -m
    repro_torch.launch.serve --serve --mesh 2 --port 0 --device cpu`:
    rank 0 prints its address and answers an /asr stream, an /lm request
    and /metrics (its command stream counted there); then each rank gets
    SIGTERM, as torchrun forwards it: rank 0 drains, its stop message
    ends rank 1's replay, and torchrun exits 0, which it does only when
    every rank did."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), HOME=str(tmp_path),
               OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.serve",
         "--serve", "--mesh", "2", "--port", "0", "--device", "cpu",
         "--max-new", "4", "--watchdog", "30", "--session-deadline", "60"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        lines = []
        for line in proc.stdout:
            lines.append(line)
            if line.startswith("serving ASR"):
                break
        assert lines and lines[-1].startswith("serving ASR"), "".join(lines)
        assert "mesh {'model': 2} over 2 ranks" in lines[-1]
        port = int(lines[-1].split("http://127.0.0.1:")[1].split()[0])
        audio = SyntheticASR(
            {f"w{i}": [1 + (i * 3 + j) % 30 for j in range(2 + i % 3)]
             for i in range(12)}).utterance(0)["audio"]

        async def go():
            final = await ranks._client_stream("127.0.0.1", port, audio,
                                               chunk=1280)
            gen = await lm_generate("127.0.0.1", port, [1, 2, 3])
            return final, gen, await fetch_metrics("127.0.0.1", port)

        final, gen, metrics = asyncio.run(go())
        assert final["steps"] > 0 and np.isfinite(final["score"]), final
        assert gen["done"] and len(gen["tokens"]) == 4
        assert metrics["asr"]["command_stream"]["messages"] > 0
        pids = _children(proc.pid)
        assert len(pids) == 2, pids
        for pid in pids:
            os.kill(pid, signal.SIGTERM)
        out, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    text = "".join(lines) + out
    assert "drained; server stopped" in text, text
    assert "[rank 1] stopped by rank 0" in text, text
    assert proc.returncode == 0, text


# ---------------------------------------------------------------------------
# configuration: no ranks
# ---------------------------------------------------------------------------
def _stub_mesh(shape):
    names = ("data", "model")[-len(shape):]
    n = int(np.prod(shape))
    return SimpleNamespace(axis_names=names, shape=dict(zip(names, shape)),
                           size=n, axis=lambda _: SimpleNamespace(
                               ranks=tuple(range(n))))


def _program():
    words, lex, lm, dcfg, _, tds_cfg, feat = _port_system()
    return AsrProgram(tds_cfg, lex, lm, feat, dcfg)


@pytest.mark.parametrize("action", ["stall", "die"])
def test_asr_step_wedge_is_refused_under_a_multi_rank_mesh(action):
    """(g) A `stall` or `die` at `asr_step` would wedge or kill rank 0
    between the other ranks' all-reduces: refused on a 2x1 mesh, served
    on a one-rank mesh and without one."""
    faults = FaultPolicy([FaultSpec("asr_step", action=action)])
    with pytest.raises(ValueError, match="not served under a mesh of 2"):
        EngineConfig(_program(), n_slots=2, mesh=_stub_mesh((2, 1)),
                     faults=faults)
    for mesh in (_stub_mesh((1, 1)), None):
        assert EngineConfig(_program(), n_slots=2, mesh=mesh,
                            faults=faults).faults is faults


def test_raise_at_asr_step_and_pump_wedges_are_served_under_a_mesh():
    """`raise` at `asr_step` (every rank fires alike) and `stall`/`die`
    at `pump` (rank 0's loop, outside every collective) are served."""
    faults = FaultPolicy([FaultSpec("asr_step"),
                          FaultSpec("pump", action="stall"),
                          FaultSpec("pump", action="die")])
    cfg = EngineConfig(_program(), n_slots=2, mesh=_stub_mesh((2, 1)),
                       faults=faults, session_deadline=5.0,
                       worker_watchdog=5.0)
    assert cfg.faults is faults


def test_server_refuses_a_mesh_engine_without_its_channel():
    """An ASR engine on a mesh of several ranks is served only with the
    command channel its other ranks follow: alone, rank 0 would wait in
    the step's first all-reduce forever."""
    eng = SimpleNamespace(config=SimpleNamespace(mesh=_stub_mesh((2,)),
                                                 worker_watchdog=None))
    with pytest.raises(ValueError, match="command channel"):
        EngineServer(asr_engine=eng)
