"""Port `AsrEngine` end to end vs the JAX engine, on the CPU.

The JAX demo system (`repro.launch.serve.asr_demo_system`) is carried
across with `params_from_numpy` / `Lexicon.from_numpy`; both engines
serve the same `SyntheticASR` utterances at beam 25.  Words, tokens and
step counts must be equal.  fp32 scores agree to rtol 1e-4 (fp32 sums
in other orders through 79 kernels and every frame's beam search).
int8 scores agree to rtol 1e-2: an activation that differs from the
reference's in the last ulp can sit at a rounding boundary and quantize
to the neighbouring int8 value, which moved a frame's log-probs by up to
0.03 (measured: 2.2e-3 relative on the best scores below).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.data.pipeline import SyntheticASR  # noqa: E402
from repro.kernels.policy import KernelPolicy as JaxPolicy  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.serving import AsrEngine as JaxEngine  # noqa: E402
from repro.serving import AsrProgram as JaxProgram  # noqa: E402
from repro.serving import EngineConfig as JaxConfig  # noqa: E402
from repro_torch.configs import tds_asr as tcfg  # noqa: E402
from repro_torch.core import lexicon as tlx  # noqa: E402
from repro_torch.kernels.policy import KernelPolicy  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import tds as ttds  # noqa: E402
from repro_torch.serving import (AdmissionRejected, AsrEngine,  # noqa: E402
                                 AsrProgram, EngineConfig, FaultPolicy,
                                 FaultSpec, SessionFaulted)

torch.set_num_threads(1)

N_UTTS = 4


def _port_system():
    """The JAX demo system, carried across to the port as numpy."""
    tds_cfg, words, lex, lm, params, dec = jserve.asr_demo_system()
    t_cfg = tcfg.TDSConfig(
        stages=tuple(tcfg.TDSStage(s.n_blocks, s.channels, s.feat, s.kernel,
                                   s.subsample) for s in tds_cfg.stages),
        vocab_size=tds_cfg.vocab_size)
    t_lex = tlx.Lexicon.from_numpy(np.asarray(lex.children),
                                   np.asarray(lex.child_token),
                                   np.asarray(lex.word_id), lex.n_nodes,
                                   lex.max_children)
    t_lm = tlx.BigramLM.from_numpy(np.asarray(lm.table), lm.n_words)
    t_dec = tcfg.DecoderConfig(**dec.__dict__)
    t_params = ttds.params_from_numpy(jax.tree.map(np.asarray, params))
    return t_cfg, words, t_lex, t_lm, t_params, t_dec


@pytest.fixture(scope="module")
def system():
    return _port_system()


@pytest.fixture(scope="module")
def utterances(system):
    data = SyntheticASR(system[1])
    return [data.utterance(u)["audio"] for u in range(N_UTTS)]


@pytest.fixture(scope="module")
def jax_results(utterances):
    out = {}
    for n in (1, 2, 4):
        eng, _ = jserve.asr_demo_engine(n, JaxPolicy("ref"))
        out[n] = eng.serve(utterances)
    return out


@pytest.fixture(scope="module")
def jax_int8_results(utterances):
    tds_cfg, _, lex, lm, params, dec = jserve.asr_demo_system()
    prog = JaxProgram(tds_cfg, lex, lm, dec_cfg=dec,
                      use_int8=True).with_beam_width(25.0)
    return {n: JaxEngine(JaxConfig(prog, n_slots=n, kernels=JaxPolicy("ref")),
                         params).serve(utterances) for n in (1, 2, 4)}


def _port_engine(system, n, **kw):
    eng, _ = tserve.asr_demo_engine(n, KernelPolicy("auto"), device="cpu",
                                    system=system, **kw)
    return eng


def _assert_transcripts_equal(got, want, rel=1e-4):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["words"], w["words"])
        np.testing.assert_array_equal(g["tokens"], w["tokens"])
        assert g["steps"] == w["steps"]
        assert g["score"] == pytest.approx(w["score"], rel=rel)


@pytest.mark.parametrize("n_slots", [1, 2, 4])
def test_serve_matches_jax_engine(system, utterances, jax_results, n_slots):
    eng = _port_engine(system, n_slots)
    got = eng.serve(utterances)
    _assert_transcripts_equal(got, jax_results[n_slots])
    assert any(len(r["tokens"]) for r in got)
    assert eng.metrics.finalized == N_UTTS


@pytest.mark.parametrize("n_slots", [1, 2, 4])
def test_int8_serve_matches_jax_engine(system, utterances, jax_int8_results,
                                       n_slots):
    eng = _port_engine(system, n_slots, use_int8=True)
    assert eng.program.use_int8 and len(eng._prepared) == 7
    got = eng.serve(utterances)
    _assert_transcripts_equal(got, jax_int8_results[n_slots], rel=1e-2)
    assert any(len(r["tokens"]) for r in got)


def test_int8_engine_quantizes_weights_exactly_once(system, utterances,
                                                    monkeypatch):
    """An int8 program quantizes its FC/head weights once, when the
    engine is built (`prepare_params` -> `tds.quantize_params`); serving
    adds no `prepare_int8_weights` call, and the prepared path decodes
    like a 1-slot engine."""
    from repro_torch.kernels import ops
    calls = []
    orig = ops.prepare_int8_weights
    monkeypatch.setattr(ops, "prepare_int8_weights",
                        lambda w: calls.append(tuple(w.shape)) or orig(w))
    eng = _port_engine(system, 2, use_int8=True)
    n_fc = sum(s.kind in ("fc", "head")
               for s in ttds.build_kernel_specs(system[0]))
    assert len(calls) == n_fc, (len(calls), n_fc)
    got = eng.serve(utterances[:2])
    assert all(np.isfinite(r["score"]) for r in got)
    assert len(calls) == n_fc, \
        f"weight quantization ran in the serving hot path: {calls[n_fc:]}"
    one = _port_engine(system, 1, use_int8=True)
    for audio, res in zip(utterances[:2], got):
        want = one.serve([audio])[0]
        np.testing.assert_array_equal(res["words"], want["words"])
        np.testing.assert_array_equal(res["tokens"], want["tokens"])
        assert res["score"] == pytest.approx(want["score"], abs=1e-3)


def test_flush_tail_off_leaves_the_partial_window(system, utterances):
    """flush_tail=False (the command shims' program) decodes whole
    windows only: the trailing partial window is not zero-padded."""
    audio = utterances[0][:5 * 1280 + 700]     # 5 windows and a partial one
    results = {}
    for flush in (True, False):
        tds_cfg, _, lex, lm, params, dec = system
        prog = AsrProgram(tds_cfg, lex, lm, dec_cfg=dec, flush_tail=flush)
        eng = AsrEngine(EngineConfig(prog, n_slots=1), params, device="cpu")
        results[flush] = eng.serve([audio])[0]
    assert results[False]["steps"] + 1 == results[True]["steps"]


def test_step_buckets_and_gathered_shapes(system, utterances):
    eng = _port_engine(system, 4)
    assert eng._slot_buckets == (1, 2, 4)
    assert eng.program.step_buckets() == (4, 2, 1)
    eng.serve(utterances[:3])
    for n_active, b, w in eng.step_shapes:
        assert b == min(x for x in (1, 2, 4) if x >= n_active)
        assert w in (1, 2, 4)
    fresh = _port_engine(system, 4)
    for s in (0, 2, 3):
        fresh.feed_slot(s, utterances[s])
    batch, idx = fresh._assemble_batch([0, 2, 3], 2)
    assert batch.shape == (4, 2, fresh._need)
    assert idx.tolist() == [0, 2, 3, 0]        # padding repeats row 0
    np.testing.assert_array_equal(batch[3], batch[0])
    np.testing.assert_array_equal(batch[1, 1],
                                  utterances[2][fresh._spp:
                                                fresh._spp + fresh._need])


def test_streaming_push_poll_matches_serve(system, utterances, jax_results):
    """Chunked Session.push/poll gives the bulk-served transcript."""
    eng = _port_engine(system, 1)
    spp = eng.plan.samples_per_step
    audio = utterances[0]
    sess = eng.open()
    for off in range(0, len(audio), spp):
        sess.push(audio[off:off + spp])
        live = sess.poll()
        assert set(live) >= {"words", "tokens", "score", "steps"}
    final = sess.finish()
    want = jax_results[1][0]
    np.testing.assert_array_equal(final["words"], want["words"])
    np.testing.assert_array_equal(final["tokens"], want["tokens"])
    assert final["score"] == pytest.approx(want["score"], rel=1e-4)


def test_poisoned_slot_is_isolated_and_survivors_unchanged(system,
                                                           utterances):
    """A step that fails only when slot 1 is in it: bisection pins the
    fault to that session, the others finish exactly as without the
    fault (the failed steps committed nothing)."""
    clean = _port_engine(system, 4).serve(utterances)
    eng = _port_engine(system, 4)
    run_step = eng._run_step

    def failing(stream_state, beam_state, samples, slots):
        if (slots == 1).any():
            raise RuntimeError("injected step failure")
        return run_step(stream_state, beam_state, samples, slots)

    eng._run_step = failing
    sessions = [eng.open() for _ in utterances]
    for s, a in zip(sessions, utterances):
        s.push(a)
    for i, s in enumerate(sessions):
        if i == 1:
            with pytest.raises(SessionFaulted):
                s.finish()
        else:
            res = s.finish()
            np.testing.assert_array_equal(res["words"], clean[i]["words"])
            assert res["score"] == clean[i]["score"]
    assert eng.metrics.faulted_sessions == 1


def test_engine_config_validation_and_backpressure(system):
    prog = AsrProgram(system[0], system[2], system[3])
    with pytest.raises(ValueError):
        EngineConfig(prog, n_slots=0)
    cfg = EngineConfig(prog, faults=FaultPolicy([FaultSpec("asr_step")]),
                       worker_watchdog=0.4)
    assert cfg.worker_watchdog == 0.4 and cfg.faults.specs[0].site == \
        "asr_step"
    for bad in (0, -1.0):
        with pytest.raises(ValueError, match="worker_watchdog"):
            EngineConfig(prog, worker_watchdog=bad)
    eng = _port_engine(system, 1, max_queue=0)
    sess = eng.open()
    with pytest.raises(AdmissionRejected):
        eng.open()
    with pytest.raises(ValueError, match="NaN"):
        sess.push(np.array([0.0, np.nan], np.float32))


def test_queue_high_water_counts_an_open_before_its_admission(system):
    """`max_queue` bounds the queue while every slot is busy.  An open
    that finds the queue full but a slot free (released, not yet refilled
    by the pump) is appended, sampled and then admitted within the same
    call, so the high-water depth reads `max_queue + 1`, and never more.
    Both packages sample alike; the network phase of the card script holds
    the server's high-water depth to this bound."""
    from repro.serving import AdmissionRejected as JaxRejected
    from repro.serving import SessionFaulted as JaxFaulted

    def drive(eng, faulted, rejected):
        first = eng.open()
        eng.open()                               # queued: depth 1
        eng._fault_session(first, faulted(first.sid, "slot released"))
        eng.open()                               # appended (2), admits one
        depth_after = len(eng._queue)
        with pytest.raises(rejected):            # slot busy, queue full
            eng.open()
        return eng.metrics.max_queue_depth, depth_after

    jeng, _ = jserve.asr_demo_engine(1, JaxPolicy("ref"), max_queue=1)
    want = drive(jeng, JaxFaulted, JaxRejected)
    got = drive(_port_engine(system, 1, max_queue=1), SessionFaulted,
                AdmissionRejected)
    assert got == want == (2, 1)
