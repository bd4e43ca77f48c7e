"""Port ASRPU command-API shims (`repro_torch.core.scheduler`) vs the JAX
package's, on the CPU.

Both shims get the same tiny system: the reference's `TINY_TDS`
parameters (jax.random) carried across with `params_from_numpy`, the
lexicon and bigram LM with `from_numpy`, and the same audio made with
numpy from a seed.  After every command the port must report what the
reference reports: step counts equal, best words and tokens equal,
scores within rtol 1e-4 for the fp32 program and 1e-2 for the int8
program (an activation one ulp off the reference's can quantize to the
neighbouring int8 value; see tests/test_torch_engine.py).
"""
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs.tds_asr import DecoderConfig as JDec  # noqa: E402
from repro.configs.tds_asr import FeatureConfig as JFeat  # noqa: E402
from repro.configs.tds_asr import TDSConfig as JTDS  # noqa: E402
from repro.configs.tds_asr import TDSStage as JStage  # noqa: E402
from repro.core import lexicon as jlx  # noqa: E402
from repro.core import scheduler as jsched  # noqa: E402
from repro.data.pipeline import SyntheticASR  # noqa: E402
from repro.models import tds as jtds  # noqa: E402
from repro_torch.configs import tds_asr as tcfg  # noqa: E402
from repro_torch.core import lexicon as tlx  # noqa: E402
from repro_torch.core import scheduler as tsched  # noqa: E402
from repro_torch.models import tds as ttds  # noqa: E402

torch.set_num_threads(1)

STAGES = ((1, 3, 16, 5, 2), (1, 4, 16, 5, 2), (1, 4, 16, 5, 2))
WORDS = {f"w{i}": [1 + (i * 3 + j) % 18 for j in range(2 + i % 3)]
         for i in range(8)}


@pytest.fixture(scope="module")
def systems():
    """(jax system, port system): each a dict of tds_cfg, params,
    feat_cfg, lex, lm, dec_cfg."""
    j_cfg = JTDS(stages=tuple(JStage(*s) for s in STAGES), sub_kernel=6,
                 vocab_size=20)
    t_cfg = tcfg.TDSConfig(stages=tuple(tcfg.TDSStage(*s) for s in STAGES),
                           sub_kernel=6, vocab_size=20)
    params = jtds.init_tds(jax.random.PRNGKey(0), j_cfg)
    lex = jlx.build_lexicon(WORDS, max_children=16)
    lm = jlx.uniform_bigram(len(WORDS))
    dec = dict(beam_size=16, beam_threshold=30.0)
    jsys = dict(tds_cfg=j_cfg, params=params, lex=lex, lm=lm,
                feat_cfg=JFeat(n_mels=16, n_mfcc=16), dec_cfg=JDec(**dec))
    tsys = dict(
        tds_cfg=t_cfg,
        params=ttds.params_from_numpy(jax.tree.map(np.asarray, params)),
        lex=tlx.Lexicon.from_numpy(np.asarray(lex.children),
                                   np.asarray(lex.child_token),
                                   np.asarray(lex.word_id), lex.n_nodes,
                                   lex.max_children),
        lm=tlx.BigramLM.from_numpy(np.asarray(lm.table), lm.n_words),
        feat_cfg=tcfg.FeatureConfig(n_mels=16, n_mfcc=16),
        dec_cfg=tcfg.DecoderConfig(**dec))
    return jsys, tsys


def _configure(pu, sys_, use_int8=False):
    pu.configure_acoustic_scoring(sys_["tds_cfg"], sys_["params"],
                                  sys_["feat_cfg"], use_int8=use_int8)
    pu.configure_hyp_expansion(sys_["lex"], sys_["lm"], sys_["dec_cfg"])
    return pu


def _pair(systems, name="ASRPU", use_int8=False, args=()):
    """The reference's shim and the port's, configured alike."""
    jsys, tsys = systems
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        jpu = getattr(jsched, name)(*args)
        tpu = getattr(tsched, name)(*args, device="cpu")
    return _configure(jpu, jsys, use_int8), _configure(tpu, tsys, use_int8)


def _same(got, want, rel):
    np.testing.assert_array_equal(got["words"], want["words"])
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    if np.isfinite(want["score"]):
        assert got["score"] == pytest.approx(want["score"], rel=rel)
    else:
        assert got["score"] == want["score"]


def _audio(seed, n):
    return np.random.RandomState(seed).randn(n).astype(np.float32)


@pytest.mark.parametrize("use_int8", [False, True])
def test_asrpu_end_to_end_streaming_matches_jax(systems, use_int8):
    """configure -> DecodingStep* -> CleanDecoding -> DecodingStep, held
    against the reference after every command (the flow of
    tests/test_asr_system.py::test_asrpu_end_to_end_streaming)."""
    rel = 1e-2 if use_int8 else 1e-4
    jpu, tpu = _pair(systems, use_int8=use_int8)
    jpu.configure_beam_width(20.0)
    tpu.configure_beam_width(20.0)
    audio = _audio(0, 16000)                  # 1 s in 40 ms chunks
    for off in range(0, 16000, 640):
        want = jpu.decoding_step(audio[off:off + 640])
        got = tpu.decoding_step(audio[off:off + 640])
        assert tpu._n_steps == jpu._n_steps
        _same(got, want, rel)
    prog = tpu._engine.program
    assert prog.use_int8 is use_int8 and prog.dec_cfg.beam_threshold == 20.0
    assert prog.max_windows_per_step == 1 and prog.flush_tail is False
    assert tpu._n_steps >= 11 and np.isfinite(got["score"])
    _same(tpu.best(final=True), jpu.best(final=True), rel)
    jpu.clean_decoding()
    tpu.clean_decoding()
    assert tpu._n_steps == 0 and tpu.best()["score"] == -np.inf
    _same(tpu.decoding_step(audio[:3200]), jpu.decoding_step(audio[:3200]),
          rel)
    assert tpu._n_steps == jpu._n_steps == 2


def test_setup_thread_zero_returns_stops_step(systems):
    """Too few samples for one window: no decoding step runs, and the
    readout is a fresh beam, as in the reference."""
    jpu, tpu = _pair(systems)
    got = tpu.decoding_step(np.zeros(100, np.float32))
    want = jpu.decoding_step(np.zeros(100, np.float32))
    assert tpu._n_steps == jpu._n_steps == 0
    _same(got, want, 1e-4)


def test_configure_beam_width_between_decoding_steps(systems):
    """A ConfigureBeamWidth between DecodingSteps swaps in a new engine
    that adopts the in-flight state (`AsrEngine.adopt_state`): sample
    buffer, left context, beam and step count carry over."""
    jpu, tpu = _pair(systems)
    audio = SyntheticASR(WORDS).utterance(1)["audio"]
    half = (len(audio) // 2) // 640 * 640
    for off in range(0, half, 640):
        jpu.decoding_step(audio[off:off + 640])
        tpu.decoding_step(audio[off:off + 640])
    old = tpu._engine
    n_before = tpu._n_steps
    buffered = old._slot_bufs[0].copy()
    jpu.configure_beam_width(5.0)
    tpu.configure_beam_width(5.0)
    assert tpu._engine is not old
    assert tpu._engine.program.dec_cfg.beam_threshold == 5.0
    assert tpu._n_steps == n_before > 0
    np.testing.assert_array_equal(tpu._engine._slot_bufs[0], buffered)
    assert tpu._beam is old._beam and tpu._stream_state is old._stream_state
    for off in range(half, len(audio), 640):
        want = jpu.decoding_step(audio[off:off + 640])
        got = tpu.decoding_step(audio[off:off + 640])
        assert tpu._n_steps == jpu._n_steps
        _same(got, want, 1e-4)
    _same(tpu.best(final=True), jpu.best(final=True), 1e-4)


def test_multistream_serve_matches_jax(systems):
    jpu, tpu = _pair(systems, "MultiStreamASRPU", args=(2,))
    data = SyntheticASR(WORDS)
    utts = [data.utterance(u)["audio"] for u in range(3)]
    got, want = tpu.serve(utts), jpu.serve(utts)
    assert len(got) == 3
    for g, w in zip(got, want):
        _same(g, w, 1e-4)
        assert g["steps"] == w["steps"]


def test_multistream_slot_commands_match_jax(systems):
    """DecodingStep(slot, x) advances every stream; CleanDecoding(slot)
    resets one stream only."""
    jpu, tpu = _pair(systems, "MultiStreamASRPU", True, (2,))
    a, b = _audio(1, 4000), _audio(2, 6000)
    for pu in (jpu, tpu):
        pu.decoding_step(a, slot=0)
        pu.decoding_step(b, slot=1)
    assert tpu._n_steps == jpu._n_steps > 0
    for s in (0, 1):
        _same(tpu.best(slot=s), jpu.best(slot=s), 1e-2)
        _same(tpu.best(slot=s, final=True), jpu.best(slot=s, final=True),
              1e-2)
    kept = tpu.best(slot=1)
    jpu.clean_decoding(slot=0)
    tpu.clean_decoding(slot=0)
    assert tpu.best(slot=0)["score"] == 0.0 == jpu.best(slot=0)["score"]
    _same(tpu.best(slot=1), kept, 0.0)


def test_deprecated_shims_warn_and_need_configuration():
    with pytest.warns(DeprecationWarning,
                      match="ASRPU is deprecated.*repro_torch.serving"):
        pu = tsched.ASRPU(device="cpu")
    with pytest.warns(DeprecationWarning, match="MultiStreamASRPU"):
        tsched.MultiStreamASRPU(2, device="cpu")
    assert pu.best()["score"] == -np.inf and pu._n_steps == 0
    assert pu.hw.mac_vector == 8 and pu.hw.n_pes == 8
    with pytest.raises(RuntimeError, match="not configured"):
        pu.decoding_step(np.zeros(1280, np.float32))
    with pytest.raises(ValueError):
        tsched.MultiStreamASRPU(0, device="cpu")


def test_shim_runs_on_the_card_unless_given_a_device(systems, monkeypatch):
    """Without `device=` the shim's engine resolves to the card, and with
    no card it raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        pu = _configure(tsched.ASRPU(), systems[1])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pu.decoding_step(np.zeros(1280, np.float32))
