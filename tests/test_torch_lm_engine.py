"""The port's `LmEngine` vs the JAX package's, token for token.

Both engines serve the same prompts (numpy, from a seed) with the same
parameters (the reference's, carried across with `params_from_numpy`)
over tiny fp32 configs of the dense archs at 1 and 2 slots, and of the
SSM (mamba2-1.3b), hybrid (jamba-v0.1-52b) and MoE (qwen2-moe-a2.7b)
archs at 1, 2 and 4 slots; the cases mirror the LM engine tests of
tests/test_serving.py (staggered unequal prompts, sliding-window ring
admission with a prompt longer than the window, the session protocol
and admission validation, one-row admissions, bucketed prefill).
Greedy tokens must be equal: fp32 keeps the two frameworks' logits
within ~1e-4 of each other (jamba's 16 layers; ~1e-6 for the rest), far
inside the margins between the top tokens here.  MoE capacity depends
on every token of a prefill batch, bucket padding included, so both
engines must see the same batch composition: they run the same
admission schedule.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.models import LM as JLM  # noqa: E402
from repro.serving import EngineConfig as JEngineConfig  # noqa: E402
from repro.serving import LmEngine as JLmEngine  # noqa: E402
from repro.serving import LmProgram as JLmProgram  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.serving import (AsrEngine, EngineConfig,  # noqa: E402
                                 LmEngine, LmProgram, make_engine)

torch.set_num_threads(1)

_PARAMS = {}


def _setup(arch):
    """(jax cfg, port cfg, the reference's fp32 parameters)."""
    jc = dataclasses.replace(jget(arch).tiny(), dtype="float32")
    tc = dataclasses.replace(get_config(arch).tiny(), dtype="float32")
    if arch not in _PARAMS:
        _PARAMS[arch] = JLM(jc).init(jax.random.PRNGKey(0))
    return jc, tc, _PARAMS[arch]


def _engines(arch, cache_len, max_new, n_slots, buckets=()):
    jc, tc, params = _setup(arch)
    jeng = JLmEngine(JEngineConfig(JLmProgram(jc, cache_len, max_new,
                                              buckets), n_slots=n_slots),
                     params)
    teng = LmEngine(EngineConfig(LmProgram(tc, cache_len, max_new, buckets),
                                 n_slots=n_slots), params, device="cpu")
    return jeng, teng


def _prompts(seed, lengths, vocab=256):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, n) for n in lengths]


@pytest.mark.parametrize("n_slots", [1, 2])
@pytest.mark.parametrize("arch", ["chatglm3-6b", "qwen2-72b"])
def test_staggered_unequal_prompts_match_jax(arch, n_slots):
    """Requests with unequal prompt lengths (slot offsets 5 vs 9) plus a
    queued third admitted into a reused slot: every token stream equals
    the JAX engine's."""
    jeng, teng = _engines(arch, 24, 6, n_slots)
    prompts = _prompts(0, (5, 9, 7))
    got = teng.serve(prompts)
    assert got == jeng.serve(prompts)
    assert all(len(t) == 6 for t in got)
    if n_slots == 2:
        assert teng.n_steps < 3 * 5          # batching batched


FAMILIES = ["mamba2-1.3b", "jamba-v0.1-52b", "qwen2-moe-a2.7b"]
_FAMILY_ENGINES = {}


def _family_engines(arch, n_slots):
    """(jax engine, port engine) over (cache_len 24, max_new 6), built
    once per (arch, n_slots): the JAX engine's jitted prefills and decode
    step are reused by the staggered and the bucketed case."""
    key = (arch, n_slots)
    if key not in _FAMILY_ENGINES:
        _FAMILY_ENGINES[key] = _engines(arch, 24, 6, n_slots)
    return _FAMILY_ENGINES[key]


@pytest.mark.parametrize("n_slots", [1, 2, 4])
@pytest.mark.parametrize("arch", FAMILIES)
def test_staggered_unequal_prompts_match_jax_ssm_moe(arch, n_slots):
    """The staggered case above for the SSM, hybrid and MoE families:
    the Mamba layers' conv/SSM states are scattered into the pool at
    admission and advanced in place by every decode step."""
    jeng, teng = _family_engines(arch, n_slots)
    prompts = _prompts(0, (5, 9, 7))
    got = teng.serve(prompts)
    assert got == jeng.serve(prompts)
    assert all(len(t) == 6 for t in got)
    leaves = {n for lay in teng.cache["layers"].values() for n in lay}
    assert ("ssm" in leaves) == (arch != "qwen2-moe-a2.7b")
    assert ("k" in leaves) == (arch != "mamba2-1.3b")
    for lay in teng.cache["layers"].values():
        if "ssm" in lay:                 # the last request's slot state
            assert lay["ssm"].dtype == torch.float32
            assert lay["ssm"].abs().amax() > 0


@pytest.mark.parametrize("n_slots", [1, 2, 4])
@pytest.mark.parametrize("arch", FAMILIES)
def test_bucketed_prefill_many_lengths_matches_jax_ssm_moe(arch, n_slots):
    """The bucketed case below for the SSM, hybrid and MoE families:
    seven prompt lengths over buckets 8/16/32, each admission group
    padded to its length bucket and batch sub-bucket (so MoE capacity
    counts the same pad tokens in both engines)."""
    jeng, teng = _family_engines(arch, n_slots)
    assert teng.program.buckets() == jeng.program.buckets() == (8, 16, 32)
    shapes = []
    orig = teng._prefill
    teng._prefill = lambda t, l: shapes.append(tuple(t.shape)) or orig(t, l)
    try:
        prompts = _prompts(3, (3, 5, 7, 9, 12, 17, 18))
        assert teng.serve(prompts) == jeng.serve(prompts)
    finally:
        teng._prefill = orig
    assert set(shapes) <= {(b, s) for b in teng._batch_buckets
                           for s in (8, 16, 32)}


@pytest.mark.parametrize("n_slots", [1, 2])
def test_swa_ring_admission_matches_jax(n_slots):
    """h2o-danube-1.8b at tiny size (window 64 < cache_len 128): the
    per-slot rows are ring-sized, and a 96-token prompt arrives trimmed
    into the ring; tokens equal the JAX engine's."""
    jeng, teng = _engines("h2o-danube-1.8b", 128, 4, n_slots)
    assert teng._ring == jeng._ring == 64
    prompts = _prompts(2, (32, 9, 96))
    got = teng.serve(prompts)
    assert got == jeng.serve(prompts)
    assert all(len(t) == 4 for t in got)


def test_bucketed_prefill_many_lengths_matches_jax():
    """Seven distinct prompt lengths over three buckets: the port pads
    each admission to its bucket and batch sub-bucket (prefill shapes
    stay within buckets x batch buckets) and its tokens equal the JAX
    engine's."""
    jeng, teng = _engines("chatglm3-6b", 24, 6, 2)
    assert teng.program.buckets() == jeng.program.buckets() == (8, 16, 32)
    shapes = []
    orig = teng._prefill
    teng._prefill = lambda t, l: shapes.append(tuple(t.shape)) or orig(t, l)
    prompts = _prompts(3, (3, 5, 7, 9, 12, 17, 18))
    assert teng.serve(prompts) == jeng.serve(prompts)
    assert set(shapes) <= {(b, s) for b in (1, 2) for s in (8, 16, 32)}
    assert teng.prefill_cache_entries() is None


def test_lone_admission_prefills_one_row():
    """A lone admission into an 8-slot pool prefills a 1-row batch, with
    the tokens of a 1-slot engine."""
    _, tc, params = _setup("chatglm3-6b")
    program = LmProgram(tc, cache_len=24, max_new=4)
    eng = LmEngine(EngineConfig(program, n_slots=8), params, device="cpu")
    assert eng._batch_buckets == (1, 2, 4, 8)
    shapes = []
    orig = eng._prefill
    eng._prefill = lambda t, l: shapes.append(tuple(t.shape)) or orig(t, l)
    lone = _prompts(5, (5,))
    got = eng.serve(lone)
    assert shapes == [(1, 8)]
    one = LmEngine(EngineConfig(program, n_slots=1), params, device="cpu")
    assert got == one.serve(lone)
    shapes.clear()
    eng.serve(_prompts(6, (3, 5, 7)))
    assert shapes == [(1, 8)] * 3


def test_session_protocol_and_validation():
    _, tc, params = _setup("h2o-danube-1.8b")
    program = LmProgram(tc, cache_len=16, max_new=4)
    eng = LmEngine(EngineConfig(program, n_slots=2), params, device="cpu")
    s = eng.open()
    assert s.poll() == {"tokens": [], "done": False}
    out = s.push(np.arange(1, 6, dtype=np.int32)).poll()
    assert out["done"] and len(out["tokens"]) == 4
    out["tokens"].append(-1)                 # a copy: the engine's is safe
    assert len(s.poll()["tokens"]) == 4
    with pytest.raises(RuntimeError, match="one prompt"):
        s.push(np.arange(1, 3))
    bad = [np.ones((20,), np.int32),                    # too long
           np.zeros((0,), np.int32),                    # empty
           np.ones((2, 3), np.int32),                   # not 1-D
           np.ones((4,), np.float32),                   # not integers
           np.array([1, 2, tc.vocab_size], np.int64),   # out of vocabulary
           np.array([-1, 2], np.int64)]
    for prompt in bad:
        with pytest.raises(ValueError):
            eng.open().push(prompt)
    # finish() on a session that never pushed a prompt closes it empty
    idle = eng.open()
    assert idle.finish() == {"tokens": [], "done": True}
    assert idle.poll() == {"tokens": [], "done": True}
    assert idle not in eng._queue


def test_program_buckets_and_validation_match_jax():
    jc, tc, _ = _setup("h2o-danube-1.8b")
    for cache_len, max_new, buckets in ((32, 8, ()), (128, 4, ()),
                                        (96, 32, (32, 64))):
        want = JLmProgram(jc, cache_len, max_new, buckets).buckets()
        assert LmProgram(tc, cache_len, max_new, buckets).buckets() == want
    for buckets in ((16,), (48,)):        # too small / not chunk-divisible
        with pytest.raises(ValueError):
            JLmProgram(jc, 96, 32, buckets).buckets()
        with pytest.raises(ValueError):
            LmProgram(tc, 96, 32, buckets).buckets()
    full = get_config("h2o-danube-1.8b")
    prog = LmProgram(full, cache_len=6176, max_new=32,
                     prefill_buckets=(512, 2048, 6144))
    assert prog.buckets() == (512, 2048, 6144)
    assert prog.max_prompt_len == 6144


def test_make_engine_and_config():
    from repro_torch.launch.serve import asr_demo_system
    _, tc, params = _setup("chatglm3-6b")
    lm = make_engine(EngineConfig(LmProgram(tc, 24, 4), n_slots=2), params,
                     device="cpu")
    assert isinstance(lm, LmEngine) and lm.device.type == "cpu"
    with pytest.raises(TypeError):
        LmEngine(EngineConfig(object(), n_slots=1), params, device="cpu")
    from repro_torch.serving import AsrProgram
    tds_cfg, _, lex, lmb, aparams, dcfg = asr_demo_system()
    asr = make_engine(EngineConfig(AsrProgram(tds_cfg, lex, lmb,
                                              dec_cfg=dcfg)), aparams,
                      device="cpu")
    assert isinstance(asr, AsrEngine)
    with pytest.raises(TypeError):
        make_engine(EngineConfig(object()), None, device="cpu")


class _Parsed(Exception):
    pass


def _launcher_defaults(main, monkeypatch) -> dict:
    """The defaults of a launcher's argument parser: `main([])` is
    stopped right after it parsed its (empty) arguments."""
    import argparse
    orig = argparse.ArgumentParser.parse_args

    def parse(self, args=None, namespace=None):
        raise _Parsed(vars(orig(self, [], namespace)))
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", parse)
    with pytest.raises(_Parsed) as stop:
        main([])
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", orig)
    return stop.value.args[0]


def test_launcher_default_arch_is_the_references(monkeypatch):
    """`--mode lm` with no `--arch` serves the same model in both
    packages: mamba2-1.3b."""
    from repro.launch import serve as jserve
    from repro_torch.launch import serve
    mine = _launcher_defaults(serve.main, monkeypatch)
    theirs = _launcher_defaults(jserve.main, monkeypatch)
    assert mine["arch"] == theirs["arch"] == "mamba2-1.3b"
    for key in ("mode", "requests", "slots", "prompt_len", "max_new",
                "utterances", "streams", "kernels"):
        assert mine[key] == theirs[key], key


def test_launcher_lm_mode_on_cpu_and_gpu_default(monkeypatch, capsys):
    from repro_torch.launch import serve
    out = serve.main(["--mode", "lm", "--requests", "3", "--slots", "2",
                      "--prompt-len", "8", "--max-new", "4",
                      "--device", "cpu"])
    assert sorted(out) == [0, 1, 2]
    assert all(len(t) == 4 for t in out.values())
    assert "served 3 requests, 12 tokens" in capsys.readouterr().out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--mode", "lm", "--requests", "1"])
