"""Port features and TDS acoustic model vs the JAX package, on the CPU.

The JAX demo system's parameters (`repro.launch.serve.asr_demo_system`,
drawn from jax.random) are carried across as numpy arrays with
`params_from_numpy`; signals and features are made with numpy from a
seed and fed to both packages.

Tolerances:
  * mfcc: rtol 1e-4, atol 1e-3 — two FFT libraries, then a log domain;
    the reference's own batched and per-row MFCC already differ by up
    to 1.1e-5;
  * forward_batched log-probs: atol 1e-4 — 79 kernels of fp32 sums in
    another order, on log-probs of magnitude ~log(V);
  * stream state: atol 1e-5 — the carried left context is the input of
    each conv (LayerNorm outputs and raw features);
  * quantized weights and scales (`quantize_params`): exact;
  * int8 forward_batched log-probs: atol 1e-4, as for fp32.  The int8
    products themselves are bitwise equal (tests/test_torch_kernels.py),
    but they quantize activations that differ from the reference's in
    the last ulp, and an activation at a rounding boundary then lands on
    the other int8 value: at (B, T) = (2, 32) and (3, 32) one such flip
    moved a frame's log-probs by 0.022-0.031.  The shapes below are
    ones where no activation flips on this CPU (measured max 1.4e-6).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.tds_asr import FEATURE_CONFIG, TDS_CONFIG  # noqa: E402
from repro.core import features as jfeat  # noqa: E402
from repro.core import stepplan as jplan  # noqa: E402
from repro.kernels.policy import KernelPolicy as JaxPolicy  # noqa: E402
from repro.launch.serve import asr_demo_system  # noqa: E402
from repro.models import tds as jtds  # noqa: E402
from repro_torch.configs import tds_asr as tcfg  # noqa: E402
from repro_torch.core import features as tfeat  # noqa: E402
from repro_torch.core import stepplan as tplan  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels.policy import KernelPolicy as TorchPolicy  # noqa: E402
from repro_torch.models import tds as ttds  # noqa: E402

torch.set_num_threads(1)


def _signal(seed, *shape):
    r = np.random.RandomState(seed)
    return (r.randn(*shape) * 0.3).astype(np.float32)


@pytest.fixture(scope="module")
def demo():
    tds_cfg, _words, _lex, _lm, params, _dec = asr_demo_system()
    np_params = jax.tree.map(np.asarray, params)
    t_cfg = tcfg.TDSConfig(
        stages=tuple(tcfg.TDSStage(s.n_blocks, s.channels, s.feat, s.kernel,
                                   s.subsample) for s in tds_cfg.stages),
        vocab_size=tds_cfg.vocab_size)
    return tds_cfg, t_cfg, params, ttds.params_from_numpy(np_params)


# ---------------------------------------------------------------------------
# features
# ---------------------------------------------------------------------------
# (use_logmel, JAX policy, port route): the plain pipeline; the logmel
# route against JAX's plain tail and its Pallas kernel in interpret mode;
# `ops.mfcc` under the "ref" and "auto" policies on a CPU tensor (both
# the plain version); and under "kernel", which raises on the CPU.
_MFCC_CASES = [(False, "ref", "features"), (True, "ref", "features"),
               (True, "interpret", "features"),
               (True, "interpret", "ops.mfcc ref"),
               (True, "interpret", "ops.mfcc auto"),
               (True, "interpret", "ops.mfcc kernel")]


@pytest.mark.parametrize("use_logmel,jax_policy,route", _MFCC_CASES)
@pytest.mark.parametrize("shape", [(1280,), (2, 3, 1520), (4, 4000)])
def test_mfcc_matches_jax(shape, use_logmel, jax_policy, route):
    sig = _signal(len(shape), *shape)
    x = torch.from_numpy(sig)
    cfg = tcfg.FEATURE_CONFIG
    if route.startswith("ops.mfcc"):
        policy = TorchPolicy(route.split()[1])
        tables = tfeat._tables(cfg, x.device)
        if policy.mode == "kernel":
            with pytest.raises(ValueError, match="CUDA"):
                tops.mfcc(x, cfg, tables, policy=policy)
            return
        got = tops.mfcc(x, cfg, tables, policy=policy)
    else:
        got = tfeat.mfcc(x, cfg, use_logmel=use_logmel)
    want = jfeat.mfcc(jnp.asarray(sig), FEATURE_CONFIG, use_pallas=use_logmel,
                      kernels=JaxPolicy(jax_policy), hot=True)
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-3)


def test_feature_tables_and_framing_match_jax():
    np.testing.assert_array_equal(tfeat.mel_filterbank(tcfg.FEATURE_CONFIG),
                                  jfeat.mel_filterbank(FEATURE_CONFIG))
    np.testing.assert_array_equal(tfeat.dct_matrix(80, 80),
                                  jfeat.dct_matrix(80, 80))
    for n in (0, 399, 400, 401, 1520, 12345):
        assert tfeat.frames_producible(n, tcfg.FEATURE_CONFIG) == \
            jfeat.frames_producible(n, FEATURE_CONFIG)
    assert tfeat.consumed_samples(8, tcfg.FEATURE_CONFIG) == \
        jfeat.consumed_samples(8, FEATURE_CONFIG)


# ---------------------------------------------------------------------------
# model structure
# ---------------------------------------------------------------------------
def test_kernel_specs_census_and_step_plan_match_jax():
    assert [s.__dict__ for s in ttds.build_kernel_specs(tcfg.TDS_CONFIG)] == \
        [s.__dict__ for s in jtds.build_kernel_specs(TDS_CONFIG)]
    assert ttds.kernel_census(tcfg.TDS_CONFIG) == \
        jtds.kernel_census(TDS_CONFIG) == \
        {"conv": 18, "fc": 29, "layernorm": 32}
    tp, jp = tplan.make_step_plan(beam_k=64), jplan.make_step_plan(beam_k=64)
    assert (tp.samples_per_step, tp.feat_frames_per_step,
            tp.acoustic_frames_per_step, tp.total_threads()) == \
        (jp.samples_per_step, jp.feat_frames_per_step,
         jp.acoustic_frames_per_step, jp.total_threads())


def test_init_tds_shapes_and_std_match_jax(demo):
    tds_cfg, t_cfg, jparams, _ = demo
    tparams = ttds.init_tds(torch.Generator().manual_seed(0), t_cfg)
    assert tparams.keys() == jparams.keys()
    for name, p in tparams.items():
        for k, v in p.items():
            assert tuple(v.shape) == tuple(jparams[name][k].shape), (name, k)
            assert v.dtype == torch.float32
    for spec in ttds.build_kernel_specs(t_cfg):
        if spec.kind in ("conv", "fc", "head"):
            w = tparams[spec.name]["w"]
            assert abs(float(w.std()) * np.sqrt(spec.n_in) - 1.0) < 0.25
            assert not tparams[spec.name]["b"].any()


def test_stream_state_helpers():
    st = ttds.init_batched_stream_state(tcfg.TDS_CONFIG, 3)
    ref = jtds.init_batched_stream_state(TDS_CONFIG, 3)
    assert {k: tuple(v.shape) for k, v in st.items()} == \
        {k: tuple(v.shape) for k, v in ref.items()}
    filled = {k: torch.ones_like(v) for k, v in st.items()}
    reset = ttds.reset_stream_slot(filled, 1, tcfg.TDS_CONFIG)
    for k, v in reset.items():
        assert not v[1].any() and v[0].all() and v[2].all()
        assert filled[k].all()          # the input tree is not modified


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("batch,t", [(1, 8), (3, 32)])
def test_forward_batched_matches_jax(demo, batch, t):
    tds_cfg, t_cfg, jparams, tparams = demo
    feats = _signal(10 + batch, batch, t, 80)
    jstate = jtds.init_batched_stream_state(tds_cfg, batch)
    rng = np.random.RandomState(3)
    jstate = {k: jnp.asarray(rng.randn(*v.shape).astype(np.float32))
              for k, v in jstate.items()}          # a mid-utterance context
    fwd = jax.jit(lambda p, f, s: jtds.forward_batched(
        p, tds_cfg, f, s, kernels=JaxPolicy("ref")))
    want_lp, want_st = fwd(jparams, jnp.asarray(feats), jstate)
    tstate = {k: torch.from_numpy(np.array(v)) for k, v in jstate.items()}
    got_lp, got_st = ttds.forward_batched(tparams, t_cfg,
                                          torch.from_numpy(feats), tstate)
    np.testing.assert_allclose(got_lp.numpy(), np.asarray(want_lp), atol=1e-4)
    assert got_st.keys() == want_st.keys()
    for k in want_st:
        np.testing.assert_allclose(got_st[k].numpy(), np.asarray(want_st[k]),
                                   atol=1e-5, err_msg=k)
    for k in jstate:                      # the input state is not modified
        np.testing.assert_array_equal(tstate[k].numpy(),
                                      np.asarray(jstate[k]))


def test_forward_streaming_matches_offline_and_batched(demo):
    _, t_cfg, _, tparams = demo
    feats = torch.from_numpy(_signal(5, 2, 32, 80))
    off, _ = ttds.forward(tparams, t_cfg, feats[0])
    st = None
    parts = []
    for c in range(4):                    # four 8-frame streaming steps
        lp, st = ttds.forward(tparams, t_cfg, feats[0, 8 * c:8 * (c + 1)], st)
        parts.append(lp)
    torch.testing.assert_close(torch.cat(parts), off, rtol=1e-5, atol=1e-5)
    bst = ttds.init_batched_stream_state(t_cfg, 2)
    blp, _ = ttds.forward_batched(tparams, t_cfg, feats, bst)
    torch.testing.assert_close(blp[0], off, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# int8 program
# ---------------------------------------------------------------------------
def test_quantize_params_matches_jax(demo):
    tds_cfg, t_cfg, jparams, tparams = demo
    want = jtds.quantize_params(jparams, tds_cfg)
    got = ttds.quantize_params(tparams, t_cfg)
    assert got.keys() == want.keys() and len(got) == sum(
        s.kind in ("fc", "head") for s in ttds.build_kernel_specs(t_cfg))
    for name in want:
        assert got[name]["wq"].dtype == torch.int8
        np.testing.assert_array_equal(got[name]["wq"].numpy(),
                                      np.asarray(want[name]["wq"]), name)
        np.testing.assert_array_equal(got[name]["ws"].numpy(),
                                      np.asarray(want[name]["ws"]), name)


def _int8_forward_pair(demo, batch, t, prepared):
    tds_cfg, t_cfg, jparams, tparams = demo
    feats = _signal(10 + batch, batch, t, 80)
    jstate = jtds.init_batched_stream_state(tds_cfg, batch)
    rng = np.random.RandomState(3)
    jstate = {k: jnp.asarray(rng.randn(*v.shape).astype(np.float32))
              for k, v in jstate.items()}          # a mid-utterance context
    jprep = jtds.quantize_params(jparams, tds_cfg) if prepared else None
    tprep = ttds.quantize_params(tparams, t_cfg) if prepared else None
    fwd = jax.jit(lambda p, q, f, s: jtds.forward_batched(
        p, tds_cfg, f, s, use_int8=True, kernels=JaxPolicy("ref"),
        prepared=q))
    want_lp, want_st = fwd(jparams, jprep, jnp.asarray(feats), jstate)
    tstate = {k: torch.from_numpy(np.array(v)) for k, v in jstate.items()}
    got_lp, got_st = ttds.forward_batched(
        tparams, t_cfg, torch.from_numpy(feats), tstate, use_int8=True,
        prepared=tprep)
    return got_lp, want_lp, got_st, want_st


@pytest.mark.parametrize("prepared", [True, False])
@pytest.mark.parametrize("batch,t", [(1, 8), (4, 16)])
def test_int8_forward_batched_matches_jax(demo, batch, t, prepared):
    got_lp, want_lp, got_st, want_st = _int8_forward_pair(demo, batch, t,
                                                          prepared)
    assert tuple(got_lp.shape) == tuple(want_lp.shape)
    np.testing.assert_allclose(got_lp.numpy(), np.asarray(want_lp), atol=1e-4)
    for k in want_st:
        np.testing.assert_allclose(got_st[k].numpy(), np.asarray(want_st[k]),
                                   atol=1e-5, err_msg=k)


def test_int8_program_raises_not_implemented(demo):
    """The int8 program runs (it raised NotImplementedError before it was
    ported): `forward`, the B=1 slice, with prepared weights equals the
    JAX package's int8 forward, and offline equals streaming."""
    tds_cfg, t_cfg, jparams, tparams = demo
    feats = _signal(21, 16, 80)
    want, _ = jax.jit(lambda p, q, f: jtds.forward(
        p, tds_cfg, f, use_int8=True, kernels=JaxPolicy("ref"),
        prepared=q))(jparams, jtds.quantize_params(jparams, tds_cfg),
                     jnp.asarray(feats))
    prep = ttds.quantize_params(tparams, t_cfg)
    got, _ = ttds.forward(tparams, t_cfg, torch.from_numpy(feats),
                          use_int8=True, prepared=prep)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    st, parts = None, []
    for c in range(2):
        lp, st = ttds.forward(tparams, t_cfg,
                              torch.from_numpy(feats[8 * c:8 * (c + 1)]), st,
                              use_int8=True, prepared=prep)
        parts.append(lp)
    torch.testing.assert_close(torch.cat(parts), got, rtol=1e-5, atol=1e-5)
