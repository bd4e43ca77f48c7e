"""The port's dense LM (`repro_torch.models.LM`) vs the JAX package's
(`repro.models.LM`) on the reference's own parameters.

Tiny configs of the three dense archs the port covers (h2o-danube-1.8b:
sliding window 64 at tiny size, RoPE; chatglm3-6b: 2D-RoPE, QKV bias,
2 kv heads; qwen2-72b: QKV bias, RoPE theta 1e6), cast to fp32; the JAX
package initialises the parameters and `params_from_numpy` carries them
across.  Tolerances: logits atol 1e-4, caches atol 1e-5 (fp32, two
frameworks); the bf16 prefill and decode at the relative 2e-2 of
tests/test_models.py.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.models import LM as JLM  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import LM, pad_vocab, params_from_numpy  # noqa: E402

torch.set_num_threads(1)

ARCHS = ["h2o-danube-1.8b", "chatglm3-6b", "qwen2-72b"]
LOGIT_ATOL = 1e-4
CACHE_ATOL = 1e-5


def _cfgs(arch, dtype="float32"):
    """(JAX config, port config): the same tiny config from each
    package's own registry."""
    jc = dataclasses.replace(jget(arch).tiny(), dtype=dtype)
    tc = dataclasses.replace(get_config(arch).tiny(), dtype=dtype)
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    return jc, tc


_MODELS = {}


def _models(arch, dtype="float32"):
    """(jax LM, jax params, port LM, port params), built once per arch."""
    key = (arch, dtype)
    if key not in _MODELS:
        jc, tc = _cfgs(arch, dtype)
        jlm = JLM(jc)
        jp = jlm.init(jax.random.PRNGKey(0))
        _MODELS[key] = (jlm, jp, LM(tc), params_from_numpy(jp))
    return _MODELS[key]


def _toks(seed, B, S, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


def _cmp_tree(t, j, atol, path=""):
    if isinstance(j, dict):
        assert set(t) == set(j), (path, set(t), set(j))
        for k in j:
            _cmp_tree(t[k], j[k], atol, f"{path}/{k}")
        return
    assert tuple(t.shape) == tuple(np.shape(j)), (path, t.shape, np.shape(j))
    np.testing.assert_allclose(_np(t), _np(j), rtol=atol, atol=atol,
                               err_msg=path)


def test_configs_are_the_references():
    from repro.configs import ASSIGNED_ARCHS as JA
    from repro_torch.configs import ASSIGNED_ARCHS, list_configs
    assert ASSIGNED_ARCHS == JA
    for arch in ASSIGNED_ARCHS:
        assert dataclasses.asdict(get_config(arch)) == \
            dataclasses.asdict(jget(arch))
        assert get_config(arch).param_counts() == jget(arch).param_counts()
    assert set(list_configs()) == set(ASSIGNED_ARCHS)
    full = get_config("h2o-danube-1.8b")
    assert (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads,
            full.head_dim, full.attn_window) == (24, 2560, 32, 8, 80, 4096)
    assert pad_vocab(full.vocab_size) == 32256


def test_params_from_numpy_carries_bf16_bit_for_bit():
    jc, _ = _cfgs("chatglm3-6b", "bfloat16")
    jp = JLM(jc).init(jax.random.PRNGKey(3))
    tp = params_from_numpy(jp)
    w = np.asarray(jp["layers"]["p0"]["mixer"]["wqkv"]["w"])
    t = tp["layers"]["p0"]["mixer"]["wqkv"]["w"]
    assert t.dtype == torch.bfloat16 and tuple(t.shape) == w.shape
    assert np.array_equal(t.view(torch.int16).numpy().view(np.uint16),
                          w.view(np.uint16))
    assert tp["final_norm"]["scale"].dtype == torch.float32


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_jax(arch):
    jlm, jp, tlm, tp = _models(arch)
    B, S = 2, 96            # S > the tiny window (64) of h2o-danube-1.8b
    toks = _toks(1, B, S, jlm.cfg.vocab_size)
    jl_, jcache = jlm.prefill(jp, {"tokens": jnp.asarray(toks)})
    tl_, tcache = tlm.prefill(tp, {"tokens": torch.from_numpy(toks)})
    assert tuple(tl_.shape) == (B, pad_vocab(jlm.cfg.vocab_size))
    np.testing.assert_allclose(_np(tl_), _np(jl_), rtol=0, atol=LOGIT_ATOL)
    _cmp_tree(tcache["layers"], jcache["layers"], CACHE_ATOL)
    assert tcache["kpos"].tolist() == np.asarray(jcache["kpos"]).tolist()
    assert int(tcache["offset"]) == int(jcache["offset"])


@pytest.mark.parametrize("arch", ARCHS)
def test_masked_prefill_matches_jax(arch):
    """The bucketed path: right-padded rows with their own lengths, the
    cache assembled per row at a ring width of its own (rows longer
    than the ring arrive trimmed)."""
    jlm, jp, tlm, tp = _models(arch)
    B, S = 3, 96
    toks = _toks(2, B, S, jlm.cfg.vocab_size)
    lens = np.array([96, 9, 70], np.int32)
    ring = jlm.cache_len(128)
    jl_, jc = jlm.prefill(jp, {"tokens": jnp.asarray(toks)},
                          lengths=jnp.asarray(lens), cache_len=ring)
    tl_, tc = tlm.prefill(tp, {"tokens": torch.from_numpy(toks)},
                          lengths=torch.from_numpy(lens), cache_len=ring)
    np.testing.assert_allclose(_np(tl_), _np(jl_), rtol=0, atol=LOGIT_ATOL)
    _cmp_tree(tc["layers"], jc["layers"], CACHE_ATOL)
    assert tc["kpos"].tolist() == np.asarray(jc["kpos"]).tolist()
    assert tc["offset"].tolist() == np.asarray(jc["offset"]).tolist()


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_prefill_and_jax(arch):
    """Prefill of S tokens == prefill of S-1 + one decode step (the
    check of tests/test_models.py), and the decode step equals the
    reference's on the same cache."""
    jlm, jp, tlm, tp = _models(arch)
    B, S = 2, 32
    toks = _toks(3, B, S, jlm.cfg.vocab_size)
    V = jlm.cfg.vocab_size
    full, _ = tlm.prefill(tp, {"tokens": torch.from_numpy(toks)})
    _, c1 = tlm.prefill(tp, {"tokens": torch.from_numpy(toks[:, :S - 1])})
    cache = tlm.init_cache(B, S)
    for name, lay in cache["layers"].items():
        for kv in ("k", "v"):
            lay[kv][:, :, :S - 1] = c1["layers"][name][kv]
    cache["kpos"][:S - 1] = c1["kpos"]
    cache["offset"] = c1["offset"]
    # copies: the port's decode step writes the new KV into `cache`
    jcache = jax.tree.map(lambda a: jnp.asarray(np.array(a.numpy())), cache)
    dec, tok, new = tlm.decode_step(
        tp, cache, {"tokens": torch.from_numpy(toks[:, S - 1:])})
    jdec, jtok, jnew = jlm.decode_step(
        jp, jcache, {"tokens": jnp.asarray(toks[:, S - 1:])})
    lf, ld = _np(full)[:, :V], _np(dec)[:, :V]
    assert np.abs(lf - ld).max() / (np.abs(lf).max() + 1e-9) < 1e-5
    np.testing.assert_allclose(_np(dec)[:, :V], _np(jdec)[:, :V], rtol=0,
                               atol=LOGIT_ATOL)
    assert (_np(dec)[:, V:] == -np.inf).all()
    assert tok.tolist() == np.asarray(jtok).tolist()
    _cmp_tree(new["layers"], jnew["layers"], CACHE_ATOL)
    assert new["kpos"].tolist() == np.asarray(jnew["kpos"]).tolist()
    assert int(new["offset"]) == int(jnew["offset"]) == S


def test_ring_decode_past_the_window_matches_jax():
    """h2o-danube-1.8b (tiny window 64): a 70-token prompt arrives
    trimmed into a per-slot ring of 64 beside a 10-token one, then both
    rows decode 6 steps, wrapping the ring; logits, tokens and caches
    equal the reference's at every step."""
    jlm, jp, tlm, tp = _models("h2o-danube-1.8b")
    V = jlm.cfg.vocab_size
    ring = jlm.cache_len(128)
    assert ring == 64
    toks = _toks(4, 2, 96, V)
    lens = np.array([70, 10], np.int32)
    jl_, jc = jlm.prefill(jp, {"tokens": jnp.asarray(toks)},
                          lengths=jnp.asarray(lens), cache_len=ring)
    tl_, tc = tlm.prefill(tp, {"tokens": torch.from_numpy(toks)},
                          lengths=torch.from_numpy(lens), cache_len=ring)
    jtok = jnp.argmax(jl_[:, :V], axis=-1).astype(jnp.int32)[:, None]
    ttok = torch.argmax(tl_[:, :V], dim=-1)[:, None]
    jdecode = jax.jit(jlm.decode_step)
    for step in range(6):
        assert ttok.tolist() == np.asarray(jtok).tolist(), step
        jlog, jnext, jc = jdecode(jp, jc, {"tokens": jtok})
        tlog, tnext, tc = tlm.decode_step(tp, tc, {"tokens": ttok})
        np.testing.assert_allclose(_np(tlog)[:, :V], _np(jlog)[:, :V],
                                   rtol=0, atol=LOGIT_ATOL, err_msg=str(step))
        jtok, ttok = jnext[:, None], tnext[:, None]
    _cmp_tree(tc["layers"], jc["layers"], CACHE_ATOL)
    assert tc["kpos"].tolist() == np.asarray(jc["kpos"]).tolist()
    assert tc["offset"].tolist() == [76, 16]


def test_bf16_prefill_matches_jax():
    """The model's own dtype: bf16 weights and activations, fp32 norms
    and softmax, at the relative tolerance of tests/test_models.py."""
    jlm, jp, tlm, tp = _models("h2o-danube-1.8b", "bfloat16")
    V = jlm.cfg.vocab_size
    toks = _toks(5, 2, 64, V)
    jl_, _ = jlm.prefill(jp, {"tokens": jnp.asarray(toks)})
    tl_, tc = tlm.prefill(tp, {"tokens": torch.from_numpy(toks)})
    assert tl_.dtype == torch.bfloat16
    assert tc["layers"]["p0"]["k"].dtype == torch.bfloat16
    a, b = _np(tl_)[:, :V], _np(jl_)[:, :V]
    assert np.abs(a - b).max() / (np.abs(b).max() + 1e-9) < 2e-2


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_decode_matches_jax(arch):
    """bf16 decode: a masked prefill of a 70- and a 10-token prompt into a
    ring of 64 (the longer one arrives trimmed and the ring wraps), then
    6 decode steps fed each package's own greedy tokens.  Tokens equal
    at every step, logits at the relative 2e-2 of the bf16 prefill."""
    jlm, jp, tlm, tp = _models(arch, "bfloat16")
    V = jlm.cfg.vocab_size
    ring = 64
    toks = _toks(6, 2, 96, V)
    lens = np.array([70, 10], np.int32)
    jl_, jc = jlm.prefill(jp, {"tokens": jnp.asarray(toks)},
                          lengths=jnp.asarray(lens), cache_len=ring)
    tl_, tc = tlm.prefill(tp, {"tokens": torch.from_numpy(toks)},
                          lengths=torch.from_numpy(lens), cache_len=ring)
    assert tc["layers"]["p0"]["k"].dtype == torch.bfloat16
    jtok = jnp.argmax(jl_[:, :V], axis=-1).astype(jnp.int32)[:, None]
    ttok = torch.argmax(tl_[:, :V], dim=-1)[:, None]
    jdecode = jax.jit(jlm.decode_step)
    for step in range(6):
        assert ttok.tolist() == np.asarray(jtok).tolist(), step
        jlog, jnext, jc = jdecode(jp, jc, {"tokens": jtok})
        tlog, tnext, tc = tlm.decode_step(tp, tc, {"tokens": ttok})
        assert str(tlog.dtype) == f"torch.{jlog.dtype}", step
        a, b = _np(tlog)[:, :V], _np(jlog)[:, :V]
        assert np.abs(a - b).max() / (np.abs(b).max() + 1e-9) < 2e-2, step
        jtok, ttok = jnext[:, None], tnext[:, None]
    assert ttok.tolist() == np.asarray(jtok).tolist()
    assert tc["offset"].tolist() == np.asarray(jc["offset"]).tolist() == \
        [76, 16]


@pytest.mark.parametrize("arch,what", [
    ("qwen2-moe-a2.7b", "MoE"), ("jamba-v0.1-52b", "MoE"),
    ("mamba2-1.3b", "Mamba"), ("qwen2-vl-7b", "M-RoPE"),
    ("musicgen-medium", "embed_inputs")])
def test_unported_families_raise(arch, what):
    with pytest.raises(NotImplementedError, match=what):
        LM(get_config(arch).tiny())


def test_init_matches_reference_shapes():
    _, tc = _cfgs("qwen2-72b")
    jlm = JLM(_cfgs("qwen2-72b")[0])
    shapes = jax.tree.map(lambda a: tuple(a.shape), jlm.param_shapes())
    tp = LM(tc).init(torch.Generator().manual_seed(0))

    def walk(t, j):
        if isinstance(j, dict):
            assert set(t) == set(j)
            for k in j:
                walk(t[k], j[k])
        else:
            assert tuple(t.shape) == j
    walk(tp, shapes)
    w = tp["layers"]["p0"]["mlp"]["w_up"]["w"]
    assert w.dtype == torch.float32
    assert abs(float(w.std()) - 1 / np.sqrt(tc.d_model)) < 0.01
