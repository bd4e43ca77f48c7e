"""int8 LM serving weights in the port (`layers.quantize_linear`,
`layers.quantize_params_for_serving`, the `wq` branch of `layers.linear`)
against the JAX package's.

The reference's parameters (tiny configs) are carried across with
`params_from_numpy` and quantized by both packages: the tree, `wq` and
`wscale` must be bit for bit the reference's (true divisions, round half
to even), for every assigned architecture.  The port of
tests/test_serving_opts.py's `test_int8_serving_weights_close` keeps its
four bounds (int8 against the same model's bf16 logits); int8 prefill
and decode logits against the reference's int8 logits at atol 1e-4 in
fp32 (tests/test_torch_lm.py's bound: the dequantized weights are equal,
so only sums in another order separate the two).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ASSIGNED_ARCHS  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.models import LM as JLM  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.treeutil import leaves_with_paths  # noqa: E402
from repro_torch.models import LM, params_from_numpy  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402

torch.set_num_threads(1)

LOGIT_ATOL = 1e-4


def _cfgs(arch, dtype=None):
    jc, tc = jget(arch).tiny(), get_config(arch).tiny()
    if dtype is not None:
        jc = dataclasses.replace(jc, dtype=dtype)
        tc = dataclasses.replace(tc, dtype=dtype)
    return jc, tc


def _same_bits(t, j, path):
    j = np.asarray(j)
    assert tuple(t.shape) == j.shape, path
    assert str(t.dtype) == f"torch.{j.dtype}", (path, t.dtype, j.dtype)
    if t.dtype == torch.bfloat16:
        got, want = t.view(torch.int16).numpy().view(np.uint16), \
            j.view(np.uint16)
    else:
        got, want = t.numpy(), j
    assert np.array_equal(got.view(np.uint8), want.view(np.uint8)), path


def _batch(cfg, seed, B, S):
    """(jax batch, port batch): tokens, or embeddings where the config
    takes them."""
    r = np.random.default_rng(seed)
    if cfg.embed_inputs:
        a = r.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
        return {"tokens": jnp.asarray(a)}, {"tokens": torch.from_numpy(a)}
    a = r.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    return {"embeds": jnp.asarray(a)}, {"embeds": torch.from_numpy(a)}


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_quantize_params_for_serving_is_the_references_bitwise(arch):
    """The whole tree of every assigned architecture (the config's own
    dtype): the same keys, every `wq` and `wscale` bit for bit, every
    leaf left as it was (embeddings, norms, expert tensors, the router,
    the SSM parameters and their projections) unchanged, bit for bit."""
    jc, tc = _cfgs(arch)
    jp = JLM(jc).init(jax.random.PRNGKey(0))
    jq = jl.quantize_params_for_serving(jp)
    tp = params_from_numpy(jp)
    tq = tl.quantize_params_for_serving(tp)
    want = dict(leaves_with_paths(jax.tree.map(np.asarray, jq)))
    got = dict(leaves_with_paths(tq))
    assert set(got) == set(want)
    orig = dict(leaves_with_paths(tp))
    n_q = 0
    for path, t in got.items():
        _same_bits(t, want[path], path)
        if path[-1] in ("wq", "wscale"):
            n_q += 1
        else:
            assert t is orig[path], path
    assert n_q > 0


def test_quantize_skips_non_linear_leaves():
    """tests/test_serving_opts.py's case on the port (jamba): the conv,
    the router and the embedding stay; attention projections go int8."""
    jc, tc = _cfgs("jamba-v0.1-52b")
    p = params_from_numpy(JLM(jc).init(jax.random.PRNGKey(0)))
    pq = tl.quantize_params_for_serving(p)
    assert "w" in pq["layers"]["p0"]["mixer"]["conv_x"]
    assert "w" in pq["layers"]["p1"]["mlp"]["router"]
    assert "w" in pq["embed"]
    attn = pq["layers"]["p3"]["mixer"]
    assert "wq" in attn["wqkv"] and "wscale" in attn["wqkv"]
    assert attn["wqkv"]["wq"].dtype == torch.int8
    assert attn["wqkv"]["wscale"].shape == attn["wqkv"]["wq"].shape[::2]


def test_quantize_linear_rounds_half_to_even_and_keeps_the_bias():
    """2-D weights: scale max|w| / 127 per output channel, q rounded half
    to even (2.5 -> 2, -3.5 -> -4: a cast would truncate), clipped to
    +-127; a zero column keeps its zero scale; the bias is kept."""
    w = np.array([[127.0, 2.5, 0.0], [-3.5, 127.0, 0.0], [1.0, -1.5, 0.0]],
                 np.float32)
    b = np.arange(3, dtype=np.float32)
    got = tl.quantize_linear({"w": torch.from_numpy(w),
                              "b": torch.from_numpy(b)})
    want = jl.quantize_linear({"w": jnp.asarray(w), "b": jnp.asarray(b)})
    for k in ("wq", "wscale", "b"):
        _same_bits(got[k], want[k], k)
    assert got["wq"][:, 0].tolist() == [127, -4, 1]
    assert got["wq"][:, 1].tolist() == [2, 127, -2]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_linear_on_int8_weights_matches_jax(dtype):
    """The `wq` branch: dequantized in x's dtype, the product, the bias."""
    r = np.random.default_rng(2)
    w = r.standard_normal((3, 16, 24)).astype(np.float32)
    x = r.standard_normal((2, 5, 16)).astype(np.float32)
    b = r.standard_normal(24).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    jq = jl.quantize_params_for_serving({"l": {"w": jnp.asarray(w),
                                               "b": jnp.asarray(b)}})["l"]
    tq = tl.quantize_params_for_serving({"l": {"w": torch.from_numpy(w),
                                               "b": torch.from_numpy(b)}})["l"]
    for r_ in range(3):
        jp = {k: v[r_] if k != "b" else v.astype(jdt) for k, v in jq.items()}
        tp = {k: v[r_] if k != "b" else v.to(tdt) for k, v in tq.items()}
        want = jl.linear(jp, jnp.asarray(x).astype(jdt))
        got = tl.linear(tp, torch.from_numpy(x).to(tdt))
        assert got.dtype == tdt
        tol = 1e-5 if dtype == "float32" else 2e-2
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=tol, atol=tol)


@pytest.mark.parametrize("arch,tol", [
    ("chatglm3-6b", 0.15), ("qwen2-moe-a2.7b", 0.3), ("mamba2-1.3b", 0.15),
    ("jamba-v0.1-52b", 0.7)])
def test_int8_serving_weights_close(arch, tol):
    """tests/test_serving_opts.py's case on the port, with its bounds and
    its own inputs (the reference's parameters and tokens): the int8
    model's prefill logits within `tol` (relative to max|logit|) of the
    same bf16 weights' logits, and a decode step under int8 weights gives
    finite logits.  jamba's bf16 tiny model flips MoE routing choices on
    one-ulp router inputs (tests/test_torch_lm.py), so its gap moves with
    the input: 0.46 in the reference and 0.60 in the port on these
    tokens; on tokens drawn from numpy's seed 1 instead, 0.66 and 1.02."""
    jc, tc = _cfgs(arch)
    lm = LM(tc)
    p = params_from_numpy(JLM(jc).init(jax.random.PRNGKey(0)))
    pq = tl.quantize_params_for_serving(p)
    toks = torch.from_numpy(np.array(jax.random.randint(
        jax.random.PRNGKey(1), (2, 32), 0, tc.vocab_size), np.int32))
    lf, _ = lm.prefill(p, {"tokens": toks})
    lq, _ = lm.prefill(pq, {"tokens": toks})
    a = lf[:, :tc.vocab_size].float().numpy()
    b = lq[:, :tc.vocab_size].float().numpy()
    assert np.abs(a - b).max() / np.abs(a).max() < tol
    cache = lm.init_cache(2, 8)
    logits, _, _ = lm.decode_step(pq, cache, {"tokens": toks[:, :1]})
    assert np.isfinite(logits[:, :tc.vocab_size].float().numpy()).all()


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "qwen2-vl-7b",
                                  "qwen2-moe-a2.7b", "mamba2-1.3b"])
def test_int8_logits_match_jax(arch):
    """fp32 models on int8 weights: prefill logits (plain and bucketed)
    and one decode step against the reference's int8 logits, atol 1e-4:
    a dense model, the M-RoPE VLM on embeddings with QKV bias, the MoE's
    shared expert and the SSM's in/out projections."""
    jc, tc = _cfgs(arch, "float32")
    jlm, tlm = JLM(jc), LM(tc)
    jq = jl.quantize_params_for_serving(jlm.init(jax.random.PRNGKey(0)))
    tq = params_from_numpy(jq)
    V = tc.vocab_size
    jb, tb = _batch(tc, 3, 2, 32)
    lens = np.array([32, 7], np.int32)
    jl_, jc_ = jlm.prefill(jq, jb, lengths=jnp.asarray(lens), cache_len=40)
    tl_, tc_ = tlm.prefill(tq, tb, lengths=torch.from_numpy(lens),
                           cache_len=40)
    np.testing.assert_allclose(tl_.numpy(), np.asarray(jl_), rtol=0,
                               atol=LOGIT_ATOL)
    jfull, _ = jlm.prefill(jq, jb)
    tfull, _ = tlm.prefill(tq, tb)
    np.testing.assert_allclose(tfull.numpy(), np.asarray(jfull), rtol=0,
                               atol=LOGIT_ATOL)
    jstep, tstep = _batch(tc, 4, 2, 1)
    jd, jtok, _ = jlm.decode_step(jq, jc_, jstep)
    td, ttok, _ = tlm.decode_step(tq, tc_, tstep)
    np.testing.assert_allclose(td[:, :V].numpy(), np.asarray(jd)[:, :V],
                               rtol=0, atol=LOGIT_ATOL)
    assert ttok.tolist() == np.asarray(jtok).tolist()
