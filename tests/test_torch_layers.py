"""The port's LM layers (`repro_torch.models.layers`) vs the JAX package's
(`repro.models.layers`), on the same numpy inputs.

Tolerances: fp32 atol/rtol 1e-5 (two frameworks, sums in other orders;
RoPE angles stay below 100 rad here, where one ulp of the angle is far
below 1e-5); bf16 2e-2 (one bf16 ulp of the output, as
tests/test_models.py holds bf16 paths).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.models import layers as jl  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402

torch.set_num_threads(1)

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _np(seed, *shape, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale
            ).astype(np.float32)


def _pair(a, dtype="float32"):
    jdt, tdt, _ = DTYPES[dtype]
    return jnp.asarray(a).astype(jdt), torch.from_numpy(a).to(tdt)


def _close(got_t, want_j, tol):
    np.testing.assert_allclose(got_t.float().numpy(),
                               np.asarray(want_j, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_apply_norm_matches_jax(kind, dtype):
    xj, xt = _pair(_np(0, 2, 7, 64), dtype)
    p = {"scale": 1 + 0.1 * _np(1, 64)}
    if kind == "layernorm":
        p["bias"] = 0.1 * _np(2, 64)
    want = jl.apply_norm({k: jnp.asarray(v) for k, v in p.items()}, xj, kind)
    got = tl.apply_norm({k: torch.from_numpy(v) for k, v in p.items()}, xt,
                        kind)
    assert got.dtype == xt.dtype and got.shape == xt.shape
    _close(got, want, DTYPES[dtype][2])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode,theta", [("rope", 10000.0),
                                        ("rope2d", 10000.0),
                                        ("rope", 1e6), ("none", 10000.0)])
def test_apply_rope_matches_jax(mode, theta, dtype):
    xj, xt = _pair(_np(3, 2, 9, 4, 16), dtype)
    pos = (np.arange(9)[None, :] + np.array([[0], [50]])).astype(np.int32)
    want = jl.apply_rope(xj, jnp.asarray(pos), mode, theta)
    got = tl.apply_rope(xt, torch.from_numpy(pos), mode, theta)
    assert got.dtype == xt.dtype
    _close(got, want, DTYPES[dtype][2])


@pytest.mark.parametrize("causal,window", [(True, None), (True, 5),
                                           (False, 3)])
def test_mask_matches_jax(causal, window):
    qpos = np.array([[3, 4, 5], [0, 1, 2]], np.int32)
    kpos = np.array([[-1, 0, 1, 2, 3, 4, 5, 6], [0, 1, 2, -1, -1, 5, 6, 7]],
                    np.int32)
    want = jl._mask(jnp.asarray(qpos), jnp.asarray(kpos), causal, window)
    got = tl._mask(torch.from_numpy(qpos), torch.from_numpy(kpos), causal,
                   window)
    assert got.numpy().tolist() == np.asarray(want).tolist()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,h,k,d,window", [(64, 8, 4, 16, None),
                                            (64, 4, 2, 16, 24),
                                            (96, 4, 1, 32, 64)])
def test_attention_chunked_matches_jax(s, h, k, d, window, dtype):
    """Prefill attention (positions arange(S) on every row): the port's
    flash-attention route vs the reference's chunked online softmax."""
    B = 2
    qj, qt = _pair(_np(4, B, s, h, d), dtype)
    kj, kt = _pair(_np(5, B, s, k, d), dtype)
    vj, vt = _pair(_np(6, B, s, k, d), dtype)
    pos = jnp.broadcast_to(jnp.arange(s, dtype=jnp.int32)[None], (B, s))
    want = jl.attention_chunked(qj, kj, vj, pos, pos, causal=True,
                                window=window, chunk_q=16, chunk_kv=32)
    got = tl.attention_chunked(qt, kt, vt, causal=True, window=window)
    assert got.shape == (B, s, h, d) and got.dtype == qt.dtype
    _close(got, want, DTYPES[dtype][2])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("per_slot,new,window", [
    (True, True, None), (True, True, 6), (False, True, None),
    (False, False, 6), (True, False, None)])
def test_attention_decode_matches_jax(per_slot, new, window, dtype):
    """One query per row against a ring cache: per-slot kpos (B, Sc)
    with empty (-1) slots and rows at unequal positions, or a shared
    (Sc,) kpos; with the new token as a separate softmax column
    (k_new/v_new) or not."""
    B, Sc, H, K, D = 3, 12, 4, 2, 16
    qj, qt = _pair(_np(7, B, 1, H, D), dtype)
    kcj, kct = _pair(_np(8, B, Sc, K, D), dtype)
    vcj, vct = _pair(_np(9, B, Sc, K, D), dtype)
    if per_slot:
        kpos = np.full((B, Sc), -1, np.int32)
        kpos[0, :5] = np.arange(5)
        kpos[1] = np.arange(12, 24)
        kpos[2, :9] = np.arange(9)
        qpos = np.array([5, 24, 9], np.int32)
    else:
        kpos = np.concatenate([np.arange(8), -np.ones(4)]).astype(np.int32)
        qpos = np.array([8, 8, 8], np.int32)
    kw = {}
    tkw = {}
    if new:
        knj, knt = _pair(_np(10, B, 1, K, D), dtype)
        vnj, vnt = _pair(_np(11, B, 1, K, D), dtype)
        kw, tkw = dict(k_new=knj, v_new=vnj), dict(k_new=knt, v_new=vnt)
    want = jl.attention_decode(qj, kcj, vcj, jnp.asarray(qpos),
                               jnp.asarray(kpos), window=window, **kw)
    got = tl.attention_decode(qt, kct, vct, torch.from_numpy(qpos),
                              torch.from_numpy(kpos), window=window, **tkw)
    assert got.shape == (B, 1, H, D) and got.dtype == qt.dtype
    _close(got, want, DTYPES[dtype][2])


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_linear_and_mlp_match_jax(act):
    x = _np(12, 2, 5, 32)
    p = {"w_gate": {"w": _np(13, 32, 48, scale=0.2)},
         "w_up": {"w": _np(14, 32, 48, scale=0.2)},
         "w_down": {"w": _np(15, 48, 32, scale=0.2),
                    "b": _np(16, 32, scale=0.1)}}
    jp = {k: {n: jnp.asarray(a) for n, a in v.items()} for k, v in p.items()}
    tp = {k: {n: torch.from_numpy(a) for n, a in v.items()}
          for k, v in p.items()}
    want = jl.apply_mlp(jp, jnp.asarray(x), act)
    got = tl.apply_mlp(tp, torch.from_numpy(x), act)
    _close(got, want, 1e-5)
    _close(tl.linear(tp["w_down"], torch.from_numpy(x[..., :1].repeat(48, -1))),
           jl.linear(jp["w_down"], jnp.asarray(x[..., :1].repeat(48, -1))),
           1e-5)
    # int8 serving weights: dequantized at use, as the reference does
    jq = jl.quantize_linear(jp["w_down"])
    tq = tl.quantize_linear(tp["w_down"])
    _close(tl.linear(tq, torch.from_numpy(x[..., :1].repeat(48, -1))),
           jl.linear(jq, jnp.asarray(x[..., :1].repeat(48, -1))), 1e-5)


def test_init_shapes_and_std():
    g = torch.Generator().manual_seed(0)
    p = tl.init_linear(g, 256, 512, bias=True, dtype=torch.float32)
    assert p["w"].shape == (256, 512) and p["b"].shape == (512,)
    assert abs(float(p["w"].std()) - 1 / 16) < 2e-3
    m = tl.init_mlp(g, 16, 24)
    assert m["w_down"]["w"].shape == (24, 16)
    assert m["w_up"]["w"].dtype == torch.bfloat16
    n = tl.init_norm(16, "layernorm")
    assert n["scale"].dtype == torch.float32 and "bias" in n
