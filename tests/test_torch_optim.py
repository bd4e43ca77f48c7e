"""The port's block-int8 quantizer, AdamW and LR schedule
(`repro_torch.core.quant`, `repro_torch.optim`) vs the JAX package's, and
the port's counterparts of the quant and optimizer tests of
tests/test_substrate.py.

Inputs are made from a seed with numpy and fed to both packages.
Tolerances: `quantize` / `dequantize` bitwise (round half to even, true
divisions); one AdamW `update` from the same params, grads and state:
fp32 params within rtol 1e-6; bf16 params within one bf16 ulp (the
fp32 update before the cast may differ by an fp32 ulp, which can move
the rounding); int8 moments' `q` and `scale` bitwise where the gradient
norm is the same float in both packages (inputs whose squares sum
exactly: the clip factor is then one correctly rounded division in
both), within one `q` step and 1e-5 relative in `scale` on random
gradients (the norm's sum order differs between XLA and torch, and the
clip factor's ulp enters v squared, at each of the two updates); the
count exactly.  `cosine_with_warmup` rtol 1e-6.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.core import quant as jquant  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import schedules as jsched  # noqa: E402
from repro_torch.core import quant  # noqa: E402
from repro_torch.core.treeutil import params_from_numpy  # noqa: E402
from repro_torch.core.treeutil import value_and_grad  # noqa: E402
from repro_torch.optim import adamw, schedules  # noqa: E402

torch.set_num_threads(1)


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t, np.float32)


# ---------------------------------------------------------------------------
# quantization
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(3, 300), (2, 4, 256), (5, 128), (7,),
                                   (4, 1), (2, 130)])
def test_quantize_dequantize_bitwise_with_jax(shape):
    r = np.random.RandomState(sum(shape))
    x = (r.randn(*shape) * r.choice([1e-3, 1.0, 50.0], shape)).astype(
        np.float32)
    got = quant.quantize(torch.from_numpy(x))
    want = jquant.quantize(jnp.asarray(x))
    np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]))
    np.testing.assert_array_equal(got["scale"].numpy(),
                                  np.asarray(want["scale"]))
    np.testing.assert_array_equal(quant.dequantize(got).numpy(),
                                  np.asarray(jquant.dequantize(want)))


def test_quantize_rounds_half_to_even():
    """A block whose max is 127 has scale 1: 0.5 and 2.5 round to even."""
    x = torch.zeros((1, 128))
    x[0, :4] = torch.tensor([127.0, 0.5, 2.5, -1.5])
    q = quant.quantize(x)["q"][0, :4].tolist()
    assert q == [127, 0, 2, -2]


@settings(max_examples=40, deadline=None)
@given(st.integers(0, 10**6), st.integers(1, 300), st.floats(0.1, 100.0))
def test_quant_roundtrip_error_bound(seed, d, scale):
    r = np.random.RandomState(seed)
    x = torch.from_numpy((r.randn(3, d) * scale).astype(np.float32))
    y = quant.dequantize(quant.quantize(x))[..., :d]
    err = (x - y).abs().max().item()
    assert err <= x.abs().max().item() / 127.0 + 1e-6


def test_quant_preserves_zero():
    x = torch.zeros((4, 256))
    assert torch.all(quant.dequantize(quant.quantize(x)) == 0)


# ---------------------------------------------------------------------------
# AdamW: one update against the reference's
# ---------------------------------------------------------------------------
def _tree(seed, dtype, exact=False):
    """A parameter tree (keys out of sorted order on purpose) and a
    gradient tree.  exact: gradients are small multiples of 1/8, whose
    squares and their sum are exact in fp32 in any order."""
    r = np.random.RandomState(seed)

    def grad(*shape):
        if exact:
            return (r.randint(-8, 9, shape) / 8.0).astype(np.float32)
        return r.randn(*shape).astype(np.float32)

    shapes = {"w2": (5, 300), "b": (7,), "a": {"z": (3, 4, 129), "k": (33,)}}

    def build(f, t):
        return {k: build(f, v) if isinstance(v, dict) else f(*v)
                for k, v in t.items()}
    params = build(lambda *s: r.randn(*s).astype(np.float32), shapes)
    grads = build(grad, shapes)
    if dtype == "bfloat16":
        params = jax.tree.map(lambda a: np.asarray(jnp.asarray(
            a, jnp.bfloat16)), params)
    return params, grads


def _one_update(mdt, dtype, clip, exact=False):
    """(port's, reference's) (params, state) after two updates: the first
    from zero moments, the second from the state the first left, both
    from the same inputs."""
    params, grads = _tree(0, dtype, exact)
    grads2 = _tree(1, dtype, exact)[1]
    kw = dict(lr=1e-2, moment_dtype=mdt, weight_decay=0.1,
              grad_clip=clip)
    jc, tc = jadamw.AdamWConfig(**kw), adamw.AdamWConfig(**kw)
    jp, tp = jax.tree.map(jnp.asarray, params), params_from_numpy(params)
    js, ts = jadamw.init(jp, jc), adamw.init(tp, tc)
    for g in (grads, grads2):
        jp, js = jadamw.update(jax.tree.map(jnp.asarray, g), js, jp, jc)
        tp, ts = adamw.update(params_from_numpy(g), ts, tp, tc)
    return (tp, ts), (jp, js)


def _walk(t, j, fn, path=""):
    if isinstance(j, dict):
        assert set(t) == set(j), path
        for k in j:
            _walk(t[k], j[k], fn, f"{path}/{k}")
    else:
        fn(t, j, path)


@pytest.mark.parametrize("mdt", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("clip", [1e-3, 1e6], ids=["clip", "noclip"])
def test_adamw_update_matches_jax_fp32(mdt, clip):
    (tp, ts), (jp, js) = _one_update(mdt, "float32", clip)
    _walk(tp, jp, lambda t, j, p: np.testing.assert_allclose(
        t.numpy(), np.asarray(j), rtol=1e-6, atol=1e-7, err_msg=p))
    assert int(ts["count"]) == int(js["count"]) == 2
    if mdt == "int8":
        def close(t, j, p):
            np.testing.assert_array_less(
                np.abs(t["q"].numpy().astype(int)
                       - np.asarray(j["q"]).astype(int)), 2, err_msg=p)
            np.testing.assert_allclose(t["scale"].numpy(),
                                       np.asarray(j["scale"]), rtol=1e-5,
                                       err_msg=p)
        is_leaf = lambda x: isinstance(x, dict) and set(x) == {"q", "scale"}
        for name in ("m", "v"):
            for t, j in zip(_moment_leaves(ts[name]),
                            jax.tree.leaves(js[name], is_leaf=is_leaf)):
                close(t, j, name)
    else:
        for name in ("m", "v"):
            _walk(ts[name], js[name], lambda t, j, p: (
                _check_dtype(t, mdt), np.testing.assert_allclose(
                    _np(t), _np(np.asarray(j, np.float32)), rtol=1e-6,
                    atol=1e-9, err_msg=p)))


def _check_dtype(t, mdt):
    assert str(t.dtype) == f"torch.{mdt}"


def _moment_leaves(tree):
    if isinstance(tree, dict) and set(tree) == {"q", "scale"}:
        return [tree]
    return [x for k in sorted(tree) for x in _moment_leaves(tree[k])]


@pytest.mark.parametrize("clip", [1e-3, 1e6], ids=["clip", "noclip"])
def test_adamw_int8_moments_bitwise_on_an_exact_norm(clip):
    (tp, ts), (jp, js) = _one_update("int8", "float32", clip, exact=True)
    is_leaf = lambda x: isinstance(x, dict) and set(x) == {"q", "scale"}
    for name in ("m", "v"):
        for t, j in zip(_moment_leaves(ts[name]),
                        jax.tree.leaves(js[name], is_leaf=is_leaf)):
            np.testing.assert_array_equal(t["q"].numpy(), np.asarray(j["q"]))
            np.testing.assert_array_equal(t["scale"].numpy(),
                                          np.asarray(j["scale"]))


@pytest.mark.parametrize("mdt", ["float32", "int8"])
@pytest.mark.parametrize("clip", [1e-3, 1e6], ids=["clip", "noclip"])
def test_adamw_update_bf16_params_within_one_ulp(mdt, clip):
    """bf16 parameters are updated in fp32 and cast back: within one
    bf16 ulp of the reference's (most are bitwise equal)."""
    (tp, ts), (jp, js) = _one_update(mdt, "bfloat16", clip)
    n_diff = [0, 0]

    def check(t, j, p):
        assert t.dtype == torch.bfloat16, p
        a = t.view(torch.int16).numpy().astype(np.int64)
        b = np.asarray(j).view(np.int16).astype(np.int64)
        assert np.abs(a - b).max() <= 1, p
        n_diff[0] += int((a != b).sum())
        n_diff[1] += a.size
    _walk(tp, jp, check)
    assert n_diff[0] <= 0.01 * n_diff[1], n_diff


def test_adamw_walks_leaves_in_sorted_key_order():
    """The clip factor sums the leaves' squares in `jax.tree.leaves`'
    order (sorted keys), whatever order the dict was built in."""
    from repro_torch.core.treeutil import leaves_with_paths
    tree = {"w2": 1, "b": 2, "a": {"z": 3, "k": 4}}
    assert [p for p, _ in leaves_with_paths(tree)] == [
        ("a", "k"), ("a", "z"), ("b",), ("w2",)]
    assert [v for _, v in leaves_with_paths(tree)] == jax.tree.leaves(tree)


def test_adamw_update_is_functional():
    params, grads = _tree(0, "float32")
    tp, g = params_from_numpy(params), params_from_numpy(grads)
    cfg = adamw.AdamWConfig(moment_dtype="int8")
    st_ = adamw.init(tp, cfg)
    before = jax.tree.map(lambda t: t.clone(), (tp, g, st_))
    adamw.update(g, st_, tp, cfg)
    for a, b in zip(jax.tree.leaves(before), jax.tree.leaves((tp, g, st_))):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the substrate tests' optimizer cases, on the port
# ---------------------------------------------------------------------------
def _toy_problem():
    r = np.random.RandomState(0)
    w_true = torch.from_numpy(r.randn(16, 4).astype(np.float32))
    X = torch.from_numpy(r.randn(64, 16).astype(np.float32))
    y = X @ w_true

    def loss(p):
        return torch.mean((X @ p["w"] - y) ** 2)
    return loss, {"w": torch.zeros((16, 4))}


def _train(mdt, steps, lr=0.05):
    loss, params = _toy_problem()
    cfg = adamw.AdamWConfig(lr=lr, weight_decay=0.0, moment_dtype=mdt)
    opt = adamw.init(params, cfg)
    for _ in range(steps):
        _, g = value_and_grad(loss, params)
        params, opt = adamw.update(g, opt, params, cfg)
    return float(loss(params)), float(loss(_toy_problem()[1]))


@pytest.mark.parametrize("mdt", ["float32", "int8", "bfloat16"])
def test_adamw_converges(mdt):
    l1, l0 = _train(mdt, 60)
    assert l1 < 0.05 * l0, (l0, l1)


def test_adamw_grad_clip():
    loss, params = _toy_problem()
    cfg = adamw.AdamWConfig(lr=1.0, grad_clip=1e-9, weight_decay=0.0)
    _, g = value_and_grad(loss, params)
    new_p, _ = adamw.update(g, adamw.init(params, cfg), params, cfg)
    assert torch.isfinite(new_p["w"]).all()


def test_int8_moments_track_fp32():
    finals = {m: _train(m, 80)[0] for m in ("float32", "int8")}
    l0 = _train("float32", 0)[1]
    assert finals["int8"] < 0.05 * l0
    assert finals["int8"] < 10 * finals["float32"] + 1e-4


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kw", [dict(), dict(base_lr=3e-4, warmup=10,
                                             total=100, min_frac=0.0),
                                dict(warmup=0, total=50)])
def test_cosine_with_warmup_matches_jax(kw):
    steps = [0, 1, 5, 10, 99, 150, 200, 5000, 10000, 20000]
    got = [float(schedules.cosine_with_warmup(s, **kw)) for s in steps]
    want = [float(jsched.cosine_with_warmup(s, **kw)) for s in steps]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)
    t = schedules.cosine_with_warmup(torch.tensor(7, dtype=torch.int32),
                                     **kw)
    assert t.dtype == torch.float32
    assert float(t) == pytest.approx(
        float(jsched.cosine_with_warmup(jnp.int32(7), **kw)), rel=1e-6)
