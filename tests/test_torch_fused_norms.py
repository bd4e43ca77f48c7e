"""The port's fused LayerNorms vs the JAX package's unfused composition.

`ops.tds_conv_ln` (the TDS conv with the LayerNorm that follows it) is
held against `repro.kernels.ops.tds_conv` then `repro.kernels.ops.layernorm`
over each (b, t) row of W*Cout values; `ops.bias_residual_layernorm`
against `(y + add_bias) + res` then `repro.kernels.ops.layernorm`.  Inputs
are made with numpy from a seed; the JAX side runs under its "ref" and
"interpret" policies, the port side on CPU tensors (the plain versions).

Tolerance: rtol 1e-5, atol 1e-5, as for the unfused conv and LayerNorm in
tests/test_torch_kernels.py: fp32 sums of at most a few hundred terms of
O(1) values in another order, divided by a row's standard deviation of
O(1).

Also: the TDS forward dispatches 17 of its 18 convs through the fused
conv and 15 LayerNorms through the fused LayerNorm, and
KernelPolicy("kernel") on CPU tensors raises for both functions.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.policy import KernelPolicy as JaxPolicy  # noqa: E402
from repro_torch.configs import tds_asr as tcfg  # noqa: E402
from repro_torch.kernels import layernorm as tln  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import tds_conv as ttc  # noqa: E402
from repro_torch.kernels.policy import KernelPolicy  # noqa: E402
from repro_torch.models import tds as ttds  # noqa: E402

torch.set_num_threads(1)

JAX_MODES = ("ref", "interpret")
TOL = dict(rtol=1e-5, atol=1e-5)


def _np(seed, *shape, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale
            ).astype(np.float32)


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


# ---------------------------------------------------------------------------
# conv + LayerNorm
# ---------------------------------------------------------------------------
# (batch, k, stride, T, W, Cin, Cout, residual): the TDS channel counts
# 15/19/23 and a small one, stride 1 and 2, T = stride (one output frame,
# the b=1, w=1 stage-2 step), and ragged rows (W*Cout not a multiple of 4)
CONV_CASES = [
    (2, 9, 1, 8, 16, 15, 15, True), (2, 9, 1, 8, 16, 15, 15, False),
    (3, 10, 2, 8, 16, 15, 19, False), (1, 10, 2, 2, 80, 19, 23, False),
    (2, 9, 1, 1, 80, 23, 23, True), (1, 9, 1, 1, 16, 7, 7, True),
    (2, 9, 1, 4, 13, 7, 7, True), (1, 9, 2, 2, 13, 5, 7, False),
    (2, 10, 2, 4, 11, 19, 19, False),
]


def _conv_inputs(batch, k, stride, t, w, cin, cout, residual):
    x = _np(k + cin, batch, k - 1 + t, w, cin)
    wgt = _np(1, k, cin, cout, scale=0.3)
    b = _np(2, cout)
    res = _np(3, batch, t // stride, w, cout) if residual else None
    scale, shift = 1 + _np(4, w * cout, scale=0.2), _np(5, w * cout)
    return x, wgt, b, res, scale, shift


def _jax_conv_ln(x, wgt, b, res, scale, shift, stride, relu, mode):
    pol = JaxPolicy(mode)
    y = jops.tds_conv(_j(x), _j(wgt), _j(b), stride=stride, relu=relu,
                      res=_j(res), policy=pol)
    rows = y.shape[0] * y.shape[1]
    out = jops.layernorm(y.reshape(rows, -1), _j(scale), _j(shift),
                         policy=pol)
    return np.asarray(out).reshape(y.shape)


@pytest.mark.parametrize("mode", JAX_MODES)
@pytest.mark.parametrize("batch,k,stride,t,w,cin,cout,residual", CONV_CASES)
def test_tds_conv_ln_matches_jax(batch, k, stride, t, w, cin, cout, residual,
                                 mode):
    x, wgt, b, res, scale, shift = _conv_inputs(batch, k, stride, t, w, cin,
                                                cout, residual)
    want = _jax_conv_ln(x, wgt, b, res, scale, shift, stride, True, mode)
    got = tops.tds_conv_ln(_t(x), _t(wgt), _t(b), _t(scale), _t(shift),
                           stride=stride, relu=True, res=_t(res))
    assert tuple(got.shape) == want.shape == (batch, t // stride, w, cout)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("relu", [False, True])
def test_tds_conv_ln_unbatched_and_no_relu_match_jax(relu):
    """3-D input (the ops wrapper's B=1 squeeze), with and without the
    ReLU."""
    x, wgt, b, res, scale, shift = _conv_inputs(1, 9, 1, 4, 16, 6, 6, True)
    want = _jax_conv_ln(x, wgt, b, res, scale, shift, 1, relu, "ref")
    got = tops.tds_conv_ln(_t(x[0]), _t(wgt), _t(b), _t(scale), _t(shift),
                           relu=relu, res=_t(res[0]))
    assert tuple(got.shape) == want.shape[1:]
    np.testing.assert_allclose(got.numpy(), want[0], **TOL)


# ---------------------------------------------------------------------------
# bias + residual + LayerNorm
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", JAX_MODES)
@pytest.mark.parametrize("with_bias,with_res", [(True, True), (True, False),
                                                (False, True),
                                                (False, False)])
@pytest.mark.parametrize("r,d", [(64, 1200), (16, 1840), (37, 80),
                                 (5, 129)])
def test_bias_residual_layernorm_matches_jax(r, d, with_bias, with_res,
                                             mode):
    y, scale, shift = _np(d, r, d), 1 + _np(1, d, scale=0.2), _np(2, d)
    ab = _np(3, d) if with_bias else None
    res = _np(4, r, d) if with_res else None
    x = jnp.asarray(y)
    if with_bias:
        x = x + jnp.asarray(ab)
    if with_res:
        x = x + jnp.asarray(res)
    want = jops.layernorm(x, _j(scale), _j(shift), policy=JaxPolicy(mode))
    got = tops.bias_residual_layernorm(_t(y), _t(scale), _t(shift),
                                       add_bias=_t(ab), res=_t(res))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_bias_residual_layernorm_input_is_the_plain_sum():
    """The LayerNorm's input is (y + add_bias) + res in fp32, bit for bit,
    so the fused function equals the unfused plain sequence exactly."""
    y, ab, res = _t(_np(0, 16, 1840)), _t(_np(1, 1840)), _t(_np(2, 16, 1840))
    scale, shift = _t(1 + _np(3, 1840, scale=0.2)), _t(_np(4, 1840))
    got = tops.bias_residual_layernorm(y, scale, shift, add_bias=ab, res=res)
    assert torch.equal(got, tref.layernorm((y + ab) + res, scale, shift))


# ---------------------------------------------------------------------------
# dispatch: CPU tensors, the kernel policy, the TDS forward
# ---------------------------------------------------------------------------
def test_fused_wrappers_run_the_plain_versions_on_cpu_tensors():
    tops.reset_launch_counts()
    x, wgt, b, res, scale, shift = (_t(a) for a in _conv_inputs(
        2, 9, 1, 4, 8, 5, 5, True))
    torch.testing.assert_close(
        ttc.tds_conv_ln(x, wgt, b, scale, shift, res, relu=True),
        tref.tds_conv_ln(x, wgt, b, scale, shift, relu=True, res=res),
        rtol=0, atol=0)
    y = _t(_np(6, 4, 40))
    s40, ab = _t(_np(7, 40)), _t(_np(8, 40))
    torch.testing.assert_close(
        tln.bias_residual_layernorm(y, s40, s40, add_bias=ab, res=y),
        tref.bias_residual_layernorm(y, s40, s40, add_bias=ab, res=y),
        rtol=0, atol=0)
    assert tops.launch_counts()["tds_conv"] == 0
    assert tops.launch_counts()["layernorm"] == 0


def test_fused_functions_refuse_the_kernel_policy_on_cpu():
    x, wgt, b, res, scale, shift = (_t(a) for a in _conv_inputs(
        1, 9, 1, 4, 8, 5, 5, True))
    with pytest.raises(ValueError, match="CUDA"):
        tops.tds_conv_ln(x, wgt, b, scale, shift, res=res,
                         policy=KernelPolicy("kernel"))
    with pytest.raises(ValueError, match="CUDA"):
        tops.bias_residual_layernorm(_t(_np(0, 4, 40)), _t(_np(1, 40)),
                                     _t(_np(2, 40)), add_bias=_t(_np(3, 40)),
                                     policy=KernelPolicy("kernel"))


def _count_dispatch(monkeypatch, cfg, batch, t):
    """Run `forward_batched` on the CPU and count the conv and LayerNorm
    functions it calls."""
    calls = {}
    for name in ("tds_conv", "tds_conv_ln", "layernorm",
                 "bias_residual_layernorm"):
        fn = getattr(tops, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **kw)
        monkeypatch.setattr(tops, name, counted)
    params = ttds.init_tds(torch.Generator().manual_seed(0), cfg)
    feats = torch.from_numpy(_np(9, batch, t, cfg.n_mfcc))
    lp, _ = ttds.forward_batched(
        params, cfg, feats, ttds.init_batched_stream_state(cfg, batch))
    assert torch.isfinite(lp).all()
    return calls


def test_tds_forward_fuses_17_convs_and_launches_15_layernorms(monkeypatch):
    """The paper's layer schedule (TDS_CONFIG's stages and kernels, with
    narrow channels and vocabulary so it runs here): the census stays
    18 / 29 / 32, while the forward calls the fused conv 17 times, the
    plain conv once (front_conv) and the LayerNorm 15 times (14 ln2 with
    fc2's bias and residual, and final_ln)."""
    cfg = dataclasses.replace(
        tcfg.TDS_CONFIG, vocab_size=11,
        stages=tuple(dataclasses.replace(s, channels=2 + i)
                     for i, s in enumerate(tcfg.TDS_CONFIG.stages)))
    assert ttds.kernel_census(cfg) == {"conv": 18, "fc": 29, "layernorm": 32}
    calls = _count_dispatch(monkeypatch, cfg, 2, 8)
    assert calls == {"tds_conv": 1, "tds_conv_ln": 17,
                     "bias_residual_layernorm": 15}
