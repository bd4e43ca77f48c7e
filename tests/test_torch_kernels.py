"""Port kernels' plain PyTorch versions vs the JAX package's kernels.

Inputs are made with numpy from a seed and fed to both packages.  The
JAX side runs `repro.kernels.ops` under KernelPolicy("ref") (the
pure-jnp oracle) and KernelPolicy("interpret") (the Pallas kernel in
interpret mode); the port side runs `repro_torch.kernels.ops` on CPU
tensors, which dispatch to the plain versions.  Shape sweeps mirror
tests/test_kernels.py and tests/test_hypothesis_unit.py.

Tolerances (two frameworks, two BLAS libraries, sums in other orders):
  * logmel: rtol 1e-4, atol 1e-3 — log domain after a 257-term mel sum
    and an 80-term DCT;
  * layernorm, tds_conv: atol 1e-5 (rtol 1e-5) — fp32 sums of at most a
    few hundred terms of O(1) values;
  * hypothesis unit: idx/valid exact, pb/pnb rtol 1e-5 — exp/log differ
    by an ulp across frameworks.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.policy import KernelPolicy as JaxPolicy  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import (hypothesis_unit as thu,  # noqa: E402
                                 layernorm as tln, logmel as tlm,
                                 tds_conv as ttc)
from repro_torch.kernels.policy import KernelPolicy  # noqa: E402

torch.set_num_threads(1)

JAX_MODES = ("ref", "interpret")
NEG_INF = -1e30


def _np(seed, *shape, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale
            ).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# logmel
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", JAX_MODES)
@pytest.mark.parametrize("t,c", [(8, 40), (50, 80), (128, 80), (300, 40)])
def test_logmel_matches_jax(t, c, mode):
    p = np.abs(_np(t, t, 257)) + 1e-3
    fb = np.abs(_np(1, 257, 80))
    dct = _np(2, 80, c)
    want = jops.logmel(jnp.asarray(p), jnp.asarray(fb), jnp.asarray(dct),
                       policy=JaxPolicy(mode))
    got = tops.logmel(_t(p), _t(fb), _t(dct))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-3)


# ---------------------------------------------------------------------------
# layernorm
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", JAX_MODES)
@pytest.mark.parametrize("t,d", [(32, 64), (256, 80), (100, 257), (37, 80),
                                 (300, 129), (8, 1200)])
def test_layernorm_matches_jax(t, d, mode):
    x, s, b = _np(d, t, d), _np(1, d), _np(2, d)
    want = jops.layernorm(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b),
                          policy=JaxPolicy(mode))
    got = tops.layernorm(_t(x), _t(s), _t(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# tds conv (fused epilogue)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", JAX_MODES)
@pytest.mark.parametrize("k,stride,t,w,cin,cout", [
    (9, 1, 32, 16, 5, 7), (9, 2, 32, 16, 5, 7), (10, 2, 64, 80, 15, 19),
    (21, 1, 64, 8, 3, 3), (9, 1, 48, 16, 5, 7), (9, 1, 40, 8, 3, 3),
    (5, 2, 72, 8, 3, 3),
])
def test_tds_conv_matches_jax(k, stride, t, w, cin, cout, mode):
    """3-D input (the ops wrapper's B=1 squeeze)."""
    x = _np(k, k - 1 + t, w, cin)
    wgt = _np(1, k, cin, cout, scale=0.3)
    b = _np(2, cout)
    want = jops.tds_conv(jnp.asarray(x), jnp.asarray(wgt), jnp.asarray(b),
                         stride=stride, policy=JaxPolicy(mode))
    got = tops.tds_conv(_t(x), _t(wgt), _t(b), stride=stride)
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", JAX_MODES)
@pytest.mark.parametrize("batch,stride,relu,residual", [
    (1, 1, True, False), (3, 1, True, True), (2, 1, False, True),
    (4, 2, False, False), (2, 2, True, False),
])
def test_tds_conv_batched_epilogue_matches_jax(batch, stride, relu, residual,
                                               mode):
    k, t, w, cin = 9, 24, 8, 6
    cout = cin if residual else 7
    x = _np(batch, batch, k - 1 + t, w, cin)
    wgt = _np(1, k, cin, cout, scale=0.3)
    b = _np(2, cout)
    res = _np(3, batch, t // stride, w, cout) if residual else None
    want = jops.tds_conv(jnp.asarray(x), jnp.asarray(wgt), jnp.asarray(b),
                         stride=stride, relu=relu,
                         res=None if res is None else jnp.asarray(res),
                         policy=JaxPolicy(mode))
    got = tops.tds_conv(_t(x), _t(wgt), _t(b), stride=stride, relu=relu,
                        res=None if res is None else _t(res))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# hypothesis unit
# ---------------------------------------------------------------------------
def _candidates(seed, b, n, dup_rate=0.5, dead_rate=0.2):
    """Candidate rows with forced duplicate hashes and dead entries (the
    generator of tests/test_hypothesis_unit.py)."""
    r = np.random.RandomState(seed)
    n_hash = max(1, int(n * (1.0 - dup_rate)))
    hashes = r.randint(0, n_hash, (b, n)).astype(np.int32)
    pb = (r.randn(b, n) * 3).astype(np.float32)
    pnb = (r.randn(b, n) * 3).astype(np.float32)
    dead = r.rand(b, n) < dead_rate
    pb = np.where(dead, NEG_INF, pb).astype(np.float32)
    pnb = np.where(dead, NEG_INF, pnb).astype(np.float32)
    return hashes, pb, pnb


def _assert_hu_equal(got, want):
    for key in ("idx", "valid"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]),
                                      err_msg=key)
    for key in ("pb", "pnb"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=1e-5, atol=0, err_msg=key)


@pytest.mark.parametrize("mode", JAX_MODES)
@pytest.mark.parametrize("seed,b,n,k,beam", [
    (0, 1, 12, 4, 5.0), (1, 3, 64, 16, 10.0), (2, 4, 200, 16, 3.0),
    (3, 2, 130, 32, 1e9), (4, 2, 1040, 128, 25.0),
])
def test_hypothesis_unit_matches_jax(seed, b, n, k, beam, mode):
    h, pb, pnb = _candidates(seed, b, n)
    want = jops.hypothesis_unit(jnp.asarray(h), jnp.asarray(pb),
                                jnp.asarray(pnb), k, beam,
                                policy=JaxPolicy(mode))
    got = tops.hypothesis_unit(_t(h), _t(pb), _t(pnb), k, beam)
    _assert_hu_equal(got, want)
    assert got["idx"].dtype == torch.int32 and got["valid"].dtype == torch.bool


def test_hypothesis_unit_duplicate_heavy_matches_jax():
    """Main-path-like row: hashes drawn from 0..4095 over N = 8320."""
    r = np.random.RandomState(7)
    h = r.randint(0, 4096, (2, 8320)).astype(np.int32)
    pb = (r.randn(2, 8320) * 3).astype(np.float32)
    pnb = (r.randn(2, 8320) * 3).astype(np.float32)
    want = jops.hypothesis_unit(jnp.asarray(h), jnp.asarray(pb),
                                jnp.asarray(pnb), 128, 25.0,
                                policy=JaxPolicy("ref"))
    _assert_hu_equal(tops.hypothesis_unit(_t(h), _t(pb), _t(pnb), 128, 25.0),
                     want)


def test_hypothesis_unit_all_pruned_and_sentinel_hash():
    """An all-dead row selects nothing; a live hash equal to 2**31 - 1
    never merges with dead candidates."""
    dead = np.full((1, 10), NEG_INF, np.float32)
    out = tops.hypothesis_unit(torch.zeros((1, 10), dtype=torch.int32),
                               _t(dead), _t(dead), 4, 2.0)
    assert not out["valid"].any()
    assert (out["pb"] == NEG_INF).all() and (out["idx"] == 0).all()

    h = np.full((1, 6), 2**31 - 1, np.int32)
    pb = np.array([[-1.0] + [NEG_INF] * 5], np.float32)
    pnb = np.full((1, 6), NEG_INF, np.float32)
    got = tops.hypothesis_unit(_t(h), _t(pb), _t(pnb), 3, 1e9)
    want = jops.hypothesis_unit(jnp.asarray(h), jnp.asarray(pb),
                                jnp.asarray(pnb), 3, 1e9,
                                policy=JaxPolicy("ref"))
    _assert_hu_equal(got, want)
    assert got["valid"][0].tolist() == [True, False, False]


def test_hypothesis_unit_duplicate_hash_merges_mass():
    pb, pnb = _np(0, 1, 8), _np(1, 1, 8)
    h = np.full((1, 8), 77, np.int32)
    out = tops.hypothesis_unit(_t(h), _t(pb), _t(pnb), 4, 1e9)
    assert out["valid"][0].tolist() == [True, False, False, False]
    assert abs(float(out["pb"][0, 0]) - float(np.logaddexp.reduce(pb[0]))) \
        < 1e-4
    assert abs(float(out["pnb"][0, 0]) - float(np.logaddexp.reduce(pnb[0]))) \
        < 1e-4


# ---------------------------------------------------------------------------
# wrappers and dispatch on the CPU
# ---------------------------------------------------------------------------
def test_wrappers_run_the_plain_version_on_cpu_tensors():
    """A wrapper given CPU tensors computes its plain version and
    launches nothing."""
    tops.reset_launch_counts()
    x, s, b = _t(_np(0, 5, 16)), _t(_np(1, 16)), _t(_np(2, 16))
    torch.testing.assert_close(tln.layernorm(x, s, b),
                               tops.layernorm(x, s, b), rtol=0, atol=0)
    p, fb, dct = _t(np.abs(_np(3, 4, 257))), _t(np.abs(_np(4, 257, 80))), \
        _t(_np(5, 80, 80))
    torch.testing.assert_close(tlm.logmel(p, fb, dct),
                               tops.logmel(p, fb, dct), rtol=0, atol=0)
    xc, wc, bc = _t(_np(6, 2, 16, 4, 3)), _t(_np(7, 9, 3, 3)), _t(_np(8, 3))
    torch.testing.assert_close(ttc.tds_conv(xc, wc, bc, relu=True),
                               tops.tds_conv(xc, wc, bc, relu=True),
                               rtol=0, atol=0)
    h, pb, pnb = (_t(a) for a in _candidates(9, 2, 40))
    a = thu.hypothesis_unit(h, pb, pnb, k=8, beam=5.0)
    bb = tops.hypothesis_unit(h, pb, pnb, 8, 5.0)
    for key in a:
        assert torch.equal(a[key], bb[key]), key
    assert tops.launch_counts() == {"logmel": 0, "tds_conv": 0,
                                    "layernorm": 0, "hypothesis_unit": 0}


def test_kernel_policy_resolution():
    cpu = torch.zeros(1)
    assert KernelPolicy("ref").resolve(cpu) == "ref"
    assert KernelPolicy().resolve(cpu) == "ref"
    with pytest.raises(ValueError):
        KernelPolicy("kernel").resolve(cpu)
    with pytest.raises(ValueError):
        KernelPolicy("interpret")
    with pytest.raises(ValueError):
        tops.layernorm(cpu.reshape(1, 1), cpu, cpu,
                       policy=KernelPolicy("kernel"))
