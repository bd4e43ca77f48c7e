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
    by an ulp across frameworks;
  * int8 path: bitwise — the integer product is exact in both packages,
    and quantization and rescale are the same IEEE fp32 operations in
    the same order;
  * beam_prune: bitwise — a max, one fp32 subtraction and comparisons,
    NaN and +-inf included;
  * merge_select_sorted: pos/valid exact, pb/pnb rtol 1e-5, as for the
    hypothesis unit;
  * unfused tds_conv: atol 1e-5 (rtol 1e-5), as for the fused conv.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.policy import KernelPolicy as JaxPolicy  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import beam_prune as tbp  # noqa: E402
from repro_torch.kernels import (hypothesis_unit as thu,  # noqa: E402
                                 int8_matmul as tim, layernorm as tln,
                                 logmel as tlm, ref as tref, tds_conv as ttc)
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
# int8 matmul and its quantization helpers
# ---------------------------------------------------------------------------
INT8_SHAPES = [(8, 128, 128), (32, 256, 64), (100, 200, 96), (1, 1200, 600),
               (128, 128, 128)]       # the sweep of tests/test_kernels.py


def _int8_operands(seed, m, k, n):
    r = np.random.RandomState(seed)
    xq = r.randint(-127, 128, (m, k)).astype(np.int8)
    wq = r.randint(-127, 128, (k, n)).astype(np.int8)
    xs = (r.rand(m) * 0.05 + 1e-3).astype(np.float32)
    ws = (r.rand(n) * 0.05 + 1e-3).astype(np.float32)
    return xq, wq, xs, ws


@pytest.mark.parametrize("mode", JAX_MODES)
@pytest.mark.parametrize("m,k,n", INT8_SHAPES)
def test_int8_matmul_ref_matches_jax(m, k, n, mode):
    """The plain version against the JAX oracle and the Pallas kernel in
    interpret mode (through the JAX package's own padding dispatch)."""
    xq, wq, xs, ws = _int8_operands(m + k + n, m, k, n)
    want = jops._int8_dispatch(jnp.asarray(xq), jnp.asarray(wq),
                               jnp.asarray(xs), jnp.asarray(ws), mode,
                               bm=128, bn=128, bk=128)
    got = tref.int8_matmul(_t(xq), _t(wq), _t(xs), _t(ws))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_int8_matmul_exact_beyond_fp32_integers():
    """|acc| up to 127^2 * 1840 > 2^24: the accumulator stays exact (an
    fp32 product would round it)."""
    k = 1840
    xq = np.full((3, k), 127, np.int8)
    xq[1, ::2] = -127
    xq[2, 0] = 1
    wq = np.full((k, 5), 127, np.int8)
    wq[3, 1] = -1
    xs = np.array([1.0, 0.5, 2.0], np.float32)
    ws = np.array([1.0, 1.0, 0.25, 3.0, 1.0], np.float32)
    acc = xq.astype(np.int64) @ wq.astype(np.int64)
    assert np.abs(acc).max() > 2 ** 24
    got = tref.int8_matmul(_t(xq), _t(wq), _t(xs), _t(ws)).numpy()
    np.testing.assert_array_equal(
        got, acc.astype(np.float32) * xs[:, None] * ws[None, :])
    np.testing.assert_array_equal(got, np.asarray(jref.int8_matmul(
        jnp.asarray(xq), jnp.asarray(wq), jnp.asarray(xs), jnp.asarray(ws))))


@pytest.mark.parametrize("m,k", [(64, 1200), (16, 1840), (9, 200), (1, 1200),
                                 (3, 7)])
def test_quantize_rows_and_prepare_match_jax(m, k):
    x = _np(m * k, m, k, scale=2.0)
    jq, js = jops.quantize_rows(jnp.asarray(x))
    tq, ts = tops.quantize_rows(_t(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    jwq, jws = jops.prepare_int8_weights(jnp.asarray(x))
    twq, tws = tops.prepare_int8_weights(_t(x))
    assert tuple(twq.shape) == (m, k) and twq.t().is_contiguous()
    np.testing.assert_array_equal(twq.numpy(), np.asarray(jwq))
    np.testing.assert_array_equal(tws.numpy(), np.asarray(jws))


def test_quantize_rows_zero_row_and_ties():
    x = np.zeros((2, 4), np.float32)
    x[1] = [127.0, 0.5, 1.5, -2.5]       # scale 1: halves round to even
    tq, ts = tops.quantize_rows(_t(x))
    assert tq[0].tolist() == [0, 0, 0, 0] and float(ts[0]) == 0.0
    assert tq[1].tolist() == [127, 0, 2, -2]
    jq, _ = jops.quantize_rows(jnp.asarray(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))


@pytest.mark.parametrize("mode", JAX_MODES)
@pytest.mark.parametrize("m,k,n", INT8_SHAPES + [(9, 200, 96)])
def test_int8_matmul_pipeline_matches_jax(m, k, n, mode):
    """Float in, float out: quantize both operands, int8 product, rescale;
    prepared weights give the same bits as the one-shot call."""
    x, w = _np(m, m, k), _np(n, k, n)
    want = jops.int8_matmul(jnp.asarray(x), jnp.asarray(w),
                            policy=JaxPolicy(mode))
    got = tops.int8_matmul(_t(x), _t(w))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    wq, ws = tops.prepare_int8_weights(_t(w))
    assert torch.equal(tops.int8_matmul_prepared(_t(x), wq, ws), got)


def test_int8_matmul_prepared_refuses_a_mesh_axis():
    """The sharded contraction (`axis=`) was refused until it was ported;
    it is taken now.  A whole weight ignores the axis (bitwise the
    unsharded call); a feature-axis shard takes the scales of the FULL
    rows and the rank's columns (a one-rank axis: no all-reduce; the
    multi-rank path is tests/test_torch_mesh.py's)."""
    from repro_torch.launch.mesh import MeshAxis
    x, w = _t(_np(0, 4, 16)), _t(_np(1, 16, 8))
    wq, ws = tops.prepare_int8_weights(w)
    for index in (0, 1):
        ax = MeshAxis("model", 1, index, (0,))
        assert torch.equal(tops.int8_matmul_prepared(x, wq, ws, axis=ax),
                           tops.int8_matmul_prepared(x, wq, ws))
        shard = wq[8 * index:8 * (index + 1)]
        xq, xs = tops.quantize_rows(x)
        want = tref.int8_matmul(xq[:, 8 * index:8 * (index + 1)], shard, xs,
                                ws)
        for overlap in (False, True):
            got = tops.int8_matmul_prepared(x, shard, ws, axis=ax,
                                            overlap=overlap)
            assert torch.equal(got, want), (index, overlap)


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


def _sorted_row(seed, n):
    """One candidate row sorted by key as the TPU kernel receives it:
    (uint32 keys, pb, pnb), dead candidates keyed to the sentinel."""
    h, pb, pnb = (a[0] for a in _candidates(seed, 1, n))
    live = np.logaddexp(pb, pnb) > NEG_INF / 2
    key = np.where(live, h.astype(np.uint32), np.uint32(0xFFFFFFFF))
    order = np.argsort(key, kind="stable")
    return key[order], pb[order], pnb[order]


@pytest.mark.parametrize("iterative_topk", [False, True])
@pytest.mark.parametrize("seed,n,k,beam", [
    (0, 12, 4, 5.0), (1, 64, 16, 10.0), (2, 200, 16, 3.0), (3, 130, 32, 1e9),
    (4, 1040, 128, 25.0),
])
def test_merge_select_sorted_matches_jax(seed, n, k, beam, iterative_topk):
    key, pb, pnb = _sorted_row(seed, n)
    want = jref.merge_select_sorted(jnp.asarray(key), jnp.asarray(pb),
                                    jnp.asarray(pnb), k=k, beam=beam,
                                    iterative_topk=iterative_topk)
    got = tref.merge_select_sorted(_t(key.astype(np.int64)), _t(pb), _t(pnb),
                                   k=k, beam=beam)
    for i, name in ((0, "pos"), (3, "valid")):
        assert got[i].dtype == torch.int32
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want[i]),
                                      err_msg=name)
    for i, name in ((1, "pb"), (2, "pnb")):
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want[i]),
                                   rtol=1e-5, atol=0, err_msg=name)


# ---------------------------------------------------------------------------
# unfused tds conv (the reference's semantic spec of the conv)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("k,stride,t,w,cin,cout", [
    (9, 1, 32, 16, 5, 7), (9, 2, 32, 16, 5, 7), (10, 2, 64, 80, 15, 19),
    (21, 1, 64, 8, 3, 3), (9, 1, 48, 16, 5, 7), (9, 1, 40, 8, 3, 3),
    (5, 2, 72, 8, 3, 3),
])
def test_tds_conv_unfused_matches_jax(k, stride, t, w, cin, cout):
    x = _np(k, k - 1 + t, w, cin)
    wgt = _np(1, k, cin, cout, scale=0.3)
    b = _np(2, cout)
    want = jref.tds_conv(jnp.asarray(x), jnp.asarray(wgt), jnp.asarray(b),
                         stride=stride)
    got = tref.tds_conv(_t(x), _t(wgt), _t(b), stride=stride)
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    fused = tref.tds_conv_fused(_t(x)[None], _t(wgt), _t(b), stride=stride)[0]
    np.testing.assert_allclose(got.numpy(), fused.numpy(), rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# beam prune
# ---------------------------------------------------------------------------
PRUNE_CASES = ["100/1", "1000/5", "8448/25", "1/25", "1025/5", "nan",
               "all_neg_inf", "pos_inf", "tie"]


def _prune_input(case):
    """(scores, beam, checks): the sweep of tests/test_kernels.py, N = 1
    and 1025, and rows holding a NaN, only -inf, +inf, and a score placed
    exactly on the fp32 threshold (kept) beside one an ulp below it
    (masked).  `checks` maps index -> expected output."""
    if "/" in case:
        n, beam = (int(v) for v in case.split("/"))
        return _np(n, n, scale=10.0), float(beam), {}
    s = _np(7, 1000, scale=10.0)
    if case == "nan":
        s[337] = np.nan
        return s, 5.0, {0: NEG_INF, 337: NEG_INF}
    if case == "all_neg_inf":
        return np.full(1000, -np.inf, np.float32), 5.0, {0: -np.inf}
    if case == "pos_inf":
        s[[3, 900]] = np.inf
        return s, 25.0, {3: np.inf, 900: np.inf, 0: NEG_INF}
    i = (int(s.argmax()) + 1) % s.size
    thr = np.float32(s.max()) - np.float32(0.1)      # fp32, as the reference
    s[i] = thr
    s[i + 1] = np.nextafter(thr, np.float32(-np.inf))
    return s, 0.1, {i: thr, i + 1: NEG_INF}


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("case", PRUNE_CASES)
def test_beam_prune_matches_jax_bitwise(case):
    s, beam, checks = _prune_input(case)
    got = tref.beam_prune(_t(s), beam).numpy()
    assert got.dtype == np.float32 and got.shape == s.shape
    want_ref = np.asarray(jref.beam_prune(jnp.asarray(s), beam))
    want_kernel = np.asarray(jops.beam_prune(jnp.asarray(s), beam,
                                             policy=JaxPolicy("interpret")))
    np.testing.assert_array_equal(_bits(got), _bits(want_ref))
    np.testing.assert_array_equal(_bits(got), _bits(want_kernel))
    for i, v in checks.items():
        assert got[i] == np.float32(v), (i, got[i], v)


def test_beam_prune_dispatch_on_cpu():
    """ops.beam_prune under ref and auto on CPU tensors (mirrors
    tests/test_hypothesis_unit.py's policy-consistency test)."""
    s = _t(_np(0, 300, scale=10.0))
    want = np.asarray(jops.beam_prune(jnp.asarray(s.numpy()), 4.0,
                                      policy=JaxPolicy("interpret")))
    for policy in (KernelPolicy("ref"), KernelPolicy("auto"), None):
        got = tops.beam_prune(s, 4.0, policy=policy)
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    with pytest.raises(ValueError, match="CUDA"):
        tops.beam_prune(s, 4.0, policy=KernelPolicy("kernel"))


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
    xq, wq, xs, ws = (_t(a) for a in _int8_operands(10, 5, 40, 24))
    assert torch.equal(tim.int8_matmul(xq, wq, xs, ws),
                       tref.int8_matmul(xq, wq, xs, ws))
    xf = _t(_np(12, 5, 40))
    assert torch.equal(tim.int8_matmul_fused(xf, wq, ws),
                       tops.int8_matmul_prepared(xf, wq, ws))
    sc = _t(_np(11, 64, scale=10.0))
    assert torch.equal(tbp.beam_prune(sc, 5.0), tops.beam_prune(sc, 5.0))
    assert tops.launch_counts() == {"logmel": 0, "tds_conv": 0,
                                    "layernorm": 0, "hypothesis_unit": 0,
                                    "int8_matmul": 0, "rmsnorm": 0,
                                    "flash_attention": 0, "beam_prune": 0}


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
