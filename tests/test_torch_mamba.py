"""The port's Mamba-2 block (`repro_torch.models.mamba`) vs the JAX
package's (`repro.models.mamba`) on the same numpy inputs, and the
properties of tests/test_mamba.py on the port's side.

Tolerances (fp32, two frameworks; the SSD sums and exps run in another
order): the causal conv atol 1e-6 (its new state exactly equal: a
gather); `ssd_chunked` y and the carried state rtol 1e-5, atol 1e-5;
`apply_mamba` outputs atol 1e-5, the new conv state exactly equal and
the SSM state rtol/atol 1e-5.  The properties keep tests/test_mamba.py's
own tolerances.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import SSMSpec as JSSMSpec  # noqa: E402
from repro.models import mamba as jm  # noqa: E402
from repro_torch.configs.base import SSMSpec  # noqa: E402
from repro_torch.models import mamba as tm  # noqa: E402
from repro_torch.models import params_from_numpy  # noqa: E402

torch.set_num_threads(1)

SSD_TOL = dict(rtol=1e-5, atol=1e-5)
SPEC = dict(d_state=8, expand=2, head_dim=8, conv_kernel=4, chunk_size=8)
D_MODEL = 32


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


def _rand(seed, *shape, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _both(a):
    return jnp.asarray(a), torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# _causal_conv
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("lengths", [None, (9, 1, 2, 5)])
def test_causal_conv_matches_jax(with_state, lengths):
    """Lengths 1 and 2 are shorter than ck-1 = 3: those rows' new state
    keeps the initial state's rows ahead of their inputs (zeros without
    a state)."""
    B, S, C, ck = 4, 9, 6, 4
    x, w, b = _rand(0, B, S, C), _rand(1, ck, C), _rand(2, C)
    st = _rand(3, B, ck - 1, C) if with_state else None
    jargs = [jnp.asarray(a) for a in (x, w, b)]
    targs = [torch.from_numpy(a) for a in (x, w, b)]
    jl = None if lengths is None else jnp.asarray(lengths, jnp.int32)
    tl = None if lengths is None else torch.tensor(lengths, dtype=torch.int32)
    jy, js = jm._causal_conv(*jargs, None if st is None else jnp.asarray(st),
                             lengths=jl)
    ty, ts = tm._causal_conv(*targs,
                             None if st is None else torch.from_numpy(st),
                             lengths=tl)
    np.testing.assert_allclose(_np(ty), _np(jy), rtol=0, atol=1e-6)
    assert np.array_equal(_np(ts), _np(js))
    if lengths is not None and not with_state:
        assert (_np(ts)[1, :2] == 0).all() and (_np(ts)[2, :1] == 0).all()


def test_causal_conv_shorter_than_the_kernel_matches_jax():
    B, S, C, ck = 2, 2, 5, 4
    x, w, b, st = (_rand(4, B, S, C), _rand(5, ck, C), _rand(6, C),
                   _rand(7, B, ck - 1, C))
    jy, js = jm._causal_conv(*(jnp.asarray(a) for a in (x, w, b, st)))
    ty, ts = tm._causal_conv(*(torch.from_numpy(a) for a in (x, w, b, st)))
    np.testing.assert_allclose(_np(ty), _np(jy), rtol=0, atol=1e-6)
    assert np.array_equal(_np(ts), _np(js))
    assert np.array_equal(_np(ts), np.concatenate([st, x], 1)[:, -3:])


# ---------------------------------------------------------------------------
# ssd_chunked
# ---------------------------------------------------------------------------
def _ssd_inputs(seed, B=2, S=16, H=4, P=3, N=5, G=1):
    r = np.random.RandomState(seed)
    return (r.randn(B, S, H, P).astype(np.float32),
            (np.abs(r.randn(B, S, H)) * 0.5).astype(np.float32),
            -np.abs(r.randn(H)).astype(np.float32),
            r.randn(B, S, G, N).astype(np.float32),
            r.randn(B, S, G, N).astype(np.float32))


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("chunk", [4, 8, 16])
def test_ssd_chunked_matches_jax(chunk, groups, with_h0):
    x, dt, A, Bm, Cm = _ssd_inputs(chunk * 10 + groups, G=groups)
    h0 = _rand(9, 2, 4, 3, 5) if with_h0 else None
    jy, jh = jm.ssd_chunked(*(jnp.asarray(a) for a in (x, dt, A, Bm, Cm)),
                            chunk, None if h0 is None else jnp.asarray(h0))
    ty, th = tm.ssd_chunked(*(torch.from_numpy(a) for a in (x, dt, A, Bm, Cm)),
                            chunk, None if h0 is None else torch.from_numpy(h0))
    assert ty.dtype == th.dtype == torch.float32
    np.testing.assert_allclose(_np(ty), _np(jy), **SSD_TOL)
    np.testing.assert_allclose(_np(th), _np(jh), **SSD_TOL)


def test_ssd_chunked_refuses_a_ragged_chunk():
    x, dt, A, Bm, Cm = (torch.from_numpy(a) for a in _ssd_inputs(0, S=12))
    with pytest.raises(ValueError, match="chunk"):
        tm.ssd_chunked(x, dt, A, Bm, Cm, 8)


# ---------------------------------------------------------------------------
# apply_mamba
# ---------------------------------------------------------------------------
_BLOCK = {}


def _block(dtype="float32"):
    """(jax spec, port spec, jax params, port params): the reference's
    init, carried across."""
    if dtype not in _BLOCK:
        jspec, tspec = JSSMSpec(**SPEC), SSMSpec(**SPEC)
        jp = jm.init_mamba(jax.random.PRNGKey(0), D_MODEL, jspec,
                           dtype=jnp.dtype(dtype))
        # non-trivial A, D, dt_bias and norm scale (the init's are 0/1)
        r = np.random.RandomState(1)
        nh = jspec.n_heads(D_MODEL)
        jp = dict(jp, A_log=jnp.asarray(r.randn(nh).astype(np.float32) * .5),
                  D=jnp.asarray(r.randn(nh).astype(np.float32)),
                  dt_bias=jnp.asarray(r.randn(nh).astype(np.float32) * .5),
                  norm_gate={"scale": jnp.asarray(
                      1 + 0.1 * r.randn(jspec.d_inner(D_MODEL)).astype(
                          np.float32))})
        _BLOCK[dtype] = (jspec, tspec, jp, params_from_numpy(jp))
    return _BLOCK[dtype]


def _cmp_cache(tc, jc):
    assert set(tc) == set(jc) == {"conv", "ssm"}
    assert tc["ssm"].dtype == torch.float32
    np.testing.assert_allclose(_np(tc["conv"]), _np(jc["conv"]), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(_np(tc["ssm"]), _np(jc["ssm"]), **SSD_TOL)


def test_apply_mamba_prefill_matches_jax():
    jspec, tspec, jp, tp = _block()
    x = _rand(2, 2, 24, D_MODEL)
    jy, jc = jm.apply_mamba(jp, jnp.asarray(x), jspec)
    ty, tc = tm.apply_mamba(tp, torch.from_numpy(x), tspec)
    np.testing.assert_allclose(_np(ty), _np(jy), rtol=0, atol=1e-5)
    _cmp_cache(tc, jc)


def test_apply_mamba_masked_prefill_matches_jax():
    """Right-padded rows of lengths 24, 1 and 13: dt is zeroed on the
    padding, so each row's SSM state is its unpadded prefill's."""
    jspec, tspec, jp, tp = _block()
    x = _rand(3, 3, 24, D_MODEL)
    lens = np.array([24, 1, 13], np.int32)
    jy, jc = jm.apply_mamba(jp, jnp.asarray(x), jspec,
                            lengths=jnp.asarray(lens))
    ty, tc = tm.apply_mamba(tp, torch.from_numpy(x), tspec,
                            lengths=torch.from_numpy(lens))
    np.testing.assert_allclose(_np(ty), _np(jy), rtol=0, atol=1e-5)
    _cmp_cache(tc, jc)
    # row 2's state equals the prefill of its 13 real tokens alone,
    # padded to a chunk multiple of 16 (padding with dt = 0 is identity)
    _, alone = tm.apply_mamba(tp, torch.from_numpy(x[2:3, :16]), tspec,
                              lengths=torch.tensor([13]))
    np.testing.assert_allclose(_np(alone["ssm"][0]), _np(tc["ssm"][2]),
                               **SSD_TOL)


def test_apply_mamba_step_with_cache_matches_jax():
    """S = 1 with a cache: the exact recurrence, from a prefilled state."""
    jspec, tspec, jp, tp = _block()
    x = _rand(4, 2, 16, D_MODEL)
    _, jc = jm.apply_mamba(jp, jnp.asarray(x), jspec)
    _, tc = tm.apply_mamba(tp, torch.from_numpy(x), tspec)
    x1 = _rand(5, 2, 1, D_MODEL)
    for _ in range(3):
        jy, jc = jm.apply_mamba(jp, jnp.asarray(x1), jspec, jc)
        ty, tc = tm.apply_mamba(tp, torch.from_numpy(x1), tspec, tc)
        np.testing.assert_allclose(_np(ty), _np(jy), rtol=0, atol=1e-5)
        _cmp_cache(tc, jc)
        x1 = _np(ty)                            # feed the output back


def test_apply_mamba_bf16_prefill_matches_jax():
    """bf16 weights and activations (fp32 SSD, state and norm), at the
    relative 2e-2 of the LM's bf16 tests."""
    jspec, tspec, jp, tp = _block("bfloat16")
    x = _rand(6, 2, 16, D_MODEL).astype(jnp.bfloat16)
    jy, jc = jm.apply_mamba(jp, jnp.asarray(x), jspec)
    ty, tc = tm.apply_mamba(tp, params_from_numpy(x), tspec)
    assert ty.dtype == torch.bfloat16 and tc["conv"].dtype == torch.bfloat16
    a, b = _np(ty), _np(jy)
    assert np.abs(a - b).max() / np.abs(b).max() < 2e-2
    s, t = _np(tc["ssm"]), _np(jc["ssm"])
    assert np.abs(s - t).max() / np.abs(t).max() < 2e-2


def test_init_mamba_matches_reference_shapes():
    jspec, tspec, _, _ = _block()
    shapes = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)),
                          jm.init_mamba(jax.random.PRNGKey(0), D_MODEL, jspec))
    tp = tm.init_mamba(torch.Generator().manual_seed(0), D_MODEL, tspec)

    def walk(t, j):
        if isinstance(j, dict):
            assert set(t) == set(j)
            for k in j:
                walk(t[k], j[k])
        else:
            assert (tuple(t.shape), str(t.dtype).replace("torch.", "")) == j
    walk(tp, shapes)
    cache = tm.init_cache(3, D_MODEL, tspec)
    jcache = jm.init_cache(3, D_MODEL, jspec)
    for k in ("conv", "ssm"):
        assert tuple(cache[k].shape) == jcache[k].shape
        assert str(cache[k].dtype) == f"torch.{jcache[k].dtype}"


# ---------------------------------------------------------------------------
# the properties of tests/test_mamba.py, on the port's side
# ---------------------------------------------------------------------------
def _naive_recurrence(x, dt, A, Bm, Cm):
    """Exact per-step recurrence: h = h*exp(dt*A) + dt*B(x); y = C.h."""
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    h = np.zeros((B, H, P, N), np.float64)
    ys = np.zeros((B, S, H, P), np.float64)
    for t in range(S):
        for b in range(B):
            for hh in range(H):
                g = hh // rep
                dec = np.exp(float(dt[b, t, hh]) * float(A[hh]))
                h[b, hh] = h[b, hh] * dec + float(dt[b, t, hh]) * np.outer(
                    x[b, t, hh], Bm[b, t, g])
                ys[b, t, hh] = h[b, hh] @ Cm[b, t, g]
    return ys, h


@pytest.mark.parametrize("seed,chunk,groups", [
    (s, c, g) for s, (c, g) in enumerate([(2, 1), (4, 1), (8, 1), (2, 2),
                                          (4, 2), (8, 2)])])
def test_ssd_chunked_matches_recurrence(seed, chunk, groups):
    x, dt, A, Bm, Cm = _ssd_inputs(1000 + seed, G=groups)
    y, hT = tm.ssd_chunked(*(torch.from_numpy(a) for a in (x, dt, A, Bm, Cm)),
                           chunk)
    y_ref, h_ref = _naive_recurrence(x, dt, A, Bm, Cm)
    np.testing.assert_allclose(_np(y), y_ref, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(_np(hT), h_ref, rtol=2e-3, atol=2e-3)


def test_ssd_streaming_state_carry():
    """ssd over [a;b] == ssd(a) then ssd(b, h0=state(a))."""
    r = np.random.RandomState(0)
    B, S, H, P, N = 1, 32, 4, 4, 8
    x = torch.from_numpy(r.randn(B, S, H, P).astype(np.float32))
    dt = torch.from_numpy(np.abs(r.randn(B, S, H)).astype(np.float32))
    A = torch.from_numpy(-np.abs(r.randn(H)).astype(np.float32))
    Bm = torch.from_numpy(r.randn(B, S, 1, N).astype(np.float32))
    Cm = torch.from_numpy(r.randn(B, S, 1, N).astype(np.float32))
    y_full, h_full = tm.ssd_chunked(x, dt, A, Bm, Cm, 8)
    y1, h1 = tm.ssd_chunked(x[:, :16], dt[:, :16], A, Bm[:, :16],
                            Cm[:, :16], 8)
    y2, h2 = tm.ssd_chunked(x[:, 16:], dt[:, 16:], A, Bm[:, 16:],
                            Cm[:, 16:], 8, h0=h1)
    np.testing.assert_allclose(_np(y_full[:, 16:]), _np(y2), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(_np(h_full), _np(h2), rtol=1e-4, atol=1e-4)


def test_mamba_block_decode_equals_prefill():
    spec = SSMSpec(d_state=8, expand=2, head_dim=8, conv_kernel=4,
                   chunk_size=8)
    p = tm.init_mamba(torch.Generator().manual_seed(0), D_MODEL, spec,
                      dtype=torch.float32)
    x = torch.from_numpy(_rand(1, 2, 16, D_MODEL))
    y_full, _ = tm.apply_mamba(p, x, spec)
    cache = tm.init_cache(2, D_MODEL, spec, torch.float32)
    ys = []
    for t in range(16):
        y, cache = tm.apply_mamba(p, x[:, t:t + 1], spec, cache)
        ys.append(y)
    np.testing.assert_allclose(_np(y_full), _np(torch.cat(ys, 1)),
                               rtol=2e-3, atol=2e-3)
