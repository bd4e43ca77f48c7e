"""CUDA kernels vs their plain PyTorch versions, on the card.

Each test needs a CUDA device and skips without one (decided in the
`cuda` fixture, never at import).  Shapes reuse the CPU parity sweeps of
tests/test_torch_kernels.py.  Run on a machine with a card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py

Tolerances: logmel rtol 1e-4, atol 1e-3; layernorm and tds_conv
atol 1e-5 (rtol 1e-5); hypothesis unit idx/valid exact, pb/pnb rtol
1e-5 — the kernels sum in another order than cuBLAS and the plain
version's unordered scatter_add.  int8_matmul: bitwise (integer sums
are exact in any order, and the rescale is the same two fp32 products).
beam_prune: bitwise (a max is exact in any order; the threshold is one
fp32 subtraction), NaN and +-inf included.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import (beam_prune as tbp,  # noqa: E402
                                 flash_attention as tfa,
                                 hypothesis_unit as thu,
                                 int8_matmul as tim, layernorm as tln,
                                 logmel as tlm, ops, ref, tds_conv as ttc)

pytestmark = pytest.mark.cuda
NEG_INF = -1e30


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _t(dev, seed, *shape, scale=1.0):
    a = np.random.RandomState(seed).randn(*shape).astype(np.float32) * scale
    return torch.from_numpy(a).to(dev)


@pytest.mark.parametrize("t,c", [(8, 40), (50, 80), (128, 80), (300, 40)])
def test_logmel_kernel_matches_plain(cuda, t, c):
    p = _t(cuda, t, t, 257).abs() + 1e-3
    fb, dct = _t(cuda, 1, 257, 80).abs(), _t(cuda, 2, 80, c)
    got = tlm.logmel(p, fb, dct)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref.logmel(p, fb, dct),
                               rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("t,d", [(32, 64), (256, 80), (100, 257), (37, 80),
                                 (300, 129), (8, 1200), (32, 1840)])
def test_layernorm_kernel_matches_plain(cuda, t, d):
    x, s, b = _t(cuda, d, t, d), _t(cuda, 1, d), _t(cuda, 2, d)
    got = tln.layernorm(x, s, b)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref.layernorm(x, s, b),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("batch,k,stride,t,w,cin,cout,relu,residual", [
    (1, 9, 1, 32, 16, 5, 7, False, False), (2, 9, 2, 32, 16, 5, 7, True, False),
    (4, 10, 2, 64, 80, 15, 19, True, False), (1, 21, 1, 64, 8, 3, 3, False,
                                              False),
    (3, 9, 1, 24, 8, 6, 6, True, True), (4, 9, 1, 4, 80, 23, 23, True, True),
    (4, 9, 1, 32, 80, 1, 15, True, False),
])
def test_tds_conv_kernel_matches_plain(cuda, batch, k, stride, t, w, cin,
                                       cout, relu, residual):
    x = _t(cuda, batch, batch, k - 1 + t, w, cin)
    wgt = _t(cuda, 1, k, cin, cout, scale=0.3)
    b = _t(cuda, 2, cout)
    res = _t(cuda, 3, batch, t // stride, w, cout) if residual else None
    got = ttc.tds_conv(x, wgt, b, res, stride=stride, relu=relu)
    torch.cuda.synchronize()
    want = ref.tds_conv_fused(x, wgt, b, stride=stride, relu=relu, res=res)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def _candidates(dev, seed, b, n, n_hash, dead_rate=0.2):
    r = np.random.RandomState(seed)
    h = r.randint(0, n_hash, (b, n)).astype(np.int32)
    pb = (r.randn(b, n) * 3).astype(np.float32)
    pnb = (r.randn(b, n) * 3).astype(np.float32)
    dead = r.rand(b, n) < dead_rate
    pb = np.where(dead, NEG_INF, pb).astype(np.float32)
    pnb = np.where(dead, NEG_INF, pnb).astype(np.float32)
    return (torch.from_numpy(h).to(dev), torch.from_numpy(pb).to(dev),
            torch.from_numpy(pnb).to(dev))


@pytest.mark.parametrize("seed,b,n,k,beam,n_hash,dead", [
    (0, 1, 12, 4, 5.0, 6, 0.2), (1, 3, 64, 16, 10.0, 32, 0.2),
    (2, 4, 200, 16, 3.0, 100, 0.2), (3, 2, 130, 32, 1e9, 65, 0.2),
    (4, 4, 8320, 128, 25.0, 4096, 0.2), (5, 1, 4224, 128, 25.0, 4096, 0.2),
    (6, 2, 12, 12, 1e9, 1, 0.2), (7, 4, 8320, 128, 25.0, 4096, 0.95),
    (8, 2, 8320, 128, 1e9, 2**31 - 1, 0.0), (9, 3, 300, 128, 25.0, 50, 0.9),
    (10, 2, 16384, 64, 25.0, 8000, 0.1), (11, 2, 40, 8, 5.0, 10, 1.0),
])
def test_hypothesis_unit_kernel_matches_plain(cuda, seed, b, n, k, beam,
                                              n_hash, dead):
    h, pb, pnb = _candidates(cuda, seed, b, n, n_hash, dead_rate=dead)
    got = thu.hypothesis_unit(h, pb, pnb, k=k, beam=beam)
    torch.cuda.synchronize()
    want = ref.hypothesis_unit(h, pb, pnb, k=k, beam=beam)
    assert torch.equal(got["idx"], want["idx"])
    assert torch.equal(got["valid"], want["valid"])
    for key in ("pb", "pnb"):
        torch.testing.assert_close(got[key], want[key], rtol=1e-5, atol=0)


@pytest.mark.parametrize("m,k,n", [
    (64, 1200, 1200), (32, 1520, 1520), (16, 1840, 1840), (16, 1840, 9000),
    (8, 128, 128), (100, 200, 96), (1, 1200, 600), (5, 37, 29),
    (33, 2100, 70), (17, 4100, 3)])
def test_int8_matmul_kernel_matches_plain(cuda, m, k, n):
    """Main-path shapes, the CPU sweep, and ragged M, K and N (K beyond
    one 2048-byte staging pass, K not a multiple of 16)."""
    x, w = _t(cuda, m, m, k), _t(cuda, n, k, n)
    wq, ws = ops.prepare_int8_weights(w)
    xq, xs = ops.quantize_rows(x)
    got = tim.int8_matmul(xq, wq, xs, ws)
    torch.cuda.synchronize()
    assert torch.equal(got, ref.int8_matmul(xq, wq, xs, ws))
    # a row-major (K, N) weight is copied into the kernel's layout
    assert torch.equal(tim.int8_matmul(xq, wq.contiguous(), xs, ws), got)


def test_int8_matmul_kernel_exact_at_full_scale(cuda):
    """|acc| = 127^2 * 1840 > 2^24 stays exact."""
    xq = torch.full((16, 1840), 127, dtype=torch.int8, device=cuda)
    wq = torch.full((1840, 40), -127, dtype=torch.int8, device=cuda)
    xs = torch.ones(16, device=cuda)
    ws = torch.ones(40, device=cuda)
    got = tim.int8_matmul(xq, wq, xs, ws)
    torch.cuda.synchronize()
    assert torch.equal(got, ref.int8_matmul(xq, wq, xs, ws))
    assert float(got[0, 0]) == float(np.float32(-127 * 127 * 1840))


def test_wrappers_count_launches_and_refuse_bad_input(cuda):
    ops.reset_launch_counts()
    x = _t(cuda, 0, 4, 64)
    tln.layernorm(x, _t(cuda, 1, 64), _t(cuda, 2, 64))
    assert ops.launch_counts()["layernorm"] == 1
    with pytest.raises(ValueError):
        tln.layernorm(x.t(), _t(cuda, 1, 4), _t(cuda, 2, 4))   # not contiguous
    with pytest.raises(ValueError):
        tln.layernorm(x, _t(cuda, 1, 64).cpu(), _t(cuda, 2, 64))
    assert ops.launch_counts()["layernorm"] == 1
    xq, xs = ops.quantize_rows(x)
    wq, ws = ops.prepare_int8_weights(_t(cuda, 3, 64, 24))
    tim.int8_matmul(xq, wq, xs, ws)
    with pytest.raises(ValueError):
        tim.int8_matmul(xq.float(), wq, xs, ws)               # not int8
    with pytest.raises(ValueError):
        tim.int8_matmul(xq, wq[:32], xs, ws)                  # K mismatch
    assert ops.launch_counts()["int8_matmul"] == 1
    s = _t(cuda, 4, 1000, scale=10.0)
    tbp.beam_prune(s, 5.0)
    for bad in (s.reshape(10, 100), s.to(torch.bfloat16), s[::2],
                s[:0]):                  # 2-D, bf16, not contiguous, empty
        with pytest.raises(ValueError):
            tbp.beam_prune(bad, 5.0)
    assert ops.launch_counts()["beam_prune"] == 1
    tbp.beam_prune(_t(cuda, 5, 65537), 5.0)     # two passes: two launches
    assert ops.launch_counts()["beam_prune"] == 3


def _prune_input(dev, n, case, beam):
    """Scores of N = n (scale 10) for one `case`: "random", "nan" (one
    NaN), "neg_inf" (all -inf), "pos_inf" (two +inf entries) or "tie"
    (a score exactly on the fp32 threshold and one an ulp below it)."""
    s = np.random.RandomState(n).randn(n).astype(np.float32) * 10
    if case == "nan":
        s[n // 3] = np.nan
    elif case == "neg_inf":
        s[:] = -np.inf
    elif case == "pos_inf":
        s[[0, n - 1]] = np.inf
    elif case == "tie":
        i = (int(s.argmax()) + 1) % (n - 1)
        thr = np.float32(s.max()) - np.float32(beam)
        s[i], s[i + 1] = thr, np.nextafter(thr, np.float32(-np.inf))
    return torch.from_numpy(s).to(dev)


@pytest.mark.parametrize("n,case,beam", [
    *[(n, "random", b) for n in (1, 100, 1000, 1025, 8320, 8448)
      for b in (1.0, 5.0, 25.0)],
    (65536, "random", 25.0), (65537, "random", 25.0),
    (4_194_307, "random", 25.0),            # across blocks, ragged
    *[(n, c, b) for n in (8448, 4_194_307)
      for c, b in (("nan", 5.0), ("neg_inf", 5.0), ("pos_inf", 25.0),
                   ("tie", 0.1))],
])
def test_beam_prune_kernel_matches_plain_bitwise(cuda, n, case, beam):
    s = _prune_input(cuda, n, case, beam)
    got = tbp.beam_prune(s, beam)
    torch.cuda.synchronize()
    want = ref.beam_prune(s, beam)
    assert got.dtype == torch.float32 and got.shape == s.shape
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(ops.beam_prune(s, beam).view(torch.int32),
                       want.view(torch.int32))


_TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
        torch.bfloat16: dict(rtol=1e-2, atol=1e-2)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,d", [(4, 2560), (512, 2560), (37, 80), (5, 64),
                                 (300, 129), (1, 7)])
def test_rmsnorm_kernel_matches_plain(cuda, t, d, dtype):
    """The LM's shapes (decode rows, prefill rows at D = 2560) and
    ragged ones."""
    x = _t(cuda, d, t, d).to(dtype)
    s = 1 + 0.1 * _t(cuda, 1, d)
    got = tln.rmsnorm(x, s)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    torch.testing.assert_close(got, ref.rmsnorm(x, s), **_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,kv,sq,skv,d,causal,window", [
    (2, 3, 3, 64, 64, 32, True, None), (2, 3, 3, 64, 128, 32, True, None),
    (2, 3, 3, 32, 128, 32, False, None), (2, 3, 3, 128, 128, 32, True, 48),
    (2, 3, 3, 64, 256, 32, True, 17),
    (1, 32, 8, 300, 300, 80, True, 100),       # GQA 32/8, D = 80, ragged S
    (2, 32, 8, 77, 200, 80, True, 64),         # Sq < Skv, window < S
    (1, 32, 8, 513, 513, 80, True, None), (3, 4, 4, 100, 100, 128, False, 30),
    (2, 8, 2, 40, 40, 16, True, None), (1, 4, 1, 33, 33, 40, True, None),
])
def test_flash_attention_kernel_matches_plain(cuda, b, h, kv, sq, skv, d,
                                              causal, window, dtype):
    q = _t(cuda, 1, b, h, sq, d).to(dtype)
    k = _t(cuda, 2, b, kv, skv, d).to(dtype)
    v = _t(cuda, 3, b, kv, skv, d).to(dtype)
    got = tfa.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(
        got, ref.flash_attention(q, k, v, causal=causal, window=window),
        **_TOL[dtype])


def test_lm_kernel_wrappers_count_and_refuse_bad_input(cuda):
    ops.reset_launch_counts()
    x = _t(cuda, 0, 4, 64).to(torch.bfloat16)
    tln.rmsnorm(x, _t(cuda, 1, 64))
    assert ops.launch_counts()["rmsnorm"] == 1
    assert ops.launch_counts()["layernorm"] == 0
    with pytest.raises(ValueError):
        tln.rmsnorm(x, _t(cuda, 1, 64).to(torch.bfloat16))  # scale not f32
    with pytest.raises(ValueError):
        tln.rmsnorm(x.t(), _t(cuda, 1, 4))                  # not contiguous
    q = _t(cuda, 2, 1, 4, 16, 80)
    k = _t(cuda, 3, 1, 2, 16, 80)
    tfa.flash_attention(q, k, k, causal=True)
    assert ops.launch_counts()["flash_attention"] == 1
    with pytest.raises(ValueError):
        tfa.flash_attention(q[..., :12].contiguous(),
                            k[..., :12].contiguous(),
                            k[..., :12].contiguous())       # D % 8 != 0
    with pytest.raises(ValueError):
        tfa.flash_attention(q, _t(cuda, 4, 1, 3, 16, 80),
                            _t(cuda, 4, 1, 3, 16, 80))      # 3 does not divide 4
    with pytest.raises(ValueError):
        tfa.flash_attention(q, k.to(torch.bfloat16), k)     # mixed dtypes
    # a transposed (B, S, H, D) view goes through ops, which copies it
    qs = q.transpose(1, 2).contiguous().transpose(1, 2)
    torch.testing.assert_close(ops.flash_attention(qs, k, k),
                               ref.flash_attention(q, k, k),
                               rtol=1e-5, atol=1e-5)
    assert ops.launch_counts()["flash_attention"] == 2
