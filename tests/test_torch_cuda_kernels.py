"""CUDA kernels vs their plain PyTorch versions, on the card.

Each test needs a CUDA device and skips without one (decided in the
`cuda` fixture, never at import).  Shapes reuse the CPU parity sweeps of
tests/test_torch_kernels.py.  Run on a machine with a card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py

Tolerances: logmel and the fused MFCC rtol 1e-4, atol 1e-3 (the MFCC:
the kernel's own FFT against cuFFT, then a log domain); layernorm and tds_conv
atol 1e-5 (rtol 1e-5); bf16 layernorm rows 1e-2 (one bf16 ulp, as
rmsnorm's); the fused conv + LayerNorm and bias + residual +
LayerNorm also atol 1e-5 (rtol 1e-5): the LayerNorm divides the conv
sum's rounding (~1e-7 relative, sums in another order than cuBLAS) by the
row's standard deviation, which is O(1) or larger for these inputs, and
the bias and residual are the same fp32 adds in the same order as the
plain version's; hypothesis unit idx/valid exact, pb/pnb rtol
1e-5 — the kernels sum in another order than cuBLAS and the plain
version's unordered scatter_add.  int8_matmul: bitwise (integer sums
are exact in any order, and the rescale is the same two fp32 products).
beam_prune: bitwise (a max is exact in any order; the threshold is one
fp32 subtraction), NaN and +-inf included.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import tds_asr as tcfg  # noqa: E402
from repro_torch.core import features as tfeat  # noqa: E402
from repro_torch.kernels import (beam_prune as tbp,  # noqa: E402
                                 flash_attention as tfa,
                                 hypothesis_unit as thu,
                                 int8_matmul as tim, layernorm as tln,
                                 logmel as tlm, ops, ref, tds_conv as ttc)
from repro_torch.models import tds as ttds  # noqa: E402

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


@pytest.mark.parametrize("shape", [(b, w, 1520) for b in (1, 2, 4)
                                   for w in (1, 2, 4)]
                         + [(1520,), (4000,), (3, 401), (2, 2, 1999)])
def test_fused_mfcc_kernel_matches_plain(cuda, shape):
    """(b, w) engine batches of 8 frames; a 1-D signal; ragged frame
    counts (1, 10, 23 frames)."""
    cfg = tcfg.FEATURE_CONFIG
    sig = _t(cuda, len(shape), *shape, scale=0.3)
    ops.reset_launch_counts()
    got = tfeat.mfcc(sig, cfg, use_logmel=True)
    torch.cuda.synchronize()
    assert ops.launch_counts()["logmel"] == 1
    want = tfeat.mfcc(sig, cfg)
    assert got.shape == want.shape == shape[:-1] + (
        tfeat.frames_producible(shape[-1], cfg), cfg.n_mfcc)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("cfg", [tcfg.FeatureConfig(n_mels=16, n_mfcc=16),
                                 tcfg.FeatureConfig(n_fft=1024, n_mels=40,
                                                    n_mfcc=13)])
def test_fused_mfcc_kernel_other_configs(cuda, cfg):
    sig = _t(cuda, 7, 3, 2001, scale=0.3)
    torch.testing.assert_close(tfeat.mfcc(sig, cfg, use_logmel=True),
                               tfeat.mfcc(sig, cfg), rtol=1e-4, atol=1e-3)


def test_fused_mfcc_one_launch_without_torch_fft(cuda, monkeypatch):
    cfg = tcfg.FEATURE_CONFIG
    sig = _t(cuda, 3, 4, 4, 1520, scale=0.3)
    want = tfeat.mfcc(sig, cfg)

    def no_fft(*a, **k):
        raise AssertionError("torch.fft.rfft called on the kernel path")
    monkeypatch.setattr(torch.fft, "rfft", no_fft)
    ops.reset_launch_counts()
    got = tfeat.mfcc(sig, cfg, use_logmel=True)
    torch.cuda.synchronize()
    assert ops.launch_counts() == {**{k: 0 for k in ops.KERNEL_MODULES},
                                   "logmel": 1}
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-3)
    tables = tfeat._tables(cfg, cuda)
    with pytest.raises(ValueError):
        tlm.mfcc(sig[..., :399].contiguous(), cfg, tables)   # no frame
    with pytest.raises(ValueError):
        tlm.mfcc(sig.transpose(0, 1), cfg, tables)           # not contiguous
    with pytest.raises(ValueError):
        tlm.mfcc(sig.double(), cfg, tables)                  # not f32
    with pytest.raises(ValueError):
        tlm.mfcc(sig, cfg, tables._replace(bands=tables.bands[:4]))
    assert ops.launch_counts()["logmel"] == 1


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


def _step_shapes(b, w):
    """Conv shapes (batch, k, stride, T, W, Cin, Cout, residual, fused)
    and LayerNorm shapes (rows, D) of one full-width decoding step of
    b slots and w windows (8 feature frames a window); `fused`: the
    conv's LayerNorm runs in its launch."""
    cfg = tcfg.TDS_CONFIG
    feat = cfg.stages[0].feat
    specs = ttds.build_kernel_specs(cfg)
    convs, lns, t = [], [], 8 * w
    for i, spec in enumerate(specs):
        if spec.kind == "conv":
            cin, cout = spec.n_in // spec.kernel, spec.n_out // feat
            convs.append((b, spec.kernel, spec.stride, t, feat, cin, cout,
                          spec.residual and spec.stride == 1 and cin == cout,
                          specs[i + 1].kind == "layernorm"))
        elif spec.kind == "layernorm":
            lns.append((b * (t // spec.stride), spec.n_out))
        t //= spec.stride
    return sorted(set(convs)), sorted(set(lns))


STEP_CONVS = _step_shapes(4, 4)[0] + _step_shapes(1, 1)[0]
STEP_LNS = _step_shapes(4, 4)[1] + _step_shapes(1, 1)[1]


def _conv_ln_inputs(dev, batch, k, stride, t, w, cin, cout, residual):
    x = _t(dev, k + cin, batch, k - 1 + t, w, cin)
    wgt = _t(dev, 1, k, cin, cout, scale=0.3)
    b = _t(dev, 2, cout)
    res = _t(dev, 3, batch, t // stride, w, cout) if residual else None
    scale = 1 + _t(dev, 4, w * cout, scale=0.2)
    return x, wgt, b, res, scale, _t(dev, 5, w * cout)


@pytest.mark.parametrize("batch,k,stride,t,w,cin,cout,residual,fused",
                         STEP_CONVS)
def test_tds_conv_kernels_match_plain_at_step_shapes(cuda, batch, k, stride,
                                                     t, w, cin, cout,
                                                     residual, fused):
    """Every conv of a b=4, w=4 and a b=1, w=1 step: the plain conv
    (front_conv) and the conv + LayerNorm in both designs (split 0: a
    cluster per row; split 1: one block of 512 threads per row)."""
    x, wgt, b, res, scale, shift = _conv_ln_inputs(cuda, batch, k, stride, t,
                                                   w, cin, cout, residual)
    y = ref.tds_conv_fused(x, wgt, b, stride=stride, relu=True, res=res)
    got = ttc.tds_conv(x, wgt, b, res, stride=stride, relu=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, y, rtol=1e-5, atol=1e-5)
    if fused:
        want = ref.tds_conv_ln(x, wgt, b, scale, shift, stride=stride,
                               relu=True, res=res)
        for split in (0, 1):
            got = ttc.tds_conv_ln(x, wgt, b, scale, shift, res, stride=stride,
                                  relu=True, split=split)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("batch,k,stride,t,w,cin,cout,residual,split", [
    (2, 9, 1, 4, 13, 7, 7, True, 0),       # W*Cin odd: 4-byte staging
    (2, 9, 1, 4, 13, 7, 7, True, 8),       # 13 positions over 8 blocks
    (1, 10, 2, 2, 12, 5, 7, False, 8),     # blocks 6 and 7 hold nothing
    (1, 9, 1, 1, 81, 23, 23, True, 0),     # W = 81 over a cluster of 8
    (3, 9, 1, 4, 81, 23, 23, True, 3),
    (2, 10, 2, 4, 80, 15, 19, False, 5),
    (1, 9, 1, 2, 80, 3, 3, True, 7),
    (200, 9, 1, 1, 80, 15, 15, True, 0),   # 200 rows: a block per row
    (1, 21, 1, 8, 8, 3, 3, False, 0), (2, 9, 2, 8, 16, 1, 15, False, 0),
    (70, 9, 1, 1, 200, 24, 24, True, 0),   # the split grows until it fits
])
def test_tds_conv_ln_kernel_matches_plain_ragged(cuda, batch, k, stride, t,
                                                 w, cin, cout, residual,
                                                 split):
    x, wgt, b, res, scale, shift = _conv_ln_inputs(cuda, batch, k, stride, t,
                                                   w, cin, cout, residual)
    for relu in (False, True):
        got = ttc.tds_conv_ln(x, wgt, b, scale, shift, res, stride=stride,
                              relu=relu, split=split)
        torch.cuda.synchronize()
        want = ref.tds_conv_ln(x, wgt, b, scale, shift, stride=stride,
                               relu=relu, res=res)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def _aligned_or_not(dev, seed, r, d, misaligned):
    """(r, d) values, contiguous; `misaligned` puts row 0 4 bytes past a
    16-byte boundary (the scalar kernel)."""
    if not misaligned:
        return _t(dev, seed, r, d)
    buf = torch.empty(r * d + 1, device=dev)
    out = buf[1:].view(r, d)
    out.copy_(_t(dev, seed, r, d))
    return out


@pytest.mark.parametrize("r,d,misaligned", [*[(r, d, False)
                                               for r, d in STEP_LNS],
                                             (37, 80, False), (5, 129, False),
                                             (3, 7, False), (16, 1840, True),
                                             (4, 2560, False),
                                             (2, 8192, False),
                                             (2, 8196, False)])
def test_bias_residual_layernorm_kernel_matches_plain(cuda, r, d,
                                                      misaligned):
    """Every LayerNorm shape of a b=4, w=4 and a b=1, w=1 step with and
    without each addend, ragged D and a misaligned row (scalar kernel),
    and D past one and two vectors a thread."""
    y = _aligned_or_not(cuda, d, r, d, misaligned)
    res = _aligned_or_not(cuda, d + 1, r, d, misaligned)
    ab = _t(cuda, 3, d)
    scale, shift = 1 + _t(cuda, 1, d, scale=0.2), _t(cuda, 2, d)
    for add_bias, rr in ((ab, res), (ab, None), (None, res), (None, None)):
        got = tln.bias_residual_layernorm(y, scale, shift, add_bias=add_bias,
                                          res=rr)
        torch.cuda.synchronize()
        want = ref.bias_residual_layernorm(y, scale, shift,
                                           add_bias=add_bias, res=rr)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(tln.layernorm(y, scale, shift),
                               ref.layernorm(y, scale, shift),
                               rtol=1e-5, atol=1e-5)


def test_fused_wrappers_count_launches_and_refuse_bad_input(cuda):
    ops.reset_launch_counts()
    x, wgt, b, res, scale, shift = _conv_ln_inputs(cuda, 2, 9, 1, 4, 16, 5,
                                                   5, True)
    ttc.tds_conv_ln(x, wgt, b, scale, shift, res, relu=True)
    ops.tds_conv_ln(x, wgt, b, scale, shift, res=res, relu=True)
    assert ops.launch_counts()["tds_conv"] == 2
    xt = x.transpose(1, 2).contiguous().transpose(1, 2)
    for bad in (dict(x=xt), dict(scale=scale.cpu()), dict(res=res.cpu()),
                dict(scale=scale[:-1].contiguous()),
                dict(wgt=_t(cuda, 6, 9, 5, 25), b=_t(cuda, 6, 25))):
        a = dict(x=x, wgt=wgt, b=b, scale=scale, res=res)
        a.update(bad)                          # the last: Cout > 24
        with pytest.raises(ValueError):
            ttc.tds_conv_ln(a["x"], a["wgt"], a["b"], a["scale"], shift,
                            a["res"], relu=True)
    assert ops.launch_counts()["tds_conv"] == 2
    y, ab = _t(cuda, 7, 8, 64), _t(cuda, 8, 64)
    s64, r = _t(cuda, 9, 64), _t(cuda, 10, 8, 64)
    tln.bias_residual_layernorm(y, s64, s64, add_bias=ab, res=r)
    ops.bias_residual_layernorm(y, s64, s64, add_bias=ab, res=r.t().t())
    assert ops.launch_counts()["layernorm"] == 2
    for bad in (dict(y=_t(cuda, 11, 64, 8).t()), dict(ab=ab.cpu()),
                dict(r=r.cpu()), dict(r=r[:4].contiguous()),
                dict(ab=_t(cuda, 12, 63))):
        a = dict(y=y, ab=ab, r=r)
        a.update(bad)
        with pytest.raises(ValueError):
            tln.bias_residual_layernorm(a["y"], s64, s64, add_bias=a["ab"],
                                        res=a["r"])
    assert ops.launch_counts()["layernorm"] == 2


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


def _decoder_like(dev, case):
    """(hashes, pb, pnb, k, beam) of 4 rows of N = 8320 shaped like the
    decoder's worst cases for the kernel (numpy, fixed seed)."""
    r = np.random.RandomState(len(case))
    b, n, k, beam = 4, 8320, 128, 25.0
    h = r.randint(0, 2**31 - 1, (b, n)).astype(np.int32)
    pb = (r.randn(b, n) * 3 - 20).astype(np.float32)
    pnb = (r.randn(b, n) * 3 - 20).astype(np.float32)
    dead = r.rand(b, n) < 0.5
    if case == "dead95_long_segments":         # segments of ~50 candidates
        dead = r.rand(b, n) < 0.95
        h = r.randint(0, 8, (b, n)).astype(np.int32) * 7919
    elif case == "one_segment":                # every live candidate merges
        h[:] = 12345
    elif case == "all_tied":                   # every head has the same tot
        pb[:], pnb[:] = -3.0, -4.0
    elif case == "fewer_heads_than_k":         # 40 live, 25 distinct hashes
        dead = np.ones((b, n), bool)
        for i in range(b):
            dead[i, r.choice(n, 40, replace=False)] = False
        h = r.randint(0, 25, (b, n)).astype(np.int32)
    elif case == "beam_keeps_one":             # one head far above the rest
        pb[:, 777] = 40.0
        dead[:, 777] = False
        beam = 0.5
    elif case == "nan_inf":                    # NaN / +-inf channels
        for v, frac in ((np.nan, 0.01), (np.inf, 0.002), (-np.inf, 0.05)):
            for arr in (pb, pnb):
                arr[r.rand(b, n) < frac] = v
        pb[:, :4] = -np.inf                      # both channels -inf: dead
        pnb[:, :4] = -np.inf
    pb = np.where(dead, NEG_INF, pb).astype(np.float32)
    pnb = np.where(dead, NEG_INF, pnb).astype(np.float32)
    return (torch.from_numpy(h).to(dev), torch.from_numpy(pb).to(dev),
            torch.from_numpy(pnb).to(dev), k, beam)


@pytest.mark.parametrize("case", ["dead95_long_segments", "one_segment",
                                  "all_tied", "fewer_heads_than_k",
                                  "beam_keeps_one", "nan_inf"])
def test_hypothesis_unit_kernel_matches_plain_on_decoder_like_rows(cuda,
                                                                  case):
    h, pb, pnb, k, beam = _decoder_like(cuda, case)
    got = thu.hypothesis_unit(h, pb, pnb, k=k, beam=beam)
    torch.cuda.synchronize()
    want = ref.hypothesis_unit(h, pb, pnb, k=k, beam=beam)
    assert torch.equal(got["idx"], want["idx"])
    assert torch.equal(got["valid"], want["valid"])
    for key in ("pb", "pnb"):
        torch.testing.assert_close(got[key], want[key], rtol=1e-5, atol=0)
    if case == "beam_keeps_one":
        assert int(got["valid"].sum()) == 4
    if case == "fewer_heads_than_k":
        assert 0 < int(got["valid"].sum(1).max()) < k


INT8_CARD_SHAPES = [
    (64, 1200, 1200), (32, 1520, 1520), (16, 1840, 1840), (16, 1840, 9000),
    (8, 128, 128), (100, 200, 96), (1, 1200, 600), (5, 37, 29),
    (33, 2100, 70), (17, 4100, 3),
    # the b=1, w=1 step's rows: the GEMV end
    (4, 1200, 1200), (2, 1520, 1520), (1, 1840, 1840), (1, 1840, 9000)]


@pytest.mark.parametrize("m,k,n", INT8_CARD_SHAPES)
def test_int8_matmul_kernel_matches_plain(cuda, m, k, n):
    """Main-path shapes at b=4, w=4 and b=1, w=1, the CPU sweep, and
    ragged M, K and N (K not a multiple of 16 or 64, K over 4096): the
    pre-quantized product and the fused quantize + product, each bitwise
    the plain path's."""
    x, w = _t(cuda, m, m, k), _t(cuda, n, k, n)
    wq, ws = ops.prepare_int8_weights(w)
    xq, xs = ops.quantize_rows(x)
    got = tim.int8_matmul(xq, wq, xs, ws)
    torch.cuda.synchronize()
    want = ref.int8_matmul(xq, wq, xs, ws)
    assert torch.equal(got, want)
    # a row-major (K, N) weight is copied into the kernel's layout
    assert torch.equal(tim.int8_matmul(xq, wq.contiguous(), xs, ws), got)
    assert torch.equal(tim.int8_matmul_fused(x, wq, ws), want)
    assert torch.equal(ops.int8_matmul_prepared(x, wq, ws), want)


def test_quantize_rows_on_the_card_equals_the_cpu_bitwise(cuda):
    """The plain per-row scale is a true division on the card as on the
    CPU (and in the reference): torch's `tensor / 127.0` on a CUDA tensor
    multiplies by the reciprocal and rounds some rows differently."""
    x = _t(cuda, 3, 4096, 64, scale=3.0)
    q, s = ops.quantize_rows(x)
    qc, sc = ops.quantize_rows(x.cpu())
    assert torch.equal(s.cpu(), sc) and torch.equal(q.cpu(), qc)


def test_int8_matmul_kernel_exact_at_full_scale(cuda):
    """|acc| = 127^2 * 1840 > 2^24 stays exact, in one block and with K
    split over a cluster of 8 (int32 partial sums exchanged)."""
    xq = torch.full((16, 1840), 127, dtype=torch.int8, device=cuda)
    wq = torch.full((1840, 40), -127, dtype=torch.int8, device=cuda)
    xs = torch.ones(16, device=cuda)
    ws = torch.ones(40, device=cuda)
    want = ref.int8_matmul(xq, wq, xs, ws)
    for p in (tim.Plan(4, 1, 29), tim.Plan(4, 8, 4),
              tim.plan(16, 1840, 40)):
        got = tim.int8_matmul(xq, wq, xs, ws, plan=p)
        torch.cuda.synchronize()
        assert torch.equal(got, want), p
        assert float(got[0, 0]) == float(np.float32(-127 * 127 * 1840))
    x = torch.full((16, 1840), 3.0, device=cuda)
    assert torch.equal(tim.int8_matmul_fused(x, wq, ws,
                                             plan=tim.Plan(4, 8, 4)),
                       ref.int8_matmul_prepared(x, wq, ws))


@pytest.mark.parametrize("m,k,n", [(16, 1840, 1840), (64, 1200, 1200),
                                   (5, 37, 29), (33, 2100, 70)])
def test_int8_matmul_every_plan_shape_is_bitwise(cuda, m, k, n):
    """Column tiles and cluster sizes other than the planner's choice
    give the same bits (integer sums are exact)."""
    x, w = _t(cuda, m + 1, m, k), _t(cuda, n + 1, k, n)
    wq, ws = ops.prepare_int8_weights(w)
    want = ref.int8_matmul_prepared(x, wq, ws)
    xq, xs = ops.quantize_rows(x)
    nch = -(-k // tim.CHUNK)
    for nt in (2, 4):
        for split in (1, 2, 3, 5, 8):
            cps = -(-nch // split)
            if split > 1 and -(-nch // cps) != split:
                continue
            p = tim.Plan(nt, split, cps)
            if tim.smem_bytes(p) > tim.MAX_SMEM:
                continue
            assert torch.equal(tim.int8_matmul_fused(x, wq, ws, plan=p),
                               want), p
            assert torch.equal(tim.int8_matmul(xq, wq, xs, ws, plan=p),
                               want), p
    torch.cuda.synchronize()


def _half_way_rows(dev, m, k):
    """Rows whose values sit exactly half-way between two int8 steps
    (x = (n + 0.5) * s, s = max|x| / 127), all-zero rows (s = 0, the
    divisor clamped to 1e-12) and a row of random values."""
    r = np.random.RandomState(m * k)
    x = np.zeros((m, k), np.float32)
    for i in range(m):
        if i % 3 == 1:
            continue                                  # all zero
        s = np.float32(2.0 ** r.randint(-3, 4))
        n = r.randint(-127, 127, k).astype(np.float32)
        x[i] = (n + np.float32(0.5)) * s
        x[i, r.randint(k)] = np.float32(127.0) * s    # max |x| = 127 s
        if i % 3 == 2:
            x[i] = r.randn(k).astype(np.float32)
    return torch.from_numpy(x).to(dev)


@pytest.mark.parametrize("m,k", [(16, 1840), (64, 1200), (7, 37), (3, 4100)])
def test_int8_fused_quantization_matches_plain_bitwise(cuda, m, k):
    """The fused product's in-launch quantization against
    `ops.quantize_rows` at half-way values (rounded half to even, where
    the kernel's product with the reciprocal must fall back to the
    division) and zero rows, with K whole in one block and split."""
    x = _half_way_rows(cuda, m, k)
    wq, ws = ops.prepare_int8_weights(_t(cuda, k, k, 96))
    q, s = ops.quantize_rows(x)
    want = ref.int8_matmul(q, wq, s, ws)
    whole = tim.Plan(2, 1, -(-k // tim.CHUNK))      # K in one block
    for p in [tim.plan(m, k, 96)] + [whole] * (tim.smem_bytes(whole)
                                               <= tim.MAX_SMEM):
        got = tim.int8_matmul_fused(x, wq, ws, plan=p)
        torch.cuda.synchronize()
        assert torch.equal(got, want), p


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
    with pytest.raises(ValueError):                           # K uncovered
        tim.int8_matmul(xq, wq, xs, ws, plan=tim.Plan(2, 1, 0))
    assert ops.launch_counts()["int8_matmul"] == 1
    ops.int8_matmul_prepared(x, wq, ws)         # fused: one launch
    with pytest.raises(ValueError):
        tim.int8_matmul_fused(xq, wq, ws)                     # not f32
    with pytest.raises(ValueError):
        tim.int8_matmul_fused(x.t(), wq[:4], ws)              # not contiguous
    assert ops.launch_counts()["int8_matmul"] == 2
    s = _t(cuda, 4, 1000, scale=10.0)
    tbp.beam_prune(s, 5.0)
    for bad in (s.reshape(10, 100), s.to(torch.bfloat16), s[::2],
                s[:0]):                  # 2-D, bf16, not contiguous, empty
        with pytest.raises(ValueError):
            tbp.beam_prune(bad, 5.0)
    assert ops.launch_counts()["beam_prune"] == 1
    tbp.beam_prune(_t(cuda, 5, 65537), 5.0)     # the grid path: one launch
    assert ops.launch_counts()["beam_prune"] == 2


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


@pytest.mark.parametrize("n", [65537, 4_194_307])
def test_beam_prune_one_launch_at_every_n(cuda, n):
    s = _prune_input(cuda, n, "random", 25.0)
    ops.reset_launch_counts()
    for _ in range(3):         # the barrier's scratch is left ready
        got = tbp.beam_prune(s, 25.0)
    torch.cuda.synchronize()
    assert ops.launch_counts()["beam_prune"] == 3
    assert torch.equal(got.view(torch.int32),
                       ref.beam_prune(s, 25.0).view(torch.int32))


@pytest.mark.parametrize("offset", [-4, -1, 0, 1, 4097])
@pytest.mark.parametrize("case", ["random", "nan", "pos_inf"])
def test_beam_prune_bitwise_around_the_shared_memory_capacity(cuda, offset,
                                                              case):
    """N just below, at and above the scores the grid path stages in
    shared memory (above it each block re-reads its slice's tail)."""
    n = tbp.capacity(cuda) + offset
    s = _prune_input(cuda, n, case, 5.0)
    for x in (s, torch.cat([s[:1], s])[1:]):    # aligned; 16-byte unaligned
        got = tbp.beam_prune(x, 5.0)
        torch.cuda.synchronize()
        assert torch.equal(got.view(torch.int32),
                           ref.beam_prune(x, 5.0).view(torch.int32))


_TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
        torch.bfloat16: dict(rtol=1e-2, atol=1e-2)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,d", [(4, 2560), (512, 2560), (37, 80), (5, 64),
                                 (300, 129), (1, 7),
                                 (1, 2560), (3, 2560), (4096, 2560),
                                 (1, 2568), (3, 2568), (4096, 2568),
                                 (1, 2048), (4, 2048), (2048, 2048),
                                 (8192, 2048), (1, 4096), (4, 4096),
                                 (2048, 4096), (6144, 4096)])
def test_rmsnorm_kernel_matches_plain(cuda, t, d, dtype):
    """The LM's shapes (decode rows, prefill rows at D = 2560), ragged
    ones (the scalar kernel), and the vector kernel at D = 2560 and at
    D = 2568, 16-byte aligned but not a multiple of 256 vectors, from
    one row to 4096.  D = 2048 (mamba2-1.3b's and qwen2-moe-a2.7b's
    model width) and D = 4096 (mamba2's gated norm over d_inner: two
    16-byte vectors a thread in bf16, four in fp32), at decode and
    prefill rows."""
    x = _t(cuda, d, t, d).to(dtype)
    s = 1 + 0.1 * _t(cuda, 1, d)
    got = tln.rmsnorm(x, s)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    torch.testing.assert_close(got, ref.rmsnorm(x, s), **_TOL[dtype])


@pytest.mark.parametrize("t,d,misaligned", [
    (1, 1536, False), (4, 1536, False), (512, 1536, False),
    (2048, 1536, False), (8192, 1536, False), (3, 4096, False),
    (2, 8192, False), (37, 80, False), (16, 1536, True), (5, 100, False),
    (7, 1540, False), (2, 8200, False)])
def test_layernorm_kernel_matches_plain_bf16(cuda, t, d, misaligned):
    """bf16 rows (the LM's LayerNorm, musicgen-medium's D = 1536, from a
    decode row to 8192 prefill rows; one and two 16-byte vectors a thread
    up to 8192 values), fp32 scale and bias, the LM's eps: within one
    bf16 ulp of the plain version (fp32 statistics, one rounding).  A row
    2 bytes past a 16-byte boundary, D no multiple of 8 (100, 1540) and D
    past 8192 take the scalar kernel."""
    x = _t(cuda, d, t, d, scale=3.0).to(torch.bfloat16)
    if misaligned:
        buf = torch.empty(t * d + 1, dtype=torch.bfloat16, device=cuda)
        buf[1:].view(t, d).copy_(x)
        x = buf[1:].view(t, d)
    s, b = 1 + 0.1 * _t(cuda, 1, d), 0.1 * _t(cuda, 2, d)
    ops.reset_launch_counts()
    got = tln.layernorm(x, s, b, eps=1e-6)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and ops.launch_counts()["layernorm"] == 1
    torch.testing.assert_close(got, ref.layernorm(x, s, b, eps=1e-6),
                               **_TOL[torch.bfloat16])


def test_lm_layernorm_launches_once_per_norm_and_stays_fp32_for_tds(cuda):
    """`apply_norm(kind="layernorm")` on bf16 activations: one layernorm
    launch per call, none of rmsnorm; `bias_residual_layernorm` (the TDS
    model's, with its addends) refuses bf16 rows."""
    from repro_torch.models import layers as tlayers
    x = _t(cuda, 4, 2, 9, 1536).to(torch.bfloat16)
    p = {"scale": 1 + 0.1 * _t(cuda, 5, 1536), "bias": _t(cuda, 6, 1536)}
    ops.reset_launch_counts()
    for _ in range(3):
        y = tlayers.apply_norm(p, x, "layernorm")
    torch.cuda.synchronize()
    assert ops.launch_counts()["layernorm"] == 3
    assert ops.launch_counts()["rmsnorm"] == 0
    want = ref.layernorm(x.reshape(-1, 1536), p["scale"], p["bias"], eps=1e-6)
    torch.testing.assert_close(y.reshape(-1, 1536), want,
                               **_TOL[torch.bfloat16])
    with pytest.raises(ValueError):
        tln.bias_residual_layernorm(x.reshape(-1, 1536), p["scale"],
                                    p["bias"], res=x.reshape(-1, 1536))
    with pytest.raises(ValueError):
        tln.layernorm(x.reshape(-1, 1536).half(), p["scale"], p["bias"])
    assert ops.launch_counts()["layernorm"] == 3


def test_quantize_linear_on_the_card_equals_the_cpu_bitwise(cuda):
    """int8 LM serving weights quantized on the card: `wq` and `wscale`
    bit for bit the CPU's (and so the reference's), 2-D and stacked 3-D.
    The scale divides by a tensor: `amax / 127.0` on a CUDA tensor is a
    product with the reciprocal, an ulp off in some channels."""
    from repro_torch.models import layers as tlayers
    for shape in ((256, 4096), (2, 512, 2048)):
        w = _t(cuda, 7, *shape, scale=0.05).to(torch.bfloat16)
        tree = {"l": {"w": w, "b": _t(cuda, 8, shape[-1])}}
        got = tlayers.quantize_params_for_serving(tree)["l"]
        want = tlayers.quantize_params_for_serving(
            {"l": {k: v.cpu() for k, v in tree["l"].items()}})["l"]
        assert got["wq"].dtype == torch.int8 and got["wq"].is_cuda
        assert torch.equal(got["wq"].cpu(), want["wq"])
        assert torch.equal(got["wscale"].cpu(), want["wscale"])
        assert got["b"] is tree["l"]["b"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,kv,sq,skv,d,causal,window,qscale", [
    (2, 3, 3, 64, 64, 32, True, None, 1.0),
    (2, 3, 3, 64, 128, 32, True, None, 1.0),
    (2, 3, 3, 32, 128, 32, False, None, 1.0),
    (2, 3, 3, 128, 128, 32, True, 48, 1.0),
    (2, 3, 3, 64, 256, 32, True, 17, 1.0),
    (1, 32, 8, 300, 300, 80, True, 100, 1.0),  # GQA 32/8, D = 80, ragged S
    (2, 32, 8, 77, 200, 80, True, 64, 1.0),    # Sq < Skv, window < S
    (1, 32, 8, 513, 513, 80, True, None, 1.0),
    (3, 4, 4, 100, 100, 128, False, 30, 1.0),
    (2, 8, 2, 40, 40, 16, True, None, 1.0), (1, 4, 1, 33, 33, 40, True, None, 1.0),
    # D = 64 / 80 / 128 at S a multiple of neither 64 nor 128, with enough
    # q tiles for two consumer warpgroups per block
    (1, 32, 8, 1100, 1100, 64, True, None, 1.0),
    (1, 32, 8, 1100, 1100, 80, True, 700, 1.0),
    (1, 32, 8, 1100, 1100, 128, True, None, 1.0),
    (1, 8, 2, 201, 201, 24, True, None, 1.0),   # depth padded to 32
    (1, 32, 8, 1100, 1100, 80, True, None, 8.0),  # peaky: max moves late
    (1, 8, 8, 333, 333, 80, True, None, 8.0),
    (2, 8, 8, 300, 120, 80, True, None, 1.0),   # Sq > Skv: masked rows
    (1, 8, 8, 1000, 130, 64, True, 50, 1.0),
    (1, 8, 8, 257, 257, 80, True, None, 1.0),   # GQA ratio 1
    (1, 8, 2, 257, 257, 80, True, None, 1.0),   # 4
    (1, 8, 1, 257, 257, 80, True, None, 1.0),   # 8
    (1, 8, 2, 300, 300, 80, True, 1, 1.0),      # window 1
    (1, 8, 2, 640, 640, 80, True, 128, 1.0),    # window edges on tiles
    (1, 32, 8, 1280, 1280, 80, True, 256, 1.0),
    # qwen2-moe-a2.7b's prefill: MHA 16/16 at D = 128, causal, no window
    (1, 16, 16, 512, 512, 128, True, None, 1.0),
    (1, 16, 16, 2048, 2048, 128, True, None, 1.0),
    (2, 16, 16, 2048, 2048, 128, True, None, 1.0),
    (1, 16, 16, 300, 300, 128, True, None, 8.0),
])
def test_flash_attention_kernel_matches_plain(cuda, b, h, kv, sq, skv, d,
                                              causal, window, qscale, dtype):
    """Rows that see no key (Sq > Skv, causal) output 0 in the kernel, as
    in the TPU kernel; the plain version averages there, so those rows
    are held to 0 and the rest to the plain version."""
    q = _t(cuda, 1, b, h, sq, d, scale=qscale).to(dtype)
    k = _t(cuda, 2, b, kv, skv, d).to(dtype)
    v = _t(cuda, 3, b, kv, skv, d).to(dtype)
    got = tfa.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    want = ref.flash_attention(q, k, v, causal=causal, window=window)
    blind = max(sq - skv, 0) if causal else 0   # rows before the first key
    assert torch.equal(got[:, :, :blind], torch.zeros_like(got[:, :, :blind]))
    torch.testing.assert_close(got[:, :, blind:], want[:, :, blind:],
                               **_TOL[dtype])


@pytest.mark.parametrize("d", [64, 80, 128])
@pytest.mark.parametrize("b,h,kv,sq,skv,causal,window,qscale,late", [
    (1, 28, 4, 1100, 1100, True, None, 1.0, False),  # GQA 7, ragged S
    (2, 28, 4, 300, 300, True, None, 8.0, False),    # B = 2, peaky
    (1, 8, 8, 300, 1100, True, None, 1.0, False),    # Sq < Skv
    (2, 8, 2, 1100, 300, True, None, 1.0, False),    # Sq > Skv: blind rows
    (1, 8, 2, 1100, 1100, True, 1, 1.0, False),      # window 1
    (1, 8, 2, 1100, 1100, True, 128, 1.0, False),    # windows on tile edges
    (1, 8, 2, 1100, 1100, True, 256, 1.0, True),
    (3, 4, 4, 100, 100, False, 30, 1.0, False),      # a window, not causal
    (1, 4, 4, 300, 300, True, None, 1.0, False),     # 12 q tiles, < 132
    (2, 28, 4, 2048, 2048, True, None, 1.0, False),  # 896 q tiles, >> 132
    (1, 32, 8, 1100, 1100, True, None, 8.0, True),   # the max moves late
    (1, 32, 8, 1100, 1100, True, 700, 1.0, True),    # h2o-danube's heads
    (1, 4, 4, 200, 0, True, None, 1.0, False),       # no key at all
])
def test_flash_attention_tma_design_edges(cuda, d, b, h, kv, sq, skv, causal,
                                          window, qscale, late):
    """The bf16 design at D = 64, 80 and 128 (TMA tiles, a persistent grid
    of one block an SM; at D = 80 a 16-column tail in the 32-byte
    swizzle): against the plain version at the bf16 tolerance, rows that
    see no key exactly 0.  `late`: the last 37 keys are scaled by 4, so
    each row's max arrives in its last kv tile.  At D = 80 the GQA 32/8
    case with window 700 is h2o-danube-1.8b's heads."""
    dt = torch.bfloat16
    q = _t(cuda, 1, b, h, sq, d, scale=qscale).to(dt)
    k = _t(cuda, 2, b, kv, skv, d)
    if late:
        k[:, :, -37:] *= 4
    k, v = k.to(dt), _t(cuda, 3, b, kv, skv, d).to(dt)
    assert tfa.design(d, dt) == "bf16 tma"
    got = tfa.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert got.dtype == dt and got.shape == q.shape
    want = ref.flash_attention(q, k, v, causal=causal, window=window)
    blind = max(sq - skv, 0) if causal else 0
    assert torch.equal(got[:, :, :blind], torch.zeros_like(got[:, :, :blind]))
    torch.testing.assert_close(got[:, :, blind:], want[:, :, blind:],
                               **_TOL[dt])


@pytest.mark.parametrize("d", [64, 80, 128])
def test_flash_attention_tma_design_launches_once_or_raises(cuda, d):
    """A bf16 call at D = 64 / 80 / 128 is one launch of the TMA design and
    of no other (as the C library records the kernel it launched); a call
    whose tensor maps cannot be encoded (q 2 bytes past a 16-byte
    boundary, which only the C entry point can be handed: the wrapper
    refuses it first) returns the error and launches nothing in its
    place, and `_build.check` raises it."""
    from repro_torch.kernels import _build
    dt = torch.bfloat16
    q = _t(cuda, 1, 1, 4, 300, d).to(dt)
    k, v = _t(cuda, 2, 1, 4, 300, d).to(dt), _t(cuda, 3, 1, 4, 300, d).to(dt)
    assert (tfa.design(d, dt), tfa.design(96, dt),
            tfa.design(d, torch.float32)) == ("bf16 tma", "bf16 cp.async",
                                              "fp32")
    ops.reset_launch_counts()
    before = dict(tfa.launches_by_design)
    tfa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == 1
    assert {n: tfa.launches_by_design[n] - before[n]
            for n in tfa.DESIGNS} == {"fp32": 0, "bf16 cp.async": 0,
                                      "bf16 tma": 1}
    buf = torch.empty(q.numel() + 8, dtype=dt, device=cuda)
    qm = buf[1:1 + q.numel()].view(q.shape)
    qm.copy_(q)
    out = torch.full_like(q, float("nan"))
    torch.cuda.synchronize()
    err = _build.lib().flash_attention_launch(
        qm.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), 1, 4, 4,
        300, 300, d, 1, 0, 1, 1.0 / d ** 0.5, _build.stream(cuda))
    assert err != 0 and _build.lib().flash_attention_ran() == -1
    with pytest.raises(RuntimeError):
        _build.check(err, "flash_attention")
    torch.cuda.synchronize()
    assert torch.isnan(out).all()
    with pytest.raises(ValueError):
        tfa.flash_attention(qm, k, v)
    assert ops.launch_counts()["flash_attention"] == 1


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


# ---------------------------------------------------------------------------
# the gradient guard: a kernel has no backward, so a wrapper given a
# tensor that requires grad (grad mode on) raises before it launches
# ---------------------------------------------------------------------------
def _guard_cases(dev):
    """{wrapper: (module, call taking the tensor that requires grad)}:
    every CUDA wrapper, with one float argument requiring grad."""
    cfg = tcfg.FeatureConfig()
    tables = tfeat._tables(cfg, dev)
    x4 = _t(dev, 1, 2, 6, 8, 3)
    w3, b3 = _t(dev, 2, 3, 3, 4), _t(dev, 3, 4)
    ln = _t(dev, 4, 32)
    y = _t(dev, 5, 4, 32)
    wq = torch.randint(-127, 128, (32, 16), dtype=torch.int8, device=dev)
    xq = torch.randint(-127, 128, (4, 32), dtype=torch.int8, device=dev)
    s4, s16 = _t(dev, 6, 4).abs(), _t(dev, 7, 16).abs()
    hashes = torch.randint(0, 2 ** 31 - 1, (2, 64), dtype=torch.int32,
                           device=dev)
    q = _t(dev, 8, 1, 4, 16, 64)
    return {
        "tds_conv": (ttc, lambda g: ttc.tds_conv(x4, g(w3), b3)),
        "tds_conv_ln": (ttc, lambda g: ttc.tds_conv_ln(
            x4, w3, b3, g(_t(dev, 9, 32)), _t(dev, 10, 32))),
        "layernorm": (tln, lambda g: tln.layernorm(y, g(ln), ln)),
        "bias_residual_layernorm": (tln, lambda g: tln.bias_residual_layernorm(
            y, ln, ln, add_bias=g(ln), res=y)),
        "rmsnorm": ("rmsnorm", lambda g: tln.rmsnorm(g(y), ln)),
        "logmel": (tlm, lambda g: tlm.logmel(
            g(_t(dev, 11, 8, 257).abs()), tables.fb, tables.dct)),
        "mfcc": (tlm, lambda g: tlm.mfcc(g(_t(dev, 12, 2, 1520)), cfg,
                                         tables)),
        "int8_matmul": (tim, lambda g: tim.int8_matmul(xq, wq, g(s4), s16)),
        "int8_matmul_fused": (tim, lambda g: tim.int8_matmul_fused(
            g(_t(dev, 13, 4, 32)), wq, s16)),
        "hypothesis_unit": (thu, lambda g: thu.hypothesis_unit(
            hashes, g(_t(dev, 14, 2, 64)), _t(dev, 15, 2, 64), k=8,
            beam=10.0)),
        "flash_attention": (tfa, lambda g: tfa.flash_attention(
            g(q), q, q)),
        "beam_prune": (tbp, lambda g: tbp.beam_prune(
            g(_t(dev, 16, 1000)), 5.0)),
    }


GUARDED = ("tds_conv", "tds_conv_ln", "layernorm", "bias_residual_layernorm",
           "rmsnorm", "logmel", "mfcc", "int8_matmul", "int8_matmul_fused",
           "hypothesis_unit", "flash_attention", "beam_prune")


@pytest.mark.parametrize("name", GUARDED)
def test_wrapper_refuses_a_tensor_that_requires_grad(cuda, name):
    mod, call = _guard_cases(cuda)[name]
    counter = "rmsnorm_launches" if mod == "rmsnorm" else "launches"
    mod = tln if mod == "rmsnorm" else mod
    before = getattr(mod, counter)
    with pytest.raises(RuntimeError, match=r"KernelPolicy\('ref'\) to train"):
        call(lambda t: t.clone().requires_grad_())
    assert getattr(mod, counter) == before            # nothing launched
    # the same call without a gradient to keep launches as before
    with torch.no_grad():
        call(lambda t: t.clone().requires_grad_())
    call(lambda t: t)
    torch.cuda.synchronize()
    assert getattr(mod, counter) == before + 2


def test_training_runs_the_plain_path_and_the_kernel_path_refuses(cuda):
    """The TDS training forward: `KernelPolicy("ref")` gives a gradient
    for every parameter on the card; the kernel path refuses."""
    from repro_torch.core.treeutil import value_and_grad
    from repro_torch.kernels.policy import KernelPolicy
    cfg = tcfg.TDSConfig(
        n_mfcc=16, stages=(tcfg.TDSStage(1, 3, 16, 5, 2),), sub_kernel=6,
        vocab_size=8)
    params = ttds.init_tds(torch.Generator().manual_seed(0), cfg,
                           device=cuda)
    feats = _t(cuda, 0, 2, 16, 16)
    st = ttds.init_batched_stream_state(cfg, 2, cuda)

    def loss(p, mode):
        lp, _ = ttds.forward_batched(p, cfg, feats, st,
                                     kernels=KernelPolicy(mode))
        return lp.mean()
    _, g = value_and_grad(lambda p: loss(p, "ref"), params)
    assert all(torch.isfinite(t).all() for v in g.values() for t in v.values())
    assert float(g["head"]["w"].abs().sum()) > 0
    with pytest.raises(RuntimeError, match="KernelPolicy"):
        value_and_grad(lambda p: loss(p, "kernel"), params)
