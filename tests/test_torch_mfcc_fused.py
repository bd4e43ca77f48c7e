"""The fused MFCC kernel's tables and algorithm, on the CPU.

`kernels/csrc/logmel.cu` (`mfcc_kernel`) runs the whole MFCC in one
launch from the tables `features._tables` makes: the Hamming window, the
FFT twiddles, the mel band table and the band weights.  The kernel
itself runs only on the card (tests/test_torch_cuda_kernels.py); here
the tables are held against numpy, and the kernel's algorithm
(bit-reversed radix-2 FFT of the frame packed as n_fft/2 complex points,
the split into the real spectrum, mel sums over each band's packed
weights) is replayed in numpy fp32 from those tables and held against
the plain MFCC.

Tolerances: the window, the band table and its weights exactly; the
twiddles within one fp32 rounding of exp(-2*pi*i*k/n) (|err| <= 2^-24
per component); the replayed MFCC rtol 1e-4, atol 1e-3, the tolerance
of the kernel against the plain version on the card (two FFT
algorithms, then a log domain).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.tds_asr import FeatureConfig  # noqa: E402
from repro_torch.core import features  # noqa: E402
from repro_torch.kernels import logmel as klm, ops, ref  # noqa: E402

torch.set_num_threads(1)
f32 = np.float32
CONFIGS = [FeatureConfig(), FeatureConfig(n_mels=16, n_mfcc=16),
           FeatureConfig(n_fft=1024, n_mels=40, n_mfcc=13)]


@pytest.mark.parametrize("n_fft", [4, 16, 256, 512, 1024, 4096])
def test_twiddles_are_exp_rounded_once(n_fft):
    tw = features.fft_twiddles(n_fft)
    assert tw.dtype == np.float32 and tw.shape == (n_fft // 2, 2)
    w = np.exp(-2j * np.pi * np.arange(n_fft // 2) / n_fft)
    np.testing.assert_array_equal(tw[:, 0], w.real.astype(f32))
    np.testing.assert_array_equal(tw[:, 1], w.imag.astype(f32))
    assert np.abs(tw[:, 0] - w.real).max() <= 2.0 ** -24
    assert np.abs(tw[:, 1] - w.imag).max() <= 2.0 ** -24


@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: f"n_fft{c.n_fft}-"
                         f"mels{c.n_mels}")
def test_tables_window_bitwise_and_bands_cover_every_nonzero(cfg):
    t = features._tables(cfg, torch.device("cpu"))
    np.testing.assert_array_equal(t.win.numpy(),
                                  np.hamming(cfg.frame_len).astype(f32))
    fb = features.mel_filterbank(cfg)
    np.testing.assert_array_equal(t.fb.numpy(), fb)
    np.testing.assert_array_equal(t.dct.numpy(),
                                  features.dct_matrix(cfg.n_mels, cfg.n_mfcc))
    np.testing.assert_array_equal(t.twiddles.numpy(),
                                  features.fft_twiddles(cfg.n_fft))
    bands = t.bands.numpy()
    assert bands.dtype == np.int32 and bands.shape == (cfg.n_mels, 2)
    bins = np.arange(fb.shape[0])[:, None]
    inside = (bins >= bands[None, :, 0]) & (bins < bands[None, :, 1])
    assert not (fb[~inside]).any()              # every nonzero in its band
    for m, (lo, hi) in enumerate(bands):        # and the band is tight
        if hi > lo:
            assert fb[lo, m] != 0 and fb[hi - 1, m] != 0
        else:
            assert lo == hi == 0 and not fb[:, m].any()
    bw = t.band_weights.numpy()                 # the band's weights, packed
    assert bw.dtype == np.float32 and bw.shape == (
        cfg.n_mels, (bands[:, 1] - bands[:, 0]).max())
    for m, (lo, hi) in enumerate(bands):
        np.testing.assert_array_equal(bw[m, :hi - lo], fb[lo:hi, m])
        assert not bw[m, hi - lo:].any()


def test_mel_bands_of_empty_and_ragged_filters():
    fb = np.zeros((9, 3), f32)
    fb[2, 0], fb[5, 0] = 0.5, 0.25              # a gap inside the band
    fb[8, 2] = 1.0
    bands = features.mel_bands(fb)
    np.testing.assert_array_equal(bands, [[2, 6], [0, 0], [8, 9]])
    np.testing.assert_array_equal(features.band_weights(fb, bands),
                                  [[0.5, 0, 0, 0.25], [0, 0, 0, 0],
                                   [1.0, 0, 0, 0]])


def _cmul(a, b):
    return np.stack([a[..., 0] * b[..., 0] - a[..., 1] * b[..., 1],
                     a[..., 0] * b[..., 1] + a[..., 1] * b[..., 0]], -1)


def _kernel_replay(sig, cfg, t):
    """`mfcc_kernel` in numpy fp32, stage by stage, from the tables `t`:
    sig (rows, S) -> (rows, n_frames, C)."""
    L, shift, n_fft = cfg.frame_len, cfg.frame_shift, cfg.n_fft
    H, log2h = n_fft // 2, (n_fft // 2).bit_length() - 1
    win, tw, bw, dct = (t.win.numpy(), t.twiddles.numpy(),
                        t.band_weights.numpy(), t.dct.numpy())
    n = 1 + (sig.shape[1] - L) // shift
    pre = np.concatenate([sig[:, :1], sig[:, 1:] - f32(cfg.preemphasis)
                          * sig[:, :-1]], axis=1).astype(f32)
    idx = np.arange(n)[:, None] * shift + np.arange(L)[None, :]
    v = np.zeros(pre.shape[:1] + (n, n_fft), f32)
    v[..., :L] = pre[:, idx] * win
    z = np.stack([v[..., 0::2], v[..., 1::2]], -1)          # (.., H, 2)
    rev = [int(format(i, f"0{log2h}b")[::-1], 2) for i in range(H)]
    a = np.empty_like(z)
    a[..., rev, :] = z
    for s in range(1, log2h + 1):
        half = 1 << (s - 1)
        for j in range(half):
            i0 = np.arange(j, H, 2 * half)
            tt = _cmul(a[..., i0 + half, :], tw[j * (H >> (s - 1))])
            tt = tt.astype(f32)
            u = a[..., i0, :].copy()
            a[..., i0, :], a[..., i0 + half, :] = u + tt, u - tt
    k = np.arange(H + 1)
    za, zb = a[..., k % H, :], a[..., (H - k) % H, :]
    er = f32(0.5) * (za[..., 0] + zb[..., 0])
    ei = f32(0.5) * (za[..., 1] - zb[..., 1])
    o = np.stack([f32(0.5) * (za[..., 1] + zb[..., 1]),
                  f32(-0.5) * (za[..., 0] - zb[..., 0])], -1)
    w = np.concatenate([tw, np.array([[-1.0, 0.0]], f32)])
    ow = _cmul(o, w).astype(f32)
    re, im = er + ow[..., 0], ei + ow[..., 1]
    power = (re * re + im * im).astype(f32)
    mel = np.zeros(power.shape[:-1] + (bw.shape[0],), f32)
    for m, (lo, hi) in enumerate(t.bands.numpy()):
        mel[..., m] = power[..., lo:hi] @ bw[m, :hi - lo]
    return (np.log(np.maximum(mel, f32(1e-10))) @ dct).astype(f32)


@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: f"n_fft{c.n_fft}-"
                         f"mels{c.n_mels}")
@pytest.mark.parametrize("rows,n_samples", [(1, 400), (3, 1520), (2, 2001)])
def test_kernel_algorithm_replayed_matches_plain_mfcc(cfg, rows, n_samples):
    if n_samples < cfg.frame_len:
        n_samples = cfg.frame_len
    r = np.random.RandomState(rows * n_samples)
    sig = (r.randn(rows, n_samples) * 0.3).astype(f32)
    sig[0] += np.sin(np.arange(n_samples) * 0.01).astype(f32)  # low band
    t = features._tables(cfg, torch.device("cpu"))
    want = ref.mfcc(torch.from_numpy(sig), cfg, t).numpy()
    got = _kernel_replay(sig, cfg, t)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)


def test_cpu_tensors_take_the_plain_version():
    cfg = FeatureConfig()
    t = features._tables(cfg, torch.device("cpu"))
    sig = torch.from_numpy(np.random.RandomState(0).randn(2, 2, 1520)
                           .astype(f32))
    want = ref.mfcc(sig, cfg, t)
    before = klm.launches
    for got in (klm.mfcc(sig, cfg, t), ops.mfcc(sig, cfg, t),
                features.mfcc(sig, cfg, use_logmel=True)):
        assert torch.equal(got, want)
    assert klm.launches == before
    assert tuple(features.mfcc(sig[0, 0], cfg, use_logmel=True).shape) == \
        (8, 80)
    with pytest.raises(ValueError, match="one frame"):
        features.mfcc(sig[..., :399], cfg, use_logmel=True)
