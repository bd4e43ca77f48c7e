"""The MFCC on the card: the whole pipeline of `features.mfcc` in one
launch (`mfcc`), and its tail on given power rows (`logmel`):
out = log(max(P @ fb, 1e-10)) @ dct.

Replaces the TPU kernel `logmel_pallas` (src/repro/kernels/logmel.py),
which computes the tail; here the front end it was fed by (pre-emphasis,
framing, Hamming window, 512-point FFT, power) runs in the same launch.
CUDA source: `csrc/logmel.cu`.

What bounds it on the H100: neither bytes nor operations at the main
path's size.  One decoding step passes R = b*w*8 <= 128 frames (about
0.17 MB of samples, tables and output, ~3.8 MFLOP), under 0.06 us of
either; launches and latency set the time.  The plain pipeline takes
some 13-16 launches (pre-emphasis, gather, window, cuFFT, power, mel,
log, DCT);
the design takes one: a block per frame stages the frame and every table
in shared memory with one wait on device memory, keeps the frame's FFT,
power spectrum and log-mel row there, and writes only the frame's
n_mfcc coefficients.

Both wrappers count their launches under `launches` (the `logmel`
kernel's count).  On a CPU tensor they run the plain versions
(`ref.mfcc`, `ref.logmel`).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

launches = 0        # kernel launches made by this module's wrappers
MAX_BINS = 256      # mel bins and coefficients a launch takes, at most
MAX_FFT = 4096      # FFT length a launch takes, at most (a power of two)


def _check_tail(fb: torch.Tensor, dct: torch.Tensor, n_bins: int):
    if fb.shape[0] != n_bins or dct.shape[0] != fb.shape[1]:
        raise ValueError(f"logmel: fb {tuple(fb.shape)} and dct "
                         f"{tuple(dct.shape)} do not chain from {n_bins} bins")
    M, C = dct.shape
    if M > MAX_BINS or C > MAX_BINS:
        raise ValueError(f"logmel: at most {MAX_BINS} mel bins and "
                         f"coefficients, got {M} and {C}")
    return M, C


def _check_tables(tables, L: int, n_fft: int, dev) -> None:
    """Validate `features._tables` for the fused kernel."""
    for name, dt, nd in (("win", torch.float32, 1), ("fb", torch.float32, 2),
                         ("dct", torch.float32, 2),
                         ("twiddles", torch.float32, 2),
                         ("bands", torch.int32, 2),
                         ("band_weights", torch.float32, 2)):
        _build.require(getattr(tables, name), name, dt, nd, dev)
    M, _ = _check_tail(tables.fb, tables.dct, n_fft // 2 + 1)
    if tables.win.shape[0] != L or \
            tuple(tables.twiddles.shape) != (n_fft // 2, 2) or \
            tuple(tables.bands.shape) != (M, 2) or \
            tables.band_weights.shape[0] != M:
        raise ValueError(f"mfcc: tables win {tuple(tables.win.shape)}, "
                         f"twiddles {tuple(tables.twiddles.shape)}, bands "
                         f"{tuple(tables.bands.shape)}, band weights "
                         f"{tuple(tables.band_weights.shape)} do not fit "
                         f"frame_len {L}, n_fft {n_fft}, {M} mels")


def logmel(power: torch.Tensor, fb: torch.Tensor,
           dct: torch.Tensor) -> torch.Tensor:
    """power: (R, F) f32; fb: (F, M); dct: (M, C) -> (R, C) f32."""
    global launches
    if not power.is_cuda:
        return ref.logmel(power, fb, dct)
    _build.refuse_grad("logmel", power, fb, dct)
    dev = power.device
    for t, name in ((power, "power"), (fb, "fb"), (dct, "dct")):
        _build.require(t, name, torch.float32, 2, dev)
    R, F = power.shape
    M, C = _check_tail(fb, dct, F)
    out = torch.empty((R, C), dtype=torch.float32, device=dev)
    err = _build.lib().logmel_launch(
        power.data_ptr(), fb.data_ptr(), dct.data_ptr(), out.data_ptr(),
        R, F, M, C, _build.stream(dev))
    _build.check(err, "logmel")
    launches += 1
    return out


def mfcc(signal: torch.Tensor, cfg, tables) -> torch.Tensor:
    """signal: (..., S) f32, contiguous -> (..., n_frames, n_mfcc) f32.

    `cfg`: a FeatureConfig (frame_len, frame_shift, n_fft, preemphasis);
    `tables`: `features._tables(cfg, device)`, whose shapes are checked
    here and whose band table the kernel trusts (checking its values
    would read it back from the card).  The same function as `ref.mfcc`,
    with its own FFT in place of cuFFT's."""
    global launches
    if not signal.is_cuda:
        return ref.mfcc(signal, cfg, tables)
    _build.refuse_grad("mfcc", signal, *tables)
    dev = signal.device
    if signal.dim() < 1 or not signal.is_contiguous():
        raise ValueError("mfcc: expected a contiguous signal of at least one "
                         "dimension")
    S = signal.shape[-1]
    x = signal.reshape(-1, S)
    _build.require(x, "signal", torch.float32, 2, dev)
    L, shift, n_fft = cfg.frame_len, cfg.frame_shift, cfg.n_fft
    if S < L:
        raise ValueError(f"mfcc: {S} samples hold no frame of {L}")
    if n_fft & (n_fft - 1) or not 4 <= n_fft <= MAX_FFT or L > n_fft:
        raise ValueError(f"mfcc: n_fft must be a power of two in [4, "
                         f"{MAX_FFT}] and at least the frame length {L}, "
                         f"got {n_fft}")
    _check_tables(tables, L, n_fft, dev)
    M, C = tables.dct.shape
    n = 1 + (S - L) // shift
    rows = x.shape[0]
    out = torch.empty(signal.shape[:-1] + (n, C), dtype=torch.float32,
                      device=dev)
    if rows * n >= 2 ** 31:
        raise ValueError(f"mfcc: {rows * n} frames exceed one launch's grid")
    if rows == 0:
        return out
    err = _build.lib().mfcc_launch(
        x.data_ptr(), tables.win.data_ptr(), tables.twiddles.data_ptr(),
        tables.bands.data_ptr(), tables.band_weights.data_ptr(),
        tables.dct.data_ptr(), out.data_ptr(), rows, S, n, L, shift, n_fft,
        M, tables.band_weights.shape[1], C, float(cfg.preemphasis),
        _build.stream(dev))
    _build.check(err, "mfcc")
    launches += 1
    return out
