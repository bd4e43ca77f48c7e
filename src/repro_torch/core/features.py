"""MFCC feature extraction, PyTorch port of `repro/core/features.py`.

Pipeline: pre-emphasis -> 25ms/10ms framing -> Hamming window -> |FFT|^2
-> mel filterbank (80 banks) -> log -> DCT-II -> 80-dim MFCC.  On the
logmel route (`ops.mfcc`) the card runs the whole pipeline as one fused
kernel (`kernels/logmel.mfcc`); the plain version (`ref.mfcc`) is torch
with cuFFT or pocketfft for the FFT and the MFCC tail as the reference's
logmel kernel computes it.

Streaming: `frames_producible` is the setup-thread arithmetic — how many
whole frames fit in the buffered signal; `consumed_samples` how many
samples a step may retire.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.configs.tds_asr import FeatureConfig
from repro_torch.kernels import ref

DEFAULT_FEATURE_CONFIG = FeatureConfig()


def hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + f / 700.0)


def mel_to_hz(m):
    return 700.0 * (10.0 ** (m / 2595.0) - 1.0)


@functools.lru_cache()
def mel_filterbank(cfg: FeatureConfig) -> np.ndarray:
    """(n_fft//2+1, n_mels) triangular filterbank (numpy, as the reference)."""
    n_bins = cfg.n_fft // 2 + 1
    freqs = np.linspace(0, cfg.sample_rate / 2, n_bins)
    mels = np.linspace(hz_to_mel(cfg.fmin), hz_to_mel(cfg.fmax), cfg.n_mels + 2)
    pts = mel_to_hz(mels)
    fb = np.zeros((n_bins, cfg.n_mels), np.float32)
    for m in range(cfg.n_mels):
        lo, c, hi = pts[m], pts[m + 1], pts[m + 2]
        up = (freqs - lo) / max(c - lo, 1e-9)
        down = (hi - freqs) / max(hi - c, 1e-9)
        fb[:, m] = np.maximum(0.0, np.minimum(up, down))
    return fb


@functools.lru_cache()
def dct_matrix(n_in: int, n_out: int) -> np.ndarray:
    """Orthonormal DCT-II, (n_in, n_out) (numpy, as the reference)."""
    k = np.arange(n_out)[None, :]
    n = np.arange(n_in)[:, None]
    m = np.cos(np.pi * k * (2 * n + 1) / (2 * n_in)) * math.sqrt(2.0 / n_in)
    m[:, 0] *= 1.0 / math.sqrt(2.0)
    return m.astype(np.float32)


def frames_producible(n_samples: int, cfg: FeatureConfig) -> int:
    """Setup-thread arithmetic: whole frames extractable from n samples."""
    if n_samples < cfg.frame_len:
        return 0
    return 1 + (n_samples - cfg.frame_len) // cfg.frame_shift


def consumed_samples(n_frames: int, cfg: FeatureConfig) -> int:
    """Samples that can be retired after emitting n_frames (keep overlap)."""
    return n_frames * cfg.frame_shift


@functools.lru_cache()
def fft_twiddles(n_fft: int) -> np.ndarray:
    """(n_fft//2, 2) f32: exp(-2*pi*i*k/n_fft) for k < n_fft/2 as
    (cos, -sin), computed in fp64 and rounded once.  The fused MFCC
    kernel's n_fft/2-point complex FFT takes every other entry; the split
    of its result into the n_fft-point real spectrum takes them all."""
    k = np.arange(n_fft // 2) * (2.0 * np.pi / n_fft)
    return np.stack([np.cos(k), -np.sin(k)], axis=-1).astype(np.float32)


def mel_bands(fb: np.ndarray) -> np.ndarray:
    """(n_mels, 2) int32 [lo, hi): the bins between each filter's first
    and last nonzero weight (lo = hi = 0 for a filter with none).  The
    fused kernel sums each mel bin over its band only."""
    bands = np.zeros((fb.shape[1], 2), np.int32)
    for m in range(fb.shape[1]):
        nz = np.flatnonzero(fb[:, m])
        if nz.size:
            bands[m] = nz[0], nz[-1] + 1
    return bands


def band_weights(fb: np.ndarray, bands: np.ndarray) -> np.ndarray:
    """(n_mels, W) f32, W the widest band: row m holds fb[lo:hi, m] of
    its band `bands[m]`, then zeros.  The fused kernel keeps this, not
    the mostly-zero filterbank, in shared memory."""
    widths = bands[:, 1] - bands[:, 0]
    out = np.zeros((fb.shape[1], max(1, int(widths.max()))), np.float32)
    for m, (lo, hi) in enumerate(bands):
        out[m, :hi - lo] = fb[lo:hi, m]
    return out


class FeatureTables(NamedTuple):
    """The MFCC's constant tables on one device."""
    win: torch.Tensor           # (frame_len,) Hamming window
    fb: torch.Tensor            # (n_fft//2+1, n_mels) mel filterbank
    dct: torch.Tensor           # (n_mels, n_mfcc) DCT-II
    twiddles: torch.Tensor      # (n_fft//2, 2) `fft_twiddles`
    bands: torch.Tensor         # (n_mels, 2) int32 `mel_bands`
    band_weights: torch.Tensor  # (n_mels, W) `band_weights`


@functools.lru_cache(maxsize=16)
def _tables(cfg: FeatureConfig, device: torch.device) -> FeatureTables:
    """The MFCC's tables as tensors on `device`, made once per (config,
    device) instead of uploaded on every step."""
    fb = mel_filterbank(cfg)
    bands = mel_bands(fb)
    arrays = (np.hamming(cfg.frame_len).astype(np.float32), fb,
              dct_matrix(cfg.n_mels, cfg.n_mfcc), fft_twiddles(cfg.n_fft),
              bands, band_weights(fb, bands))
    return FeatureTables(*(torch.from_numpy(a).to(device) for a in arrays))


def mfcc(signal: torch.Tensor, cfg: FeatureConfig = DEFAULT_FEATURE_CONFIG,
         use_logmel: bool = False, kernels=None) -> torch.Tensor:
    """signal: (..., n_samples) f32 -> (..., n_frames, n_mfcc) f32.

    Leading axes are batch (the serving engine extracts every slot's
    window in one call).  `use_logmel` routes the pipeline through
    `ops.mfcc`, dispatched by the `kernels` KernelPolicy (None = auto):
    one fused launch on the card.  Without it the plain version runs."""
    if frames_producible(signal.shape[-1], cfg) <= 0:
        raise ValueError("not enough samples for one frame")
    tables = _tables(cfg, signal.device)
    if use_logmel:
        from repro_torch.kernels import ops
        return ops.mfcc(signal, cfg, tables, policy=kernels)
    return ref.mfcc(signal, cfg, tables)


def deltas(feats: torch.Tensor, window: int = 2) -> torch.Tensor:
    """Regression-based dynamic features (delta / delta-delta).

    feats: (T, C) -> (T, C) delta coefficients:
        d_t = sum_n n*(x_{t+n} - x_{t-n}) / (2*sum_n n^2),  edge-padded."""
    T, C = feats.shape
    denom = 2.0 * sum(n * n for n in range(1, window + 1))
    padded = torch.cat([feats[:1].expand(window, C), feats,
                        feats[-1:].expand(window, C)], dim=0)
    out = torch.zeros_like(feats)
    for n in range(1, window + 1):
        out = out + n * (padded[window + n:window + n + T]
                         - padded[window - n:window - n + T])
    return out / denom


def mfcc_with_deltas(signal: torch.Tensor,
                     cfg: FeatureConfig = DEFAULT_FEATURE_CONFIG
                     ) -> torch.Tensor:
    """signal: (n_samples,) -> (n_frames, 3*n_mfcc): static + delta +
    delta-delta.  The static MFCC takes the logmel route: the fused
    kernel on the card, its plain version on the CPU."""
    static = mfcc(signal, cfg, use_logmel=True)
    d1 = deltas(static)
    d2 = deltas(d1)
    return torch.cat([static, d1, d2], dim=-1)
