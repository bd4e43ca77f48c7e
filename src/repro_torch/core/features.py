"""MFCC feature extraction, PyTorch port of `repro/core/features.py`.

Pipeline: pre-emphasis -> 25ms/10ms framing -> Hamming window -> |FFT|^2
-> mel filterbank (80 banks) -> log -> DCT-II -> 80-dim MFCC.  The
post-FFT stages (mel matmul + log + DCT matmul) run as one fused kernel
(`kernels/logmel`) on the logmel route; everything before them is plain
torch, as the reference computes it outside any kernel.

Streaming: `frames_producible` is the setup-thread arithmetic — how many
whole frames fit in the buffered signal; `consumed_samples` how many
samples a step may retire.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from repro_torch.configs.tds_asr import FeatureConfig

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


@functools.lru_cache(maxsize=16)
def _tables(cfg: FeatureConfig, device: torch.device):
    """Hamming window, filterbank and DCT as tensors on `device`, made
    once per (config, device) instead of uploaded on every step."""
    win = torch.from_numpy(np.hamming(cfg.frame_len).astype(np.float32))
    fb = torch.from_numpy(mel_filterbank(cfg))
    dct = torch.from_numpy(dct_matrix(cfg.n_mels, cfg.n_mfcc))
    return win.to(device), fb.to(device), dct.to(device)


def mfcc(signal: torch.Tensor, cfg: FeatureConfig = DEFAULT_FEATURE_CONFIG,
         use_logmel: bool = False, kernels=None) -> torch.Tensor:
    """signal: (..., n_samples) f32 -> (..., n_frames, n_mfcc) f32.

    Leading axes are batch (the serving engine extracts every slot's
    window in one call; slots fold into the logmel rows).  `use_logmel`
    routes the mel+log+DCT tail through `ops.logmel`, dispatched by the
    `kernels` KernelPolicy (None = auto)."""
    n = frames_producible(signal.shape[-1], cfg)
    if n <= 0:
        raise ValueError("not enough samples for one frame")
    dev = signal.device
    sig = torch.cat(
        [signal[..., :1], signal[..., 1:] - cfg.preemphasis * signal[..., :-1]],
        dim=-1)
    idx = (torch.arange(n, device=dev)[:, None] * cfg.frame_shift
           + torch.arange(cfg.frame_len, device=dev)[None, :])
    win, fb, dct = _tables(cfg, dev)
    frames = sig[..., idx] * win                      # (..., n, frame_len)
    spec = torch.fft.rfft(frames, n=cfg.n_fft, dim=-1)
    power = spec.abs().square().to(torch.float32)     # (..., n, n_bins)
    if use_logmel:
        from repro_torch.kernels import ops
        rows = power.reshape(-1, power.shape[-1])
        out = ops.logmel(rows, fb, dct, policy=kernels)
        return out.reshape(power.shape[:-1] + (out.shape[-1],))
    mel = power @ fb
    return torch.log(torch.clamp_min(mel, 1e-10)) @ dct
