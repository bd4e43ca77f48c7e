"""Static decoding-step schedule — the paper's setup threads (§3.2).

Port of `repro/core/stepplan.py` (pure Python).  The per-kernel setup
arithmetic — how many outputs are producible from buffered inputs, what
to retire, how many threads to launch — is fixed at plan time for the
steady-state step; the serving engine reads its window geometry from
the plan.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

from repro_torch.configs.tds_asr import (FEATURE_CONFIG, TDS_CONFIG,
                                         FeatureConfig, TDSConfig)
from repro_torch.models import tds


@dataclass
class PlannedKernel:
    """One kernel execution inside a decoding step."""
    name: str
    kind: str
    n_threads: int          # threads launched by the ASR controller
    n_frames: int           # output frames this step
    macs_per_thread: int    # inner-loop MACs (setup thread metadata)
    weight_bytes: int
    n_subkernels: int


@dataclass
class StepPlan:
    """Static steady-state decoding-step schedule (the setup threads)."""
    samples_per_step: int
    feat_frames_per_step: int
    acoustic_frames_per_step: int   # hyp-expansion repetitions
    kernels: List[PlannedKernel]

    def total_threads(self) -> int:
        return sum(k.n_threads for k in self.kernels)


def make_step_plan(tds_cfg: TDSConfig = TDS_CONFIG,
                   feat_cfg: FeatureConfig = FEATURE_CONFIG,
                   step_ms: float = 80.0, beam_k: int = 128) -> StepPlan:
    """The setup-thread arithmetic for one steady-state decoding step.
    `beam_k` (the hypothesis memory's size) is accepted for the
    reference's signature; no planned kernel depends on it."""
    samples = int(feat_cfg.sample_rate * step_ms / 1000)
    feat_frames = int(step_ms / feat_cfg.shift_ms)          # 8 @ 80ms
    sub = tds_cfg.total_subsample
    if feat_frames % sub:
        raise ValueError(f"{feat_frames} feature frames per step is no "
                         f"multiple of the total subsample {sub}")
    out_frames = feat_frames // sub
    kernels = [PlannedKernel(
        "mfcc", "feature", n_threads=feat_frames, n_frames=feat_frames,
        macs_per_thread=(feat_cfg.frame_len                  # window+preemph
                         + feat_cfg.n_fft * int(np.log2(feat_cfg.n_fft))
                         + (feat_cfg.n_fft // 2 + 1) * feat_cfg.n_mels
                         + feat_cfg.n_mels * feat_cfg.n_mfcc),
        weight_bytes=0, n_subkernels=1)]
    t = feat_frames
    for spec in tds.build_kernel_specs(tds_cfg):
        t_out = t // spec.stride
        if spec.kind == "layernorm":
            kernels.append(PlannedKernel(
                spec.name, spec.kind, n_threads=t_out, n_frames=t_out,
                macs_per_thread=2 * spec.n_out, weight_bytes=0,
                n_subkernels=1))
        else:
            # one thread per output neuron per frame (paper §3.1)
            kernels.append(PlannedKernel(
                spec.name, spec.kind, n_threads=t_out * spec.n_out,
                n_frames=t_out, macs_per_thread=spec.n_in,
                weight_bytes=spec.weight_bytes,
                n_subkernels=spec.n_subkernels))
        t = t_out
    assert t == out_frames, (t, out_frames)
    return StepPlan(samples, feat_frames, out_frames, kernels)
