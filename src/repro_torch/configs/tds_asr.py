"""Paper case-study configs: the wav2letter TDS ASR system + ASRPU hardware.

A copy of `repro/configs/tds_asr.py` (no framework import), kept in the port so that it
imports nothing of the JAX package.

The paper (§4) implements an end-to-end wav2letter system: 80-dim MFCC
features, a TDS acoustic model executed as a sequence of 79 kernels
(18 CONV / 29 FC / 32 LayerNorm), and CTC beam-search decoding over a
lexicon trie + n-gram LM, with 9000 acoustic tokens (the last kernel
launches 9000 threads, one per output neuron).

The TDS layer schedule below is chosen to match the paper's kernel counts
exactly:
  front conv (1) + 3 sub-sampling convs + 14 TDS blocks x 1 conv = 18 CONV
  14 TDS blocks x 2 FC + final FC = 29 FC
  14 TDS blocks x 2 LN + 3 sub-sample LN + final LN = 32 LayerNorm (31+1)
Block widths follow Hannun et al. (arXiv:1904.02619) scaled so that FC
layers land in the ~MB range of paper Fig. 9 (1200x1200 fp-weights ~1.4MB
at 8-bit would be 1.4MB: the paper's example "1200 neurons with 1200
inputs each ... 1.4MB" is reproduced by the w=1200 stage).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class TDSStage:
    n_blocks: int
    channels: int        # c
    feat: int            # w per channel; layer width = c*w
    kernel: int          # time kernel width
    subsample: int       # stride of the stage-entry subsampling conv


@dataclass(frozen=True)
class TDSConfig:
    name: str = "tds-wav2letter"
    n_mfcc: int = 80
    # 3 stages; stage entry conv subsamples time by `subsample`.
    stages: Tuple[TDSStage, ...] = (
        TDSStage(n_blocks=2, channels=15, feat=80, kernel=9, subsample=2),
        TDSStage(n_blocks=5, channels=19, feat=80, kernel=9, subsample=2),
        TDSStage(n_blocks=7, channels=23, feat=80, kernel=9, subsample=2),
    )
    sub_kernel: int = 10         # stage-entry subsampling conv kernel
    vocab_size: int = 9000       # paper: "9000 phonetic units"
    dropout: float = 0.0

    @property
    def total_subsample(self) -> int:
        s = 1
        for st in self.stages:
            s *= st.subsample
        return s

    @property
    def n_blocks(self) -> int:
        return sum(st.n_blocks for st in self.stages)

    def kernel_counts(self) -> dict:
        """CONV/FC/LN kernel counts, paper says 18/29/32."""
        n_conv = 1 + len(self.stages) + self.n_blocks          # front+sub+TDS
        n_fc = 2 * self.n_blocks + 1                            # TDS FCs + head
        n_ln = 2 * self.n_blocks + len(self.stages) + 1         # TDS + sub + final
        return {"conv": n_conv, "fc": n_fc, "layernorm": n_ln}


@dataclass(frozen=True)
class FeatureConfig:
    sample_rate: int = 16000
    frame_ms: float = 25.0
    shift_ms: float = 10.0
    n_fft: int = 512
    n_mels: int = 80
    preemphasis: float = 0.97
    fmin: float = 20.0
    fmax: float = 7800.0
    n_mfcc: int = 80             # paper: 80-dim MFCC

    @property
    def frame_len(self) -> int:
        return int(self.sample_rate * self.frame_ms / 1000)

    @property
    def frame_shift(self) -> int:
        return int(self.sample_rate * self.shift_ms / 1000)


@dataclass(frozen=True)
class DecoderConfig:
    beam_size: int = 128         # fixed-K hypothesis memory
    beam_threshold: float = 25.0 # score beam (best - beam) pruning
    lm_weight: float = 1.5
    word_score: float = 1.0     # word insertion bonus
    blank_id: int = 0
    max_children: int = 32       # padded trie fanout


@dataclass(frozen=True)
class ASRPUHardware:
    """Paper Table 2 — used by the analytical performance model."""
    freq_hz: float = 500e6
    n_pes: int = 8
    mac_vector: int = 8
    hyp_mem_bytes: int = 24 * 1024
    icache_bytes: int = 64 * 1024
    shared_mem_bytes: int = 512 * 1024
    model_mem_bytes: int = 1 * 1024 * 1024
    pe_icache_bytes: int = 4 * 1024
    pe_dcache_bytes: int = 24 * 1024
    # paper results to validate against
    step_audio_ms: float = 80.0
    step_exec_ms: float = 40.0   # => 2x real-time
    area_mm2: float = 11.68
    peak_power_w: float = 1.8


TDS_CONFIG = TDSConfig()
FEATURE_CONFIG = FeatureConfig()
DECODER_CONFIG = DecoderConfig()
ASRPU_HW = ASRPUHardware()
