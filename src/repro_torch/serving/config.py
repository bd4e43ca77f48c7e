"""Declarative serving configuration, port of `repro/serving/config.py`.

One frozen program per workload — an `AsrProgram` (acoustic model +
hypothesis expansion + decoding step geometry, compiled into a static
`StepPlan`) or an `LmProgram` (LM arch + cache/generation budget) —
wrapped in an `EngineConfig` that adds the slot-pool size, the kernel
policy and, for the ASR engine, an optional serving mesh of
`torch.distributed` ranks (`launch.mesh.Mesh`).  A configured engine
never mutates its program.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional, Tuple, Union

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.tds_asr import (DECODER_CONFIG, FEATURE_CONFIG,
                                         DecoderConfig, FeatureConfig,
                                         TDSConfig)
from repro_torch.core.lexicon import BigramLM, Lexicon
from repro_torch.core.stepplan import StepPlan, make_step_plan
from repro_torch.kernels.policy import KernelPolicy


@dataclass(frozen=True)
class AsrProgram:
    """The streaming ASR decoding program: acoustic scoring then
    hypothesis expansion."""
    tds_cfg: TDSConfig
    lex: Lexicon
    lm: BigramLM
    feat_cfg: FeatureConfig = FEATURE_CONFIG
    dec_cfg: DecoderConfig = DECODER_CONFIG
    use_int8: bool = False
    step_ms: float = 80.0
    # Upper bound on how many buffered step_ms windows ONE fused decoding
    # step may consume (powers of two below it are the step buckets).
    # Live streaming still steps window by window; bulk decoding folds up
    # to this many windows into the acoustic forward's row dimension,
    # reading each FC weight matrix once per multi-window step.
    max_windows_per_step: int = 4
    # On finish(), a session whose buffer still holds samples no decoded
    # frame has covered gets that trailing partial window zero-padded
    # and decoded by one last step before finalize.  The deprecated
    # ASRPU command shims disable it: the paper's DecodingStep/best
    # commands have no end-of-input signal and decode whole windows only.
    flush_tail: bool = True
    # Per-push input cap (samples), ~60 s at 16 kHz.
    max_push_samples: int = 960_000

    def step_buckets(self) -> Tuple[int, ...]:
        """Descending window counts a fused step may take."""
        out, b = [], 1
        while b <= self.max_windows_per_step:
            out.append(b)
            b *= 2
        return tuple(reversed(out))

    def step_plan(self) -> StepPlan:
        """The static setup-thread schedule for one decoding step."""
        return make_step_plan(self.tds_cfg, self.feat_cfg, self.step_ms,
                              self.dec_cfg.beam_size)

    def prepare_params(self, params, device, mesh=None):
        """Build-time weight preparation, returning `(params, prepared)`
        on `device`:

          * int8 programs quantize every FC/head weight matrix once,
            there (`tds.quantize_params`), so that the hot path only
            quantizes activations; fp32 programs get `prepared=None`;
          * with a `mesh`, both trees are then cut to this rank's blocks
            (`parallel.sharding.shard_tree`): FC/head weights and their
            int8 `wq` split on the feature axis over 'model'
            (`tds_param_specs`, `tds_prepared_specs`), everything else
            whole, so each rank holds only its weight shards.  The
            scales `ws` come from the whole weights."""
        from repro_torch.models import tds
        params = tds.params_from_numpy(params, device)
        prepared = (tds.quantize_params(params, self.tds_cfg)
                    if self.use_int8 else None)
        if mesh is not None:
            from repro_torch.parallel import sharding as shlib
            params = shlib.shard_tree(
                params, shlib.tds_param_specs(self.tds_cfg, mesh), mesh)
            if prepared is not None:
                prepared = shlib.shard_tree(
                    prepared, shlib.tds_prepared_specs(self.tds_cfg, mesh),
                    mesh)
        return params, prepared

    def validate_input(self, chunk: np.ndarray) -> None:
        """Admission-time validation of one pushed audio chunk: reject
        bad input before anything is buffered instead of letting it
        fault the co-batched step later."""
        chunk = np.asarray(chunk)
        if chunk.ndim != 1:
            raise ValueError(
                f"audio chunk must be 1-D samples, got shape "
                f"{chunk.shape}")
        if not np.issubdtype(chunk.dtype, np.floating):
            raise ValueError(
                f"audio chunk must be float samples, got dtype "
                f"{chunk.dtype}")
        if chunk.shape[0] > self.max_push_samples:
            raise ValueError(
                f"audio chunk of {chunk.shape[0]} samples exceeds "
                f"max_push_samples={self.max_push_samples}")
        if chunk.shape[0] and not np.isfinite(chunk).all():
            raise ValueError("audio chunk contains NaN/Inf samples")

    def with_beam_width(self, beam: float) -> "AsrProgram":
        """A copy with another beam threshold."""
        return replace(self, dec_cfg=replace(self.dec_cfg,
                                             beam_threshold=beam))


@dataclass(frozen=True)
class LmProgram:
    """Batched LM serving program: arch + pooled-cache geometry.

    `prefill_buckets` bounds the prefill shapes: prompts are right-padded
    to the smallest covering bucket and prefilled through one masked
    multi-row prefill per bucket.  Empty = powers of two from 8 up to the
    first one covering the longest legal prompt.
    """
    model_cfg: ModelConfig
    cache_len: int
    max_new: int
    prefill_buckets: Tuple[int, ...] = ()

    @property
    def max_prompt_len(self) -> int:
        return self.cache_len - self.max_new

    def buckets(self) -> Tuple[int, ...]:
        if self.prefill_buckets:
            bs = tuple(sorted(set(int(b) for b in self.prefill_buckets)))
            if bs[-1] < self.max_prompt_len:
                raise ValueError(
                    f"largest prefill bucket {bs[-1]} does not cover the "
                    f"longest legal prompt ({self.max_prompt_len})")
        else:
            out, b = [8], 8
            while b < self.max_prompt_len:
                b *= 2
                out.append(b)
            bs = tuple(out)
        # the reference's prefill chunking (attention chunks, SSD chunk
        # size) requires every bucket S to satisfy S % min(chunk, S) == 0;
        # the port keeps the check so that both accept the same programs
        chunks = [self.model_cfg.attn_chunk_q, self.model_cfg.attn_chunk_kv]
        if self.model_cfg.ssm is not None:
            chunks.append(self.model_cfg.ssm.chunk_size)
        for b in bs:
            for c in chunks:
                if b % min(c, b):
                    raise ValueError(
                        f"prefill bucket {b} not divisible by chunk {c}")
        return bs

    def validate_prompt(self, prompt_len: int) -> None:
        if prompt_len < 1:
            raise ValueError("prompt must contain at least one token")
        if prompt_len + self.max_new > self.cache_len:
            raise ValueError(
                f"prompt_len={prompt_len} + max_new={self.max_new} exceeds "
                f"cache_len={self.cache_len}")

    def validate_input(self, prompt: np.ndarray) -> None:
        """Admission-time validation of a pushed prompt: token ids must
        be an integral 1-D vector inside the vocabulary — an
        out-of-range id indexes garbage through the embedding gather (or
        faults the device) inside the shared prefill batch, so it is
        rejected before it can be co-batched."""
        prompt = np.asarray(prompt)
        if prompt.ndim != 1:
            raise ValueError(
                f"prompt must be a 1-D token vector, got shape "
                f"{prompt.shape}")
        if not np.issubdtype(prompt.dtype, np.integer):
            raise ValueError(
                f"prompt must hold integer token ids, got dtype "
                f"{prompt.dtype}")
        self.validate_prompt(prompt.shape[0])
        vocab = self.model_cfg.vocab_size
        if prompt.size and (prompt.min() < 0 or prompt.max() >= vocab):
            raise ValueError(
                f"prompt token ids must be in [0, {vocab}), got range "
                f"[{prompt.min()}, {prompt.max()}]")


Program = Union[AsrProgram, LmProgram]


@dataclass(frozen=True)
class EngineConfig:
    """A program plus the slot-pool size it is served over.

    `kernels` selects how the kernel-backed decode ops execute (see
    `repro_torch.kernels.policy.KernelPolicy`).  `max_queue` is the
    admission backpressure bound (`AdmissionRejected` when every slot is
    busy and the queue is full; None = unbounded).

    `mesh` (a `launch.mesh.Mesh` with a 'model' axis and optionally a
    'data' axis; ASR only) runs the decoding step sharded, one copy of
    the engine per rank, every rank fed the same sessions: FC/head
    weights split on their feature axis over 'model' (each rank
    contracts its slice, the partial products are all-reduced), and
    with a 'data' axis the slot pool split into `n_slots / n_data`
    contiguous slots per data shard, each shard stepping its own slots
    with no 'data'-axis collective.  `n_slots` must divide evenly over
    'data'.  None (the default) is the single-device engine.
    `overlap_psum` chunks each sharded contraction's all-reduce so it
    runs under the next chunk's product (`ops.psum_overlap_matmul`;
    ~1e-6 from the synchronous all-reduce); a no-op without a mesh.

    Fault-tolerance knobs (README "Fault tolerance"):

    `session_deadline` — wall-clock seconds a session may live from
    `open()` before the pump reaps it (`DeadlineExceeded`).  None = no
    deadline.  Under a mesh of several ranks rank 0's clock alone
    decides (`AsrEngine._reap_deadlines`; over the network, rank 0's
    command stream).

    `worker_watchdog` — seconds an `EngineWorker`'s heartbeat may age
    before the server's supervisor declares the worker wedged, fails its
    in-flight futures, rebuilds the pool and restarts the thread.  None
    disables the wedge detection (a dead thread is still restarted).
    Under a mesh only rank 0 runs workers; its restart quarantines the
    pool on every rank through the command stream.

    `faults` — an armed `repro_torch.serving.faults.FaultPolicy`
    consulted at the engines' injection sites; None skips every check.
    Under a mesh of several ranks every rank holds the same policy and
    counters, so a ``raise`` fires alike everywhere; a ``stall`` or
    ``die`` at ``asr_step`` is refused (it would wedge or kill one rank
    between the others' all-reduces), while ``pump`` specs act on rank
    0's worker loop alone, outside every collective."""
    program: Program
    n_slots: int = 1
    kernels: KernelPolicy = field(default_factory=KernelPolicy)
    mesh: Optional[object] = None      # launch.mesh.Mesh
    max_queue: Optional[int] = None
    overlap_psum: bool = False
    session_deadline: Optional[float] = None
    worker_watchdog: Optional[float] = None
    faults: Optional[object] = None    # FaultPolicy; object() keeps the
                                       # config module import-light

    def __post_init__(self):
        if self.n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {self.n_slots}")
        if self.max_queue is not None and self.max_queue < 0:
            raise ValueError(
                f"max_queue must be None or >= 0, got {self.max_queue}")
        if self.session_deadline is not None and self.session_deadline <= 0:
            raise ValueError(
                f"session_deadline must be None or > 0, got "
                f"{self.session_deadline}")
        if self.worker_watchdog is not None and self.worker_watchdog <= 0:
            raise ValueError(
                f"worker_watchdog must be None or > 0, got "
                f"{self.worker_watchdog}")
        if self.mesh is not None:
            if "model" not in self.mesh.axis_names:
                raise ValueError(
                    f"serving mesh needs a 'model' axis, got {self.mesh}")
            extra = [a for a in self.mesh.axis_names
                     if a not in ("data", "model")]
            if extra:
                raise ValueError(
                    f"serving mesh axes must be ('data', 'model') or "
                    f"('model',), got extra axes {extra} in {self.mesh}")
            if "data" in self.mesh.axis_names:
                nd = self.mesh.shape["data"]
                if self.n_slots % nd != 0:
                    raise ValueError(
                        f"n_slots={self.n_slots} must divide evenly over "
                        f"the 'data' mesh axis (size {nd}): each data "
                        f"shard owns n_slots/n_data pool slots")
            wedges = [f"{s.action!r}" for s in getattr(self.faults,
                                                        "specs", ())
                      if s.site == "asr_step"
                      and s.action in ("stall", "die")]
            if wedges and self.mesh.size > 1:
                raise ValueError(
                    f"a {' and '.join(wedges)} fault at 'asr_step' is not "
                    f"served under a mesh of {self.mesh.size} ranks: it "
                    f"would wedge or kill one rank between the other "
                    f"ranks' all-reduces, outside rank 0's ordered "
                    f"command stream ('raise' there, and 'stall' or 'die' "
                    f"at 'pump', are served)")


def make_engine(config: EngineConfig, params, device=None):
    """Build the engine matching `config.program`'s workload type, on
    `device` (the card unless the caller names another)."""
    from repro_torch.serving.asr import AsrEngine
    from repro_torch.serving.lm import LmEngine

    if isinstance(config.program, AsrProgram):
        return AsrEngine(config, params, device=device)
    if isinstance(config.program, LmProgram):
        return LmEngine(config, params, device=device)
    raise TypeError(f"unknown program type: {type(config.program)!r}")
