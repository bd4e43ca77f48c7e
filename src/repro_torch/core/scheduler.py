"""ASRPU command-API shims over the serving engine (paper §3, Table 1).

Port of `repro/core/scheduler.py`.  The accelerator's command set maps
1:1 onto these classes:

  ConfigureASR_AcousticScoring  -> configure_acoustic_scoring(...)
  ConfigureASR_HypExpansion     -> configure_hyp_expansion(lex, lm, ...)
  ConfigureBeamWidth            -> configure_beam_width(beam)
  DecodingStep                  -> decoding_step(signal_chunk)
  CleanDecoding                 -> clean_decoding()

DEPRECATED: the mutable configure-command sequence is kept only as the
paper-shaped surface.  New code builds a frozen
`repro_torch.serving.AsrProgram` / `EngineConfig` and streams through
`Session.push/poll/finish`.  Both shims hold no decoding state of their
own: each accumulates the configure commands into an `AsrProgram` and
drives one `repro_torch.serving.AsrEngine` slot pool (n_slots=1 for
`ASRPU`), on the card unless given `device="cpu"`.
"""
from __future__ import annotations

import warnings
from dataclasses import replace
from typing import List, Optional

import numpy as np

from repro_torch.configs.tds_asr import (ASRPU_HW, DECODER_CONFIG,
                                         FEATURE_CONFIG, DecoderConfig,
                                         FeatureConfig, TDSConfig)
from repro_torch.core.lexicon import BigramLM, Lexicon
from repro_torch.core.stepplan import StepPlan, make_step_plan
from repro_torch.serving import AsrEngine, AsrProgram, EngineConfig
from repro_torch.serving.asr import empty_hypothesis
from repro_torch.serving.engine import copy_result


class ASRPU:
    """The accelerator as a streaming decoder object — a deprecated shim
    translating the command API onto a 1-slot serving engine."""

    _n_slots = 1

    def __init__(self, hw=ASRPU_HW, device=None):
        warnings.warn(
            f"{type(self).__name__} is deprecated: build a frozen "
            "repro_torch.serving.AsrProgram/EngineConfig and stream "
            "through Session.push/poll/finish",
            DeprecationWarning, stacklevel=2)
        self.hw = hw
        self.device = device
        self._tds_cfg: Optional[TDSConfig] = None
        self._params = None
        self._feat_cfg = FEATURE_CONFIG
        self._dec_cfg = DECODER_CONFIG
        self._lex: Optional[Lexicon] = None
        self._lm: Optional[BigramLM] = None
        self._use_int8 = False
        self._step_ms = 80.0
        self.plan: Optional[StepPlan] = None
        self._engine: Optional[AsrEngine] = None

    # ---- configuration commands -------------------------------------
    def configure_acoustic_scoring(self, tds_cfg: TDSConfig, params,
                                   feat_cfg: FeatureConfig = FEATURE_CONFIG,
                                   use_int8: bool = False,
                                   step_ms: float = 80.0):
        self._tds_cfg, self._params = tds_cfg, params
        self._feat_cfg = feat_cfg
        self._use_int8 = use_int8
        self._step_ms = step_ms
        self.plan = make_step_plan(tds_cfg, feat_cfg, step_ms,
                                   self._dec_cfg.beam_size)
        self._reconfigure()

    def configure_hyp_expansion(self, lex: Lexicon, lm: BigramLM,
                                dec_cfg: DecoderConfig = DECODER_CONFIG):
        self._lex, self._lm, self._dec_cfg = lex, lm, dec_cfg
        self._reconfigure()

    def configure_beam_width(self, beam: float):
        self._dec_cfg = replace(self._dec_cfg, beam_threshold=beam)
        self._reconfigure()

    def _reconfigure(self):
        """Swap in an engine for the new program.  A configure command
        between DecodingSteps is legal in the paper's command API, so
        in-flight decoding state (sample buffers, left context, beam)
        carries over to the new engine."""
        old, self._engine = self._engine, None
        if old is None or self._tds_cfg is None or self._lex is None:
            return
        self._require_engine().adopt_state(old)

    # ---- engine assembly --------------------------------------------
    def _program(self) -> AsrProgram:
        # max_windows_per_step=1: the paper's DecodingStep command is
        # one 80 ms window per execution, and callers observe _n_steps.
        # flush_tail=False: the command API has no end-of-input signal,
        # so the engine's trailing-window flush must not fire here.
        return AsrProgram(self._tds_cfg, self._lex, self._lm,
                          self._feat_cfg, self._dec_cfg,
                          use_int8=self._use_int8, step_ms=self._step_ms,
                          max_windows_per_step=1, flush_tail=False)

    def _require_engine(self) -> AsrEngine:
        if self._tds_cfg is None or self._lex is None:
            raise RuntimeError("accelerator not configured: call "
                               "configure_acoustic_scoring and "
                               "configure_hyp_expansion first")
        if self._engine is None:
            self._engine = AsrEngine(
                EngineConfig(self._program(), n_slots=self._n_slots),
                self._params, device=self.device)
        return self._engine

    @property
    def _n_steps(self) -> int:
        return self._engine.n_steps if self._engine is not None else 0

    @property
    def _beam(self):
        # intentional raw exposure for parity tests, which only read it
        # (the pool's tensors are mutable: no caller may write to them)
        # repro-lint: disable=RPL003
        return self._engine._beam if self._engine is not None else None

    @property
    def _stream_state(self):
        # repro-lint: disable=RPL003  (same intentional exposure)
        return (self._engine._stream_state
                if self._engine is not None else None)

    # ---- runtime commands -------------------------------------------
    def clean_decoding(self):
        """Reset hypothesis memory + streaming buffers for a new utterance."""
        if self._engine is not None:
            self._engine.reset()

    def decoding_step(self, signal: np.ndarray):
        """Append `signal` to the stream and run decoding steps for every
        full 80 ms window available.  Returns the current best hypothesis."""
        eng = self._require_engine()
        eng.feed_slot(0, signal)
        eng.pump()
        return self.best()

    def best(self, final: bool = False):
        """Current best hypothesis.  final=True commits a pending
        utterance-final word (call when the utterance is known to end)."""
        if self._engine is None:
            return empty_hypothesis()
        return copy_result(self._engine.slot_best(0, final=final))


class MultiStreamASRPU(ASRPU):
    """B concurrent utterance streams through ONE slot-batched decoding
    step — a deprecated shim over an N-slot `AsrEngine`.

    Command API extensions over ASRPU:
      CleanDecoding(slot)   -> clean_decoding(slot=s): reset one stream
      DecodingStep(slot, x) -> decoding_step(x, slot=s)
      serve(utterances)     -> continuous batching: admission of queued
                               utterances into freed slots until drained
    """

    def __init__(self, n_streams: int, hw=ASRPU_HW, device=None):
        if n_streams < 1:
            raise ValueError(f"n_streams must be >= 1, got {n_streams}")
        self.n_streams = n_streams
        self._n_slots = n_streams
        super().__init__(hw, device=device)

    # slot/final are keyword-only: through the ASRPU-typed interface a
    # positional best(True) would otherwise bind slot=1 silently.
    def clean_decoding(self, slot: Optional[int] = None):
        """Reset all streams (slot=None) or one stream's buffers, left
        context, and hypothesis memory (utterance boundary in a slot)."""
        if self._engine is None:
            return
        if slot is None:
            self._engine.reset()
        else:
            self._engine.reset_slot(slot)

    def decoding_step(self, signal: np.ndarray, *, slot: int = 0):
        """Append `signal` to stream `slot` and advance ALL streams for
        every full window available.  Returns slot's best hypothesis."""
        eng = self._require_engine()
        eng.feed_slot(slot, signal)
        eng.pump()
        return self.best(slot=slot)

    def best(self, *, slot: int = 0, final: bool = False):
        """Best hypothesis of stream `slot` (see ASRPU.best)."""
        if self._engine is None:
            return empty_hypothesis()
        return copy_result(self._engine.slot_best(slot, final=final))

    def serve(self, utterances) -> List[dict]:
        """Continuous batching over whole utterances (audio arrays);
        results in input order.  Delegates to AsrEngine.serve."""
        return self._require_engine().serve(utterances)
