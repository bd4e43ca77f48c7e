"""Serving over a slot pool (port of `repro.serving`: ASR and LM engines).

  * `Session`      — one connection: push(chunk | prompt)/poll()/finish().
  * `AsrEngine`    — streaming ASR: the slot pool, admission queue and the
                     fused slot-batched decoding step.
  * `LmEngine`     — batched LM serving: bucketed masked prefill into a
                     per-slot KV-cache pool, one fused decode step.
  * `EngineConfig` — frozen spec: an `AsrProgram` or `LmProgram` plus
                     pool size, kernel policy and admission/deadline
                     bounds; `make_engine` builds the matching engine.
"""
from repro_torch.serving.asr import AsrEngine
from repro_torch.serving.config import (AsrProgram, EngineConfig, LmProgram,
                                        make_engine)
from repro_torch.serving.engine import (AdmissionRejected, DeadlineExceeded,
                                        Engine, Session, SessionFaulted,
                                        SessionQueue, copy_result,
                                        worker_only)
from repro_torch.serving.lm import LmEngine
from repro_torch.serving.metrics import EngineMetrics

__all__ = [
    "AdmissionRejected", "AsrEngine", "AsrProgram", "DeadlineExceeded",
    "Engine", "EngineConfig", "EngineMetrics", "LmEngine", "LmProgram",
    "Session", "SessionFaulted", "SessionQueue", "copy_result",
    "make_engine", "worker_only",
]
