"""Streaming ASR serving over a slot pool (port of `repro.serving`, ASR part).

  * `Session`      — one connection: push(chunk)/poll()/finish().
  * `AsrEngine`    — owns the slot pool, admission queue and the fused
                     slot-batched decoding step.
  * `EngineConfig` — frozen spec: an `AsrProgram` plus pool size, kernel
                     policy and admission/deadline bounds.
"""
from repro_torch.serving.asr import AsrEngine
from repro_torch.serving.config import AsrProgram, EngineConfig
from repro_torch.serving.engine import (AdmissionRejected, DeadlineExceeded,
                                        Engine, Session, SessionFaulted,
                                        SessionQueue, copy_result,
                                        worker_only)
from repro_torch.serving.metrics import EngineMetrics

__all__ = [
    "AdmissionRejected", "AsrEngine", "AsrProgram", "DeadlineExceeded",
    "Engine", "EngineConfig", "EngineMetrics", "Session", "SessionFaulted",
    "SessionQueue", "copy_result", "worker_only",
]
