"""Serving over a slot pool (port of `repro.serving`: ASR and LM engines).

  * `Session`      — one connection: push(chunk | prompt)/poll()/finish().
  * `AsrEngine`    — streaming ASR: the slot pool, admission queue and the
                     fused slot-batched decoding step.
  * `LmEngine`     — batched LM serving: bucketed masked prefill into a
                     per-slot KV-cache pool, one fused decode step.
  * `EngineConfig` — frozen spec: an `AsrProgram` or `LmProgram` plus
                     pool size, kernel policy, admission/deadline bounds
                     and the fault-tolerance knobs; `make_engine` builds
                     the matching engine.

The network front-end (`EngineServer` in repro_torch.serving.server)
exposes engines over asyncio HTTP chunked streaming, each engine's step
loop on its own `EngineWorker` thread, with worker supervision
(heartbeat watchdog + restart, `WorkerDied`, `GET /healthz`) and
graceful drain.  `FaultPolicy`/`FaultSpec` (repro_torch.serving.faults)
inject deterministic faults at the engines' hazard points.
"""
from repro_torch.serving.asr import AsrEngine
from repro_torch.serving.config import (AsrProgram, EngineConfig, LmProgram,
                                        Program, make_engine)
from repro_torch.serving.engine import (AdmissionRejected, DeadlineExceeded,
                                        Engine, Session, SessionFaulted,
                                        SessionQueue, copy_result,
                                        worker_only)
from repro_torch.serving.faults import (FaultPolicy, FaultSpec,
                                        InjectedFault, WorkerKilled)
from repro_torch.serving.lm import LmEngine
from repro_torch.serving.metrics import EngineMetrics
from repro_torch.serving.server import (AsrClient, EngineServer,
                                        ProtocolError, ServerRejected,
                                        WorkerDied, fetch_healthz,
                                        fetch_metrics, lm_generate)

__all__ = [
    "AdmissionRejected", "AsrClient", "AsrEngine", "AsrProgram",
    "DeadlineExceeded", "Engine", "EngineConfig", "EngineMetrics",
    "EngineServer", "FaultPolicy", "FaultSpec", "InjectedFault",
    "LmEngine", "LmProgram", "Program", "ProtocolError", "ServerRejected",
    "Session", "SessionFaulted", "SessionQueue", "WorkerDied",
    "WorkerKilled", "copy_result", "fetch_healthz", "fetch_metrics",
    "lm_generate", "make_engine", "worker_only",
]
