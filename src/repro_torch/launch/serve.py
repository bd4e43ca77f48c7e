"""Serving launcher, port of the asr and lm modes of `repro/launch/serve.py`.

  * --mode asr : the paper's system as an `AsrEngine`: sessions stream
                 80 ms audio chunks via Session.push/poll/finish; with
                 --streams N > 1 the N-slot pool decodes N concurrent
                 utterances through one slot-batched step.
  * --mode lm  : batched LM serving (`LmEngine`) of the tiny config of
                 --arch (mamba2-1.3b by default, as in the reference; any
                 dense, MoE, SSM or hybrid arch, not the M-RoPE or
                 frontend-embedding ones), --requests prompts over
                 --slots slots.
  * --serve    : the network front-end (`serving.server.EngineServer`):
                 the asr engine over --streams slots and the tiny LM of
                 --arch over --slots slots, served over HTTP/1.1 until
                 SIGTERM/SIGINT, which drains in-flight sessions; with
                 --mesh, the asr engine sharded over torchrun's ranks
                 (rank 0 serves and leads, the others follow).
Runs on the GPU unless --device names another.

  PYTHONPATH=src python -m repro_torch.launch.serve --mode asr --utterances 3
  PYTHONPATH=src python -m repro_torch.launch.serve --mode asr --streams 4
  PYTHONPATH=src python -m repro_torch.launch.serve --mode asr --streams 4 --int8
  PYTHONPATH=src python -m repro_torch.launch.serve --mode lm --requests 3 \
      --slots 2 --prompt-len 8 --max-new 4
  PYTHONPATH=src python -m repro_torch.launch.serve --serve --streams 4 \
      --port 0 --max-queue 4 --watchdog 30
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.serve \
      --mode asr --streams 4 --mesh 2x2
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.serve \
      --serve --streams 4 --mesh 2x2 --port 0 --watchdog 30

`--mesh N` runs the ASR step model-parallel over N ranks, one process
each (torchrun): every TDS FC/head weight is split over the ranks on
its feature axis, each rank contracts its slice and the partial
products are all-reduced.  `--mesh RxC` makes the mesh 2D ('data',
'model'): the slot pool splits over the R-way 'data' axis (each data
shard decodes n_slots/R slots, with no 'data' collectives), weights over
the C-way 'model' axis.  `--overlap-psum` chunks each all-reduce so it
runs under the next chunk's product.  Only rank 0 prints.

`--serve --mesh` serves the sharded ASR engine over the network: rank 0
binds the server, with the tiny LM engine unsharded on its own card, and
leads every engine decision (admissions, readouts, session deadlines,
watchdog restarts); every other rank builds the same sharded engine and
replays rank 0's command stream (`serving.server.follow`).  torchrun
forwards SIGTERM to every rank: rank 0 drains, its stop message ends the
others' replay, and every rank leaves the world and exits 0.  A failure
that only some ranks see cannot be mended in SPMD: a follower that loses
rank 0 or falls out of step exits non-zero naming the message and the
command, and rank 0 stops serving and exits non-zero when its stream
breaks.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.device import rank_device
from repro_torch.kernels.policy import MODES, KernelPolicy
from repro_torch.launch import mesh as meshlib
from repro_torch.serving import (AsrEngine, AsrProgram, EngineConfig,
                                 LmEngine, LmProgram)


def serve_mesh(spec, device=None):
    """`--mesh` spec -> a serving `Mesh`, or None for the single-device
    engine.

      * N (int or "N") : a 1-axis ('model',) mesh over N ranks; N <= 1 ->
                         None.
      * "RxC"          : a 2-axis ('data', 'model') mesh over R*C ranks:
                         the slot pool splits over the R-way 'data' axis,
                         FC/head weights over the C-way 'model' axis.
                         "1x1" -> a real 1x1 mesh (the 2D step on one
                         rank).

    A mesh of more than one rank initializes this process's rank from
    torchrun's environment (`launch.mesh.init_ranks`), binding it to
    `device` (default: its card); the world must hold exactly the
    mesh's ranks."""
    if isinstance(spec, str) and "x" in spec:
        try:
            r, c = (int(v) for v in spec.split("x"))
        except ValueError:
            raise SystemExit(f"--mesh {spec!r}: expected N or RxC")
        if r < 1 or c < 1:
            raise SystemExit(f"--mesh {spec!r}: axes must be >= 1")
        shape, names = (r, c), ("data", "model")
    else:
        n_model = int(spec)
        if n_model <= 1:
            return None
        shape, names = (n_model,), ("model",)
    n = int(np.prod(shape))
    world = meshlib.world_size()
    if world != n:
        raise SystemExit(
            f"--mesh {spec} needs {n} ranks but the world has {world}: "
            f"launch one process per rank, as torchrun --nproc-per-node "
            f"{n} -m repro_torch.launch.serve ... --mesh {spec}")
    if n > 1:
        meshlib.init_ranks(device)
    return meshlib.make_mesh(shape, names)


def _say(*args, **kwargs) -> None:
    """print, on rank 0 only."""
    if meshlib.is_rank0():
        print(*args, **kwargs)


def asr_demo_system():
    """Small-TDS ASR system shared by the asr serving paths (same
    structure as the reference's demo system; the random weights come
    from a seeded torch.Generator, so they differ from the reference's)."""
    from repro_torch.configs.tds_asr import DECODER_CONFIG, TDSConfig, TDSStage
    from repro_torch.core import lexicon as lx
    from repro_torch.models import tds

    # small TDS so it runs fast on the CPU; same kernel structure
    tds_cfg = TDSConfig(
        stages=(TDSStage(1, 4, 80, 9, 2), TDSStage(1, 4, 80, 9, 2),
                TDSStage(1, 6, 80, 9, 2)),
        vocab_size=32)
    words = {f"w{i}": [1 + (i * 3 + j) % 30 for j in range(2 + i % 3)]
             for i in range(12)}
    lex = lx.build_lexicon(words, max_children=16)
    lm = lx.uniform_bigram(len(words))
    params = tds.init_tds(torch.Generator().manual_seed(0), tds_cfg)
    return tds_cfg, words, lex, lm, params, DECODER_CONFIG


def asr_demo_engine(n_slots: int, kernels: KernelPolicy = None,
                    device=None, max_queue=None, session_deadline=None,
                    system=None, use_int8: bool = False,
                    worker_watchdog=None, faults=None, mesh=None,
                    overlap_psum: bool = False) -> tuple:
    """(engine, words): an AsrEngine over the demo system's program at
    beam 25.  `system` replaces the demo system's tuple (e.g. with
    parameters carried across from the reference); `use_int8` serves the
    int8 program (FC/head products through the int8 kernel);
    `max_queue`, `session_deadline`, `worker_watchdog` and `faults` are
    `EngineConfig`'s admission and fault-tolerance knobs; `mesh` (see
    `serve_mesh`) shards the step, `overlap_psum` chunks its
    all-reduces."""
    tds_cfg, words, lex, lm, params, dec_cfg = (
        system if system is not None else asr_demo_system())
    program = AsrProgram(tds_cfg, lex, lm, dec_cfg=dec_cfg,
                         use_int8=use_int8).with_beam_width(25.0)
    engine = AsrEngine(EngineConfig(program, n_slots=n_slots,
                                    kernels=kernels or KernelPolicy(),
                                    mesh=mesh, max_queue=max_queue,
                                    overlap_psum=overlap_psum,
                                    session_deadline=session_deadline,
                                    worker_watchdog=worker_watchdog,
                                    faults=faults),
                       params, device=device)
    return engine, words


def serve_asr(args):
    """Single-stream streaming ASR: one Session per utterance, pushing
    80 ms chunks; poll() tracks the live best hypothesis."""
    from repro_torch.data.pipeline import SyntheticASR

    engine, words = asr_demo_engine(1, KernelPolicy(args.kernels),
                                    device=args.device, use_int8=args.int8,
                                    mesh=args.serving_mesh,
                                    overlap_psum=args.overlap_psum)
    data = SyntheticASR(words)
    spp = engine.plan.samples_per_step
    n_utts = 2 if args.utterances is None else args.utterances
    for u in range(n_utts):
        utt = data.utterance(u)
        t0 = time.time()
        audio = utt["audio"]
        session = engine.open()
        for off in range(0, len(audio), spp):
            session.push(audio[off:off + spp])
            session.poll()
        best = session.finish()
        dt = time.time() - t0
        rtf = dt / (len(audio) / 16000)
        _say(f"utt {u}: {len(audio)/16000:.2f}s audio, decoded in {dt:.2f}s "
             f"(RTF {rtf:.2f}) on {engine.device}, steps={best['steps']}, "
             f"best words={best['words'].tolist()} score={best['score']:.2f} "
             f"(ref={utt['words'].tolist()})")


def serve_asr_multistream(args):
    """Multi-stream ASR serving: a B-slot pool of concurrent utterance
    streams, one slot-batched step advancing the eligible slots."""
    from repro_torch.data.pipeline import SyntheticASR

    engine, words = asr_demo_engine(args.streams, KernelPolicy(args.kernels),
                                    device=args.device, use_int8=args.int8,
                                    mesh=args.serving_mesh,
                                    overlap_psum=args.overlap_psum)
    data = SyntheticASR(words)
    n_utts = args.utterances if args.utterances is not None \
        else max(args.streams, 2)
    utts = [data.utterance(u) for u in range(n_utts)]
    audio_s = sum(len(u["audio"]) for u in utts) / 16000
    t0 = time.time()
    results = engine.serve([u["audio"] for u in utts])
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    dt = time.time() - t0
    for u, (utt, best) in enumerate(zip(utts, results)):
        _say(f"utt {u}: {len(utt['audio'])/16000:.2f}s audio, "
             f"steps={best['steps']}, best words={best['words'].tolist()} "
             f"score={best['score']:.2f} (ref={utt['words'].tolist()})")
    mesh = args.serving_mesh
    _say(f"served {n_utts} utterances ({audio_s:.2f}s audio) over "
         f"{args.streams} streams on {engine.device}"
         f"{'' if mesh is None else f' ({mesh.size} ranks, {mesh.shape})'} "
         f"in {dt:.2f}s: {engine.n_steps} decoding steps, RTF "
         f"{dt/audio_s:.2f}, throughput {audio_s/dt:.2f}x realtime")
    return results


def serve_lm(args):
    """Batched LM serving of the tiny config of `args.arch`: prompts of
    varying lengths (so bucketed admission is exercised) over an
    `args.slots`-slot pool.  Returns {request index: tokens}."""
    from repro_torch.configs import get_config
    from repro_torch.models import LM

    cfg = get_config(args.arch).tiny()
    params = LM(cfg).init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    plens = [max(1, args.prompt_len - (i % 4)) for i in range(args.requests)]
    prompts = [rng.integers(1, cfg.vocab_size, n) for n in plens]
    program = LmProgram(cfg, cache_len=args.prompt_len + args.max_new,
                        max_new=args.max_new)
    engine = LmEngine(EngineConfig(program, n_slots=args.slots,
                                   kernels=KernelPolicy(args.kernels)),
                      params, device=args.device)
    t0 = time.time()
    outputs = engine.serve(prompts)
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    dt = time.time() - t0
    total_tokens = sum(len(v) for v in outputs)
    print(f"served {len(outputs)} requests, {total_tokens} tokens, "
          f"{engine.n_steps} decode steps on {engine.device} in {dt:.2f}s "
          f"({total_tokens/dt:.1f} tok/s) over buckets {program.buckets()}")
    return dict(enumerate(outputs))


def serve_network(args):
    """`--serve`: bind the asyncio network front-end over the demo ASR
    engine and the tiny LM engine of `args.arch`, and serve until
    interrupted.  Each engine's step loop runs on its own EngineWorker
    thread (see repro_torch.serving.server).  On a card the kernel
    library is built before the server starts (on a mesh by rank 0,
    before the others load it), so that a first step's build never
    counts against the heartbeat watchdog.

    SIGTERM/SIGINT trigger a graceful drain: the listener stops
    accepting, in-flight sessions run to their final result (bounded by
    --drain-timeout), then the workers stop.  With `--mesh` see the
    module docstring: ranks other than 0 only follow."""
    import torch.distributed as dist

    from repro_torch.kernels import _build

    mesh = serve_mesh(args.mesh, args.device)
    multi = mesh is not None and mesh.size > 1
    if multi and rank_device(args.device).type == "cuda":
        if meshlib.is_rank0():
            _build.lib()
        dist.barrier()
    asr_engine, _ = asr_demo_engine(args.streams, KernelPolicy(args.kernels),
                                    device=args.device,
                                    max_queue=args.max_queue,
                                    session_deadline=args.session_deadline,
                                    use_int8=args.int8,
                                    worker_watchdog=args.watchdog,
                                    mesh=mesh,
                                    overlap_psum=args.overlap_psum)
    channel = meshlib.make_channel() if multi else None
    if multi and not meshlib.is_rank0():
        return _follow_network(asr_engine, channel)
    server = _serve_network(args, asr_engine, mesh, channel)
    if multi:
        if server.fatal is None:
            dist.barrier()
        dist.destroy_process_group()
    if server.fatal is not None:
        raise SystemExit(f"[rank 0] {server.fatal}")


def _follow_network(asr_engine, channel) -> None:
    """A rank other than 0 under `--serve --mesh`: replay rank 0's
    command stream until its stop message.  SIGTERM and SIGINT (torchrun
    forwards them to every rank) only say so: rank 0's drain decides
    when the stream ends."""
    import signal

    import torch.distributed as dist

    from repro_torch.serving.server import FollowerFailed, follow

    rank = dist.get_rank()

    def note(sig, _frame):
        print(f"[rank {rank}] {signal.Signals(sig).name}: following rank "
              f"0's command stream until its stop message", flush=True)
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, note)
    try:
        stats = follow(asr_engine, channel)
    except FollowerFailed as exc:
        raise SystemExit(f"[rank {rank}] {exc}")
    print(f"[rank {rank}] stopped by rank 0: {stats['messages']} "
          f"messages, {stats['commands']} commands, "
          f"{stats['keepalives']} keep-alives replayed", flush=True)
    dist.barrier()
    dist.destroy_process_group()


def _serve_network(args, asr_engine, mesh, channel):
    """Rank 0 (or the only rank): the server over the ASR engine and
    the tiny, unsharded LM engine, until SIGTERM/SIGINT; returns the
    closed server."""
    import asyncio
    import signal

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.models import LM
    from repro_torch.serving.server import EngineServer

    lm_cfg = get_config(args.arch).tiny()
    lm_program = LmProgram(lm_cfg, cache_len=args.prompt_len + args.max_new,
                           max_new=args.max_new)
    lm_engine = LmEngine(
        EngineConfig(lm_program, n_slots=args.slots,
                     kernels=KernelPolicy(args.kernels),
                     max_queue=args.max_queue,
                     session_deadline=args.session_deadline,
                     worker_watchdog=args.watchdog),
        LM(lm_cfg).init(torch.Generator().manual_seed(0)),
        device=args.device)
    if asr_engine.device.type == "cuda":
        _build.lib()
    server = EngineServer(asr_engine=asr_engine, lm_engine=lm_engine,
                          host=args.host, port=args.port,
                          asr_idle_timeout=args.idle_timeout,
                          channel=channel)
    sharded = ("" if mesh is None else
               f", mesh {dict(mesh.shape)} over {mesh.size} ranks")

    async def run():
        await server.start()
        stop = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                loop.add_signal_handler(sig, stop.set)
            except (NotImplementedError, RuntimeError):
                pass             # platform without loop signal handlers
        print(f"serving ASR ({args.streams} slots{sharded}) + LM "
              f"({args.slots} slots) on http://{server.host}:{server.port} "
              f"(max_queue={args.max_queue}, watchdog={args.watchdog}, "
              f"session_deadline={args.session_deadline}); POST /asr, "
              f"POST /lm, GET /metrics, GET /healthz", flush=True)
        try:
            serve = asyncio.ensure_future(server.serve_forever())
            stopper = asyncio.ensure_future(stop.wait())
            await asyncio.wait({serve, stopper},
                               return_when=asyncio.FIRST_COMPLETED)
            serve.cancel()
            stopper.cancel()
            if stop.is_set():
                print("signal received: draining in-flight sessions ...",
                      flush=True)
        finally:
            await server.aclose(drain=True, timeout=args.drain_timeout)
            print("drained; server stopped", flush=True)

    try:
        asyncio.run(run())
    except KeyboardInterrupt:
        pass
    return server


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", default="asr", choices=["lm", "asr"])
    ap.add_argument("--arch", default="mamba2-1.3b",
                    help="LM arch, served at its tiny() size: dense "
                         "(h2o-danube-1.8b, qwen2-72b, chatglm3-6b), MoE "
                         "(qwen2-moe-a2.7b, llama4-maverick-400b-a17b), SSM "
                         "(mamba2-1.3b) or hybrid (jamba-v0.1-52b); not "
                         "qwen2-vl-7b (M-RoPE) or musicgen-medium "
                         "(frontend embeddings)")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--utterances", type=int, default=None,
                    help="utterance count (default: 2, or one per slot "
                         "when --streams > 1)")
    ap.add_argument("--streams", type=int, default=1,
                    help="slot-pool size; >1 uses the batched multi-stream "
                         "scheduler")
    ap.add_argument("--kernels", default="auto", choices=list(MODES),
                    help="KernelPolicy for the kernel-backed decode ops "
                         "(auto: CUDA kernels on the GPU, plain torch on "
                         "the CPU)")
    ap.add_argument("--int8", action="store_true",
                    help="serve the int8 program (ASRPU's 8-bit MAC: "
                         "FC/head products through the int8 kernel)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' runs the "
                         "plain versions on the CPU)")
    ap.add_argument("--mesh", type=str, default="1", metavar="N|RxC",
                    help="--mode asr and --serve parallel spec over "
                         "torchrun's ranks: N splits every TDS FC/head "
                         "weight over N ranks ('model' axis); RxC also "
                         "splits the slot pool over an R-way 'data' axis "
                         "(C-way 'model'); 1 = the single-device engine")
    ap.add_argument("--overlap-psum", action="store_true",
                    help="sharded ASR step: chunk each model-axis "
                         "all-reduce so it runs under the next chunk's "
                         "product (~1e-6 from the synchronous one)")
    ap.add_argument("--serve", action="store_true",
                    help="run the asyncio network front-end (HTTP "
                         "chunked streaming over the demo ASR + LM "
                         "engines) instead of the in-process demos")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8300,
                    help="--serve listen port (0 picks a free port)")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="admission backpressure bound: with every slot "
                         "busy and this many sessions queued, new "
                         "sessions get HTTP 503 (default: unbounded)")
    ap.add_argument("--watchdog", type=float, default=None,
                    help="--serve: seconds an engine worker's heartbeat "
                         "may age before the supervisor declares it "
                         "wedged and restarts it (default: only dead "
                         "threads restart)")
    ap.add_argument("--session-deadline", type=float, default=None,
                    help="--serve: seconds a session may live from "
                         "open() before the pump reaps it "
                         "(DeadlineExceeded; default: no deadline)")
    ap.add_argument("--idle-timeout", type=float, default=None,
                    help="--serve: seconds /asr waits for the next "
                         "command chunk before freeing a silent "
                         "client's slot (default: wait forever)")
    ap.add_argument("--drain-timeout", type=float, default=30.0,
                    help="--serve: bound on the SIGTERM graceful drain "
                         "(seconds; in-flight sessions finishing)")
    args = ap.parse_args(argv)
    if args.mesh not in ("1", "0") and not args.serve:
        if args.mode == "lm":
            ap.error("--mesh is ASR-only (LmEngine rejects a mesh; "
                     "sharded LM serving goes through launch/steps.py "
                     "build_cell)")
    if args.serve:
        return serve_network(args)
    if args.mode == "lm":
        return serve_lm(args)
    args.serving_mesh = serve_mesh(args.mesh, args.device)
    try:
        if args.streams > 1:
            return serve_asr_multistream(args)
        return serve_asr(args)
    finally:
        if args.serving_mesh is not None and args.serving_mesh.size > 1:
            torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
