"""Training launcher: config -> (mesh ->) LM -> train step -> resilient
loop.  Port of `repro/launch/train.py`.

  PYTHONPATH=src python -m repro_torch.launch.train --arch h2o-danube-1.8b \\
      --tiny --steps 50 --batch 8 --seq 128 --ckpt /tmp/ckpt
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-1.3b \\
      --tiny --steps 20 --device cpu
  PYTHONPATH=src python -m torch.distributed.run --standalone \\
      --nproc-per-node 2 -m repro_torch.launch.train --arch h2o-danube-1.8b \\
      --tiny --steps 3 --mesh local --model-parallel 2 --device cpu

The flags are the reference's, plus `--device` (default: the GPU;
without a card it raises unless given `cpu`).  The model runs
`KernelPolicy("ref")`: the CUDA kernels have no backward.  Parameters
come from the port's own `LM.init` (seed 0), the data from
`SyntheticLM` (a pure function of the step; an architecture that takes
frontend embeddings gets the stub frontend's `stub_embeds` with the
step's labels, as in the reference), and `--resume` restores
{"params", "opt", "step"} from the latest checkpoint, whose format is
the reference's.  `main` returns the list of losses.

`--mesh local|production|multi_pod` and `--model-parallel` as the
reference's.  A world of one rank with `--mesh local` (and
`--model-parallel 1`) runs the one-device path.  Under torchrun, with
one process per rank, the world's ranks form `make_local_mesh(model=
--model-parallel)` or the production mesh (which needs 256 or 512
ranks): every rank draws the parameters as the one-device run does
(`LM.init_local`: each leaf whole from seed 0, the rank's block kept),
takes its block of the step's global batch and steps
`make_train_step` on the mesh (accum 1, as the reference's launcher);
rank 0 logs, and every rank returns the same losses.

`--ckpt` and `--resume` work on a world of any size: a mesh's
checkpoint holds the whole leaves (rank 0 writes them, gathered one at
a time), in the reference's format, and `--resume` restores through
`runtime.elastic.replace_state`, each rank cutting its blocks of the
whole leaves.  So a run may resume on another mesh than the one that
saved it (an elastic restart: 2x2 to 1x2, or a mesh to one device), and
the reference's launcher may resume it too.  `run_resilient`'s restore
escalation under a mesh is served when every rank raises
`TransientError` at the same step (SPMD cannot mend a failure one rank
sees alone; `runtime/elastic.py`).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.ckpt.checkpoint import Checkpointer
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.device import fp32_numerics, resolve_device
from repro_torch.kernels.policy import KernelPolicy
from repro_torch.launch import mesh as meshlib
from repro_torch.launch.steps import build_lm, make_train_step
from repro_torch.optim import adamw
from repro_torch.parallel import sharding as shlib
from repro_torch.runtime import fault
from repro_torch.runtime.elastic import (mesh_invariant_rng, replace_state,
                                         state_specs)


def stub_embeds(step: int, batch: int, seq: int, d_model: int) -> torch.Tensor:
    """The frontend stub's embeddings for `step`: standard normal draws of
    `np.random.default_rng(step)` in fp32, rounded to bf16 (half to even,
    as numpy's `astype`), (batch, seq, d_model), the reference's batch
    bit for bit."""
    rng = np.random.default_rng(step)
    emb = rng.normal(0, 1, (batch, seq, d_model)).astype(np.float32)
    return torch.from_numpy(emb).to(torch.bfloat16)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--tiny", action="store_true",
                    help="reduced config (CPU smoke / examples)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--mesh", default="local", choices=["local", "production",
                                                        "multi_pod"])
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--moment-dtype", default="float32")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' runs on "
                         "the CPU)")
    args = ap.parse_args(argv)

    # before any draw: init must be a function of the seed, not of the
    # mesh (a no-op in the port; see runtime/elastic.py)
    mesh_invariant_rng()
    cfg = get_config(args.arch)
    if args.tiny:
        cfg = cfg.tiny()
    opt_cfg = adamw.AdamWConfig(lr=args.lr, moment_dtype=args.moment_dtype)
    mesh = own_world = None
    multi_pod = args.mesh == "multi_pod"
    if meshlib.world_size() == 1:
        if args.mesh != "local":
            meshlib.make_production_mesh(multi_pod=multi_pod)  # raises: a
            # production mesh needs 256 or 512 ranks
        if args.model_parallel != 1:
            meshlib.make_local_mesh(model=args.model_parallel)  # raises
        device = resolve_device(args.device)
    else:
        own_world = not torch.distributed.is_initialized()
        device = meshlib.init_ranks(args.device)
        mesh = (meshlib.make_local_mesh(model=args.model_parallel)
                if args.mesh == "local" else
                meshlib.make_production_mesh(multi_pod=multi_pod))
    fp32_numerics()
    rank0 = meshlib.is_rank0()
    gen = torch.Generator(device=device).manual_seed(0)
    # mesh None: the one-device LM, step and optimizer
    lm = build_lm(cfg, mesh, KernelPolicy("ref"))
    train_step = make_train_step(
        lm, opt_cfg, remat=True,
        shape=ShapeSpec("train", args.seq, args.batch, "train"))
    params = lm.init(gen) if mesh is None else lm.init_local(gen)
    specs = (None if mesh is None
             else state_specs(cfg, mesh, args.moment_dtype))
    opt = adamw.init(params, opt_cfg, mesh=mesh,
                     specs=None if mesh is None else specs["opt"])
    if mesh is not None:
        b_spec = shlib.batch_shardings(
            {"x": torch.empty((args.batch,), device="meta")}, mesh)["x"]
    state = {"params": params, "opt": opt,
             "step": torch.zeros((), dtype=torch.int32, device=device)}
    del params, opt
    data = SyntheticLM(DataConfig(cfg.vocab_size, args.seq, args.batch))
    ckpt = (Checkpointer(args.ckpt, mesh=mesh, specs=specs) if args.ckpt
            else None)
    start = 0
    if ckpt and args.resume and ckpt.latest_step() is not None:
        start = ckpt.latest_step()
        # the checkpoint may come from another mesh: each rank cuts its
        # blocks of the whole leaves
        state = replace_state(cfg, ckpt, state, mesh, step=start)
        if rank0:
            print(f"resumed from step {start}", flush=True)

    losses = []

    def one_step(state, step):
        batch = {k: torch.from_numpy(v) for k, v in data.batch(step).items()}
        if not cfg.embed_inputs:   # frontend stub: embed synthetically
            batch = {"embeds": stub_embeds(step, args.batch, args.seq,
                                           cfg.d_model),
                     "labels": batch["labels"]}
        if mesh is not None:       # this rank's rows of the global batch
            batch = {k: shlib.local_block(
                v, b_spec + (None,) * (v.dim() - 1), mesh)
                for k, v in batch.items()}
        return train_step(state, {k: v.to(device) for k, v in batch.items()})

    def log(step, metrics, dt):
        # keep the device tensor: float() here would wait for the card
        # every step, serializing host and device; coerce only at the
        # log boundary (and once at the end)
        losses.append(metrics["loss"])
        if rank0 and (step + 1) % args.log_every == 0:
            print(f"step {step+1} loss {float(losses[-1]):.6f} "
                  f"({dt*1e3:.0f} ms)", flush=True)

    t0 = time.time()
    try:
        state, stats = fault.run_resilient(
            one_step, state, start, args.steps, checkpointer=ckpt,
            ckpt_every=args.ckpt_every, watchdog=fault.StepWatchdog(),
            heartbeat=None, on_metrics=log)
    finally:
        if own_world:
            torch.distributed.destroy_process_group()
    losses[:] = [float(v) for v in losses]
    dt = time.time() - t0
    if rank0:
        print(f"done: {args.steps} steps in {dt:.1f}s; "
              f"loss {losses[0]:.4f} -> {losses[-1]:.4f}; stats={stats}")
    return losses


if __name__ == "__main__":
    main()
