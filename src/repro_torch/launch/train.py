"""Training launcher on one device: config -> LM -> train step -> resilient
loop.  Port of `repro/launch/train.py` without its mesh.

  PYTHONPATH=src python -m repro_torch.launch.train --arch h2o-danube-1.8b \\
      --tiny --steps 50 --batch 8 --seq 128 --ckpt /tmp/ckpt
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-1.3b \\
      --tiny --steps 20 --device cpu

The flags are the reference's, less `--mesh` and `--model-parallel`
(multi-device training is ROADMAP Queue 1, item 11), plus `--device`
(default: the GPU; without a card it raises unless given `cpu`).  The
model runs `KernelPolicy("ref")`: the CUDA kernels have no backward.
Parameters come from the port's own `LM.init` (seed 0), the data from
`SyntheticLM` (a pure function of the step; an architecture that takes
frontend embeddings gets the stub frontend's `stub_embeds` with the
step's labels, as in the reference), and `--resume` restores
{"params", "opt", "step"} from the latest checkpoint, whose format is
the reference's.  `main` returns the list of losses.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.ckpt.checkpoint import Checkpointer
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.device import fp32_numerics, resolve_device
from repro_torch.kernels.policy import KernelPolicy
from repro_torch.launch.steps import make_train_step
from repro_torch.models.transformer import LM
from repro_torch.optim import adamw
from repro_torch.runtime import fault


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
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--moment-dtype", default="float32")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' runs on "
                         "the CPU)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    fp32_numerics()
    cfg = get_config(args.arch)
    if args.tiny:
        cfg = cfg.tiny()
    lm = LM(cfg, KernelPolicy("ref"))
    opt_cfg = adamw.AdamWConfig(lr=args.lr, moment_dtype=args.moment_dtype)
    train_step = make_train_step(lm, opt_cfg, remat=True)

    gen = torch.Generator(device=device).manual_seed(0)
    params = lm.init(gen)
    state = {"params": params, "opt": adamw.init(params, opt_cfg),
             "step": torch.zeros((), dtype=torch.int32, device=device)}
    del params
    data = SyntheticLM(DataConfig(cfg.vocab_size, args.seq, args.batch))
    ckpt = Checkpointer(args.ckpt) if args.ckpt else None
    start = 0
    if ckpt and args.resume and ckpt.latest_step() is not None:
        start = ckpt.latest_step()
        state = ckpt.restore(state, step=start)
        print(f"resumed from step {start}")

    losses = []

    def one_step(state, step):
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in data.batch(step).items()}
        if not cfg.embed_inputs:   # frontend stub: embed synthetically
            batch = {"embeds": stub_embeds(step, args.batch, args.seq,
                                           cfg.d_model).to(device),
                     "labels": batch["labels"]}
        return train_step(state, batch)

    def log(step, metrics, dt):
        # keep the device tensor: float() here would wait for the card
        # every step, serializing host and device; coerce only at the
        # log boundary (and once at the end)
        losses.append(metrics["loss"])
        if (step + 1) % args.log_every == 0:
            print(f"step {step+1} loss {float(losses[-1]):.4f} "
                  f"({dt*1e3:.0f} ms)", flush=True)

    t0 = time.time()
    state, stats = fault.run_resilient(
        one_step, state, start, args.steps, checkpointer=ckpt,
        ckpt_every=args.ckpt_every, watchdog=fault.StepWatchdog(),
        heartbeat=None, on_metrics=log)
    losses[:] = [float(v) for v in losses]
    dt = time.time() - t0
    print(f"done: {args.steps} steps in {dt:.1f}s; "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f}; stats={stats}")
    return losses


if __name__ == "__main__":
    main()
