"""End-to-end LM training on the PyTorch port: train a reduced LM with
the port's train loop (AdamW, checkpoint/restart, straggler watchdog).

The port's counterpart of examples/train_lm.py: ~200 steps of a tiny
h2o-danube (llama-family, sliding window) on synthetic data, then a
resume from the checkpoint.  Runs on the GPU by default; `--device cpu`
runs on the CPU.  Training always uses the kernels' plain versions
(`KernelPolicy("ref")`): the CUDA kernels have no backward.

  PYTHONPATH=src python examples/torch_train_lm.py [--device cpu] \
      [--steps 200]
"""
import argparse
import pathlib
import sys
import tempfile

sys.path.insert(0, str(pathlib.Path(__file__).parents[1] / "src"))

from repro_torch.launch import train  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    ap.add_argument("--steps", type=int, default=200)
    args = ap.parse_args(argv)
    common = ["--arch", "h2o-danube-1.8b", "--tiny", "--batch", "8",
              "--seq", "64"]
    if args.device is not None:
        common += ["--device", args.device]
    with tempfile.TemporaryDirectory(prefix="repro_torch_ckpt_") as ckpt:
        every = max(1, args.steps // 2)
        losses = train.main(common + [
            "--steps", str(args.steps), "--lr", "1e-3", "--ckpt", ckpt,
            "--ckpt-every", str(every),
            "--log-every", str(max(1, args.steps // 4))])
        assert losses[-1] < losses[0], "loss should decrease"
        resume = max(1, args.steps // 10)
        print(f"resuming from checkpoint for {resume} more steps...")
        train.main(common + ["--steps", str(resume), "--ckpt", ckpt,
                             "--resume",
                             "--log-every", str(max(1, resume // 2))])
    print("OK: trained + checkpoint-resumed")


if __name__ == "__main__":
    main()
