"""Batched LM serving on the PyTorch port's engine.

The port's counterpart of examples/serve_batched_lm.py: a reduced mamba2
(attention-free: the ASRPU streaming-state model maps directly) served
by `repro_torch.serving.LmEngine` with batched requests.  Each request
is one `Session` (push(prompt) -> poll() for tokens); admission
prefills into a pooled decode cache with per-slot positions, and every
serve step is one decode step over all slots.  Runs on the GPU by
default; `--device cpu` runs the kernels' plain versions.

  PYTHONPATH=src python examples/torch_serve_batched_lm.py \
      [--arch mamba2-1.3b] [--device cpu]

Other arguments are passed to `python -m repro_torch.launch.serve`.
"""
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).parents[1] / "src"))

from repro_torch.launch import serve  # noqa: E402


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    defaults = {"--mode": "lm", "--arch": "mamba2-1.3b", "--requests": "6",
                "--slots": "4", "--prompt-len": "16", "--max-new": "16"}
    for flag, value in defaults.items():
        if flag not in argv:
            argv = [flag, value, *argv]
    return serve.main(argv)


if __name__ == "__main__":
    main()
