"""Multi-stream ASR serving on the PyTorch port's engine.

The port's counterpart of examples/serve_multistream_asr.py: a slot pool
of concurrent utterance streams (`repro_torch.serving.AsrEngine`)
advanced by one slot-batched decoding step.  Each utterance is one
`Session`; queued sessions are admitted into freed slots; each slot
keeps its own sample buffer, TDS left context and beam.  Runs on the GPU
by default; `--device cpu` runs the kernels' plain versions.

  PYTHONPATH=src python examples/torch_serve_multistream_asr.py \
      [--streams 4] [--device cpu]

Other arguments are passed to `python -m repro_torch.launch.serve`.
"""
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).parents[1] / "src"))

from repro_torch.launch import serve  # noqa: E402


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    defaults = {"--mode": "asr", "--streams": "4", "--utterances": "6"}
    for flag, value in defaults.items():
        if flag not in argv:
            argv = [flag, value, *argv]
    return serve.main(argv)


if __name__ == "__main__":
    main()
