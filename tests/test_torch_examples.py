"""The port's examples run end to end on the CPU.

`examples/torch_quickstart.py`, `examples/torch_serve_multistream_asr.py`,
`examples/torch_train_and_transcribe_asr.py`, `examples/torch_train_lm.py`
and `examples/torch_serve_batched_lm.py` (the port's counterparts of the
examples of the same names without `torch_`) each run in a subprocess
with `--device cpu`, from an unrelated working directory, and must print
their result lines and exit 0.  The LM trainer runs 60 steps instead of
its 200 (its resume 6) to stay well inside the test budget.
"""
import os
import pathlib
import re
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("script, expect", [
    ("torch_quickstart.py",
     [r"decoding step plan on cpu: 1280 samples",
      r"decoded \d+\.\d+s of audio in \d+ decoding steps",
      r"best hypothesis: words=\[[\d, ]*\] tokens=\[[\d, ]*\] "
      r"score=-\d+\.\d+"]),
    ("torch_serve_multistream_asr.py",
     [r"utt 5: \d+\.\d+s audio, steps=\d+, best words=",
      r"served 6 utterances \(\d+\.\d+s audio\) over 4 streams on cpu"]),
])
def test_example_runs_on_the_cpu(tmp_path, script, expect):
    env = dict(os.environ, HOME=str(tmp_path))
    env.pop("PYTHONPATH", None)        # the example sets its own path
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / script), "--device", "cpu"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    for pattern in expect:
        assert re.search(pattern, out.stdout), (pattern, out.stdout)


@pytest.mark.parametrize("script, args, expect", [
    ("torch_train_and_transcribe_asr.py", [],
     [r"training TDS \(\d+ params\) with CTC on cpu",
      r"step 120: ctc loss \d+\.\d+",
      r"held-out WER: \d+\.\d+"]),
    ("torch_train_lm.py", ["--steps", "60"],
     [r"resumed from step 60", r"done: 6 steps",
      r"OK: trained \+ checkpoint-resumed"]),
    ("torch_serve_batched_lm.py", [],
     [r"served 6 requests, 96 tokens, \d+ decode steps on cpu"]),
])
def test_training_and_lm_examples_run_on_the_cpu(tmp_path, script, args,
                                                   expect):
    env = dict(os.environ, HOME=str(tmp_path), TMPDIR=str(tmp_path))
    env.pop("PYTHONPATH", None)        # the example sets its own path
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / script), "--device", "cpu",
         *args], cwd=tmp_path, env=env, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    for pattern in expect:
        assert re.search(pattern, out.stdout), (pattern, out.stdout)
