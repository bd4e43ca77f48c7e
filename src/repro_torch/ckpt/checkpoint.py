"""Checkpointing: atomic, async, resumable; port of `repro/ckpt/checkpoint.py`
with the same on-disk format, so that a state written by either package
restores in the other.

  * Layout: `step_<9 digits>/` holds one `.npy` per leaf, named by the
    leaf's `/`-joined dict-key / list-index path with `/` written as
    `__`, and `manifest.json` ({"step", "leaves": {path: {"file",
    "shape", "dtype"}}}).  bfloat16 leaves (numpy has no such type) are
    stored as their uint16 bits and named `bfloat16` in the manifest.
  * Atomic: a step is written to `step_<n>.tmp/` and committed with
    `os.replace`; a crash mid-save never corrupts the latest good
    checkpoint, and a stale `.tmp` is ignored.
  * Async: `save_async` copies every tensor to host numpy synchronously
    (so later steps may reuse the device buffers), then writes in a
    background thread, overlapping the I/O with the next steps.
  * GC keeps the last `keep` steps.
"""
from __future__ import annotations

import json
import os
import pathlib
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core.treeutil import leaves_with_paths, map_with_paths


def _key(path) -> str:
    return "/".join(str(k) for k in path)


def _to_host(t) -> np.ndarray:
    """A host copy of one leaf (bfloat16 as an ml_dtypes-free uint16
    view of its bits; the caller's manifest names the dtype)."""
    if not isinstance(t, torch.Tensor):
        return np.array(t)
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None

    # ---------------- save ----------------
    @staticmethod
    def _snapshot(state: Any) -> dict:
        """{path key: (host array, dtype name)} of every leaf."""
        out = {}
        for path, leaf in leaves_with_paths(state):
            dtype = (str(leaf.dtype).replace("torch.", "")
                     if isinstance(leaf, torch.Tensor) else None)
            arr = _to_host(leaf)
            out[_key(path)] = (arr, dtype or str(arr.dtype))
        return out

    def save(self, step: int, state: Any):
        self._write(step, self._snapshot(state))

    def save_async(self, step: int, state: Any):
        self.wait()
        host = self._snapshot(state)
        self._thread = threading.Thread(
            target=self._write, args=(step, host), daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, host: dict):
        tmp = self.dir / f"step_{step:09d}.tmp"
        final = self.dir / f"step_{step:09d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest = {}
        for key, (arr, dtype) in host.items():
            fname = key.replace("/", "__") + ".npy"
            np.save(tmp / fname, arr)
            manifest[key] = {"file": fname, "shape": list(arr.shape),
                             "dtype": dtype}
        (tmp / "manifest.json").write_text(json.dumps(
            {"step": step, "leaves": manifest}))
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)          # atomic commit
        self._gc()

    def _gc(self):
        steps = sorted(self.all_steps())
        for s in steps[:-self.keep]:
            shutil.rmtree(self.dir / f"step_{s:09d}", ignore_errors=True)

    # ---------------- restore ----------------
    def all_steps(self):
        out = []
        for p in self.dir.glob("step_*"):
            if p.suffix == ".tmp" or not (p / "manifest.json").exists():
                continue
            out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, state_template: Any, step: Optional[int] = None) -> Any:
        """Restore into the template's structure: each leaf on its
        template leaf's device and in its dtype."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint found in {self.dir}")
        d = self.dir / f"step_{step:09d}"
        manifest = json.loads((d / "manifest.json").read_text())["leaves"]

        def load(path, tmpl):
            entry = manifest[_key(path)]
            arr = np.load(d / entry["file"])
            if "bfloat16" in entry["dtype"]:
                t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
            else:
                t = torch.from_numpy(arr)
            if isinstance(tmpl, torch.Tensor):
                t = t.to(device=tmpl.device, dtype=tmpl.dtype)
            return t
        return map_with_paths(load, state_template)
