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
  * Under a mesh (`mesh`: this rank's view; `specs`: the state's spec
    tree) every rank holds its blocks, and the file is the same: the
    logical (whole) leaves.  A save gathers one leaf at a time
    (`sharding.gather_dims`) on every rank, in the same order, on the
    calling thread (a collective in the writer's thread would interleave
    with the next step's), and rank 0 alone keeps the host copy and
    writes, commits and collects.  Ranks decide alike: the step list is
    rank 0's reading of the directory, broadcast, and `wait` ends with
    rank 0's outcome broadcast (a barrier), so no rank restores a step
    before rank 0 has committed it.  A restore maps each leaf's file and
    copies the rank's block out of it (`sharding.local_block`), then
    casts it to the template block's dtype and device.  A save or
    restore that fails on one rank fails on every rank.
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
import torch.distributed as dist

from repro_torch.core.treeutil import leaves_with_paths, map_with_paths
from repro_torch.parallel.sharding import gather_dims, local_block


def _key(path) -> str:
    return "/".join(str(k) for k in path)


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _every(mesh):
    """The axis over every rank of `mesh` (None without a mesh)."""
    return None if mesh is None else mesh.axis(tuple(mesh.axis_names))


def _agree(every, error: Optional[BaseException]) -> None:
    """Raise on every rank of `every` if any rank's `error` is set."""
    if every is not None and every.size > 1:
        said = [None] * every.size
        dist.all_gather_object(said, None if error is None
                               else f"{type(error).__name__}: {error}",
                               group=every.group)
        if error is None and any(said):
            raise RuntimeError(
                "checkpoint: another rank failed: "
                + "; ".join(f"rank {every.ranks[i]}: {m}"
                            for i, m in enumerate(said) if m))
    if error is not None:
        raise error


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
    def __init__(self, directory: str, keep: int = 3, *, mesh=None,
                 specs=None):
        if mesh is not None and specs is None:
            raise ValueError("Checkpointer: a mesh needs the state's spec "
                             "tree")
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.mesh, self.specs = mesh, specs
        self._every = _every(mesh)
        self._writer = self._every is None or self._every.index == 0
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ---------------- save ----------------
    def _snapshot(self, state: Any) -> dict:
        """{path key: (host array, dtype name)} of every leaf: under a
        mesh each leaf gathered whole, one at a time, and kept by rank 0
        alone (the other ranks return {})."""
        out = {}
        with torch.no_grad():
            for path, leaf in leaves_with_paths(state):
                if self.mesh is not None and isinstance(leaf, torch.Tensor):
                    spec = _at(self.specs, path)
                    if len(spec) != leaf.dim():
                        raise ValueError(f"checkpoint: spec {spec} for the "
                                         f"{tuple(leaf.shape)} leaf "
                                         f"{_key(path)}")
                    leaf = gather_dims(leaf, spec, self.mesh)
                if not self._writer:
                    continue
                dtype = (str(leaf.dtype).replace("torch.", "")
                         if isinstance(leaf, torch.Tensor) else None)
                arr = _to_host(leaf)
                out[_key(path)] = (arr, dtype or str(arr.dtype))
        return out

    def save(self, step: int, state: Any):
        self.save_async(step, state)
        self.wait()

    def save_async(self, step: int, state: Any):
        self.wait()
        host = self._snapshot(state)
        if self._writer:
            self._thread = threading.Thread(
                target=self._write_caught, args=(step, host), daemon=True)
            self._thread.start()

    def wait(self):
        """Join the write in flight (rank 0); under a mesh every rank then
        learns its outcome (a barrier).  A failed write raises here, on
        every rank."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        error, self._error = self._error, None
        said = None if error is None else f"{type(error).__name__}: {error}"
        if self._every is not None:
            said = self._every.broadcast_object(said, 0)
        if error is not None:
            raise error
        if said is not None:
            raise RuntimeError(f"checkpoint: rank 0's write failed: {said}")

    def _write_caught(self, step: int, host: dict):
        try:
            self._write(step, host)
        except Exception as e:          # raised by `wait`
            self._error = e

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
        steps = self._local_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(self.dir / f"step_{s:09d}", ignore_errors=True)

    # ---------------- restore ----------------
    def _local_steps(self):
        out = []
        for p in self.dir.glob("step_*"):
            if p.suffix == ".tmp" or not (p / "manifest.json").exists():
                continue
            out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def _agreed_steps(self, every):
        """The committed steps as rank 0 reads them, on every rank of
        `every` (this process's reading without one)."""
        steps = self._local_steps() if every is None or every.index == 0 \
            else None
        return steps if every is None else every.broadcast_object(steps, 0)

    def all_steps(self):
        """The committed steps, after the write in flight (under a mesh:
        rank 0's reading, on every rank)."""
        self.wait()
        return self._agreed_steps(self._every)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, state_template: Any, step: Optional[int] = None, *,
                mesh=None, specs=None) -> Any:
        """Restore into the template's structure: each leaf on its
        template leaf's device and in its dtype.  Under a mesh (this
        checkpointer's, or `mesh` and `specs` given here, as the
        reference's `shardings=`) the template holds the rank's blocks,
        and each rank restores its blocks of the whole leaves."""
        if mesh is None:
            mesh, specs = self.mesh, self.specs
        elif specs is None:
            raise ValueError("restore: a mesh needs the state's spec tree")
        self.wait()
        every = _every(mesh)
        steps = self._agreed_steps(every)
        if step is None:
            step = steps[-1] if steps else None
        if step is None or step not in steps:
            raise FileNotFoundError(f"no checkpoint of step {step} in "
                                    f"{self.dir} (steps {steps})")
        d = self.dir / f"step_{step:09d}"
        error = out = None
        try:
            manifest = json.loads((d / "manifest.json").read_text())[
                "leaves"]

            def load(path, tmpl):
                entry = manifest[_key(path)]
                bf16 = "bfloat16" in entry["dtype"]
                # under a mesh a copy-on-write map: only the block is read
                arr = np.load(d / entry["file"],
                              mmap_mode=None if mesh is None else "c")
                t = torch.from_numpy(arr.view(np.int16) if bf16 else arr)
                if mesh is not None:
                    t = local_block(t, _at(specs, path), mesh).clone()
                if bf16:
                    t = t.view(torch.bfloat16)
                if isinstance(tmpl, torch.Tensor):
                    if t.shape != tmpl.shape:
                        raise ValueError(
                            f"checkpoint: leaf {_key(path)} of step {step} "
                            f"gives a {tuple(t.shape)} block for a "
                            f"{tuple(tmpl.shape)} template")
                    t = t.to(device=tmpl.device, dtype=tmpl.dtype)
                return t
            out = map_with_paths(load, state_template)
        except Exception as e:          # raised on every rank below
            error = e
        _agree(every, error)
        return out
