"""Elastic re-meshing: resume a job on a different topology, port of
`repro/runtime/elastic.py`.

Checkpoints hold logical (whole) leaves (`ckpt/checkpoint.py`), never a
rank's blocks, so a restart can build whatever mesh the surviving ranks
support and cut the state to that mesh's blocks.  This module is the
policy layer: pick a mesh from the surviving rank count, keep the data
stream exact, and restore a state onto the new mesh.

The data stream stays exact across a remesh: `SyntheticLM` is a pure
function of the step, and each rank takes its block of the same global
batch.  Restarting is SPMD: every rank of the new world runs the same
program, so a failure that every rank sees at the same step (a
`TransientError` each raises, `runtime.fault.run_resilient`'s restore
escalation) is mended on every rank alike, while a failure that one rank
sees alone cannot be: its peers wait in their next collective until its
timeout fails the run.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.core.treeutil import leaves_with_paths
from repro_torch.launch import mesh as meshlib


@dataclass(frozen=True)
class RemeshPlan:
    data: int
    model: int
    pod: Optional[int] = None

    @property
    def n_devices(self) -> int:
        return self.data * self.model * (self.pod or 1)

    def axis_names(self):
        return (("pod", "data", "model") if self.pod else ("data", "model"))

    def shape(self):
        return ((self.pod, self.data, self.model) if self.pod
                else (self.data, self.model))


def plan_remesh(n_devices: int, *, model_parallel: int,
                global_batch: int) -> RemeshPlan:
    """Choose (data, model) for the surviving ranks.

    model_parallel is preserved (the weights' layouts assume it); the data
    axis absorbs the loss.  The global batch must stay divisible so that
    the deterministic data stream re-partitions exactly (data/pipeline.py
    is a pure function of (seed, step, shard))."""
    assert n_devices % model_parallel == 0, (n_devices, model_parallel)
    data = n_devices // model_parallel
    while data > 1 and global_batch % data != 0:
        data -= 1            # shrink to a divisor of the global batch
    return RemeshPlan(data=data, model=model_parallel)


def build_mesh(plan: RemeshPlan):
    """The plan's mesh over every rank of the world, which must hold
    `plan.n_devices` ranks (every rank calls this alike)."""
    if meshlib.world_size() != plan.n_devices:
        raise ValueError(f"build_mesh: a {plan.shape()} {plan.axis_names()} "
                         f"mesh needs a world of {plan.n_devices} ranks, "
                         f"this one has {meshlib.world_size()}")
    return meshlib.make_mesh(plan.shape(), plan.axis_names())


def mesh_invariant_rng() -> None:
    """Elastic precondition: initialization gives the same logical values
    whatever the mesh.  The reference sets JAX's partitionable threefry
    here, for its jitted init under a mesh drew other parameters on
    another mesh.  The port needs no setting: `LM.init_local` draws
    every leaf whole from one generator, in `init`'s order, and keeps
    the rank's block, so its init is a function of the seed alone.  The
    training launcher still calls this before any draw, as the
    reference's does."""


def _moment_dtype(opt) -> str:
    """The AdamW moment dtype of an optimizer state tree (int8 moments
    are {'q', 'scale'} dicts)."""
    leaves = list(leaves_with_paths(opt["m"]))
    if any(path[-1] == "q" and leaf.dtype == torch.int8
           for path, leaf in leaves):
        return "int8"
    return str(leaves[0][1].dtype).replace("torch.", "")


def state_specs(cfg, mesh, moment_dtype: str) -> dict:
    """The spec tree of a training state {"params", "opt", "step"} on
    `mesh`: the parameters' rules (`LM.param_specs`), the optimizer
    state's own tree (`launch.steps.opt_specs`, which cuts int8
    {'q', 'scale'} moments by their own rule), the step whole."""
    from repro_torch.kernels.policy import KernelPolicy
    from repro_torch.launch import steps
    from repro_torch.optim import adamw
    lm = steps.build_lm(cfg, mesh, KernelPolicy("ref"))
    return {"params": lm.param_specs(False),
            "opt": steps.opt_specs(lm, adamw.AdamWConfig(
                moment_dtype=moment_dtype)),
            "step": ()}


def replace_state(cfg, checkpointer, state_template, mesh, step=None):
    """Restore a checkpoint onto the new mesh (the elastic restart path:
    topology changed, logical state identical).

    Without a mesh, `checkpointer.restore`.  Under one, `state_template`
    holds this rank's blocks: every leaf is read whole and cut to the
    rank's block under `state_specs` (the optimizer moments by their own
    spec tree, which covers int8 {'q', 'scale'} payloads; the reference
    once placed them with the raw parameter specs, which mis-places
    quantized moments after `plan_remesh` shrinks the data axis)."""
    if mesh is None:
        return checkpointer.restore(state_template, step=step)
    specs = state_specs(cfg, mesh, _moment_dtype(state_template["opt"]))
    return checkpointer.restore(state_template, step=step, mesh=mesh,
                                specs=specs)
