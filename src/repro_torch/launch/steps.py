"""The LM training step on one device, port of the single-device half of
`repro/launch/steps.py` (`make_train_step`).

The reference's builders also place every tensor on a mesh (input,
parameter and optimizer shardings, `build_cell` for the dry run); that
half waits for the port's multi-device slice (ROADMAP Queue 1, item 11).
Autograd stands in for `jax.value_and_grad`: each step differentiates
`LM.loss_fn` with respect to detached copies of the parameters, so the
state it is given is never written.
"""
from __future__ import annotations

import torch

from repro_torch.core.treeutil import tree_map, value_and_grad
from repro_torch.models.transformer import LM
from repro_torch.optim import adamw


def _grads(lm: LM, params, batch, remat: bool):
    """(gradients with `params`' tree and dtypes, detached metrics)."""
    (_, metrics), grads = value_and_grad(
        lambda p: lm.loss_fn(p, batch, remat=remat), params, has_aux=True)
    return grads, metrics


def make_train_step(lm: LM, opt_cfg: adamw.AdamWConfig, *, remat=True,
                    accum: int = 1, accum_dtype=torch.float32):
    """`train_step(state, batch) -> (new_state, metrics)` with state
    {"params", "opt", "step"} and batch {"tokens", "labels"} (B, S).

    accum > 1: microbatched gradient accumulation over `accum` equal
    slices of the batch, summed in `accum_dtype` and averaged; the
    metrics are the last microbatch's.  Divides the activation footprint
    by `accum` at equal FLOPs."""
    def train_step(state, batch):
        params = state["params"]
        if accum == 1:
            grads, metrics = _grads(lm, params, batch, remat)
        else:
            mb = {k: v.reshape((accum, v.shape[0] // accum) + v.shape[1:])
                  for k, v in batch.items()}
            gsum = tree_map(lambda p: torch.zeros(p.shape, dtype=accum_dtype,
                                                  device=p.device), params)
            for i in range(accum):
                g, metrics = _grads(lm, params, {k: v[i] for k, v in
                                                 mb.items()}, remat)
                gsum = tree_map(lambda s, x: s + x.to(accum_dtype), gsum, g)
            grads = tree_map(lambda g: g / accum, gsum)
        new_p, new_opt = adamw.update(grads, state["opt"], params, opt_cfg)
        step = state["step"] + 1
        return ({"params": new_p, "opt": new_opt, "step": step},
                dict(metrics, step=step))
    return train_step
