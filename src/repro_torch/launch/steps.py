"""Step builders, port of `repro/launch/steps.py`: the LM train step on
one device, and the serving cells of a (cfg, shape, mesh) on a mesh.

Autograd stands in for `jax.value_and_grad`: each train step
differentiates `LM.loss_fn` with respect to detached copies of the
parameters, so the state it is given is never written.

`build_cell(cfg, shape, mesh)` is the reference's one source of truth
for a production cell, SPMD: it returns this rank's step function and
the local shapes of its arguments (meta tensors standing in for
`ShapeDtypeStruct`s: the rank's blocks under the reference's
parameter, batch and cache specs).  Serving cells run on int8 serving
weights unless REPRO_BASELINE=1, as the reference's.  The train cell
under a mesh is the next slice (ROADMAP Queue 1, item 11).
"""
from __future__ import annotations

import os
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.core.treeutil import map_with_paths, tree_map, value_and_grad
from repro_torch.models import layers
from repro_torch.models.transformer import DTYPES, LM
from repro_torch.optim import adamw
from repro_torch.parallel import sharding as shlib


# ---------------------------------------------------------------------------
# input specs (meta tensors: shapes and dtypes, no storage)
# ---------------------------------------------------------------------------
def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """Model inputs of one cell as meta tensors: train/prefill (B, S),
    decode one new token (B, 1); the cache is an argument of its own
    (`cache_specs`).  Frontend archs take (B, S, D) embeddings."""
    B = shape.global_batch
    S = 1 if shape.is_decode else shape.seq_len
    meta = dict(device="meta")
    batch = {}
    if cfg.embed_inputs:
        batch["tokens"] = torch.empty((B, S), dtype=torch.int32, **meta)
    else:
        batch["embeds"] = torch.empty((B, S, cfg.d_model),
                                      dtype=DTYPES[cfg.dtype], **meta)
    if shape.kind == "train":
        batch["labels"] = torch.empty((B, S), dtype=torch.int32, **meta)
    return batch


def cache_specs(lm: LM, shape: ShapeSpec) -> dict:
    """The decode cache of a cell as meta tensors (global shapes)."""
    return lm.init_cache(shape.global_batch, shape.seq_len, device="meta")


def opt_shardings(param_sharding_tree) -> dict:
    """Moment trees share the parameter specs."""
    return {"m": tree_map(lambda ps: ps, param_sharding_tree),
            "v": tree_map(lambda ps: ps, param_sharding_tree),
            "count": None}


# ---------------------------------------------------------------------------
# builders
# ---------------------------------------------------------------------------
def build_lm(cfg: ModelConfig, mesh, policy=None) -> LM:
    """The LM over `mesh` (this rank's view; None: one device)."""
    return LM(cfg, policy, shlib.Sharder(mesh))


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


def make_prefill(lm: LM, layout: Optional[dict] = None):
    """prefill(params, batch); under a mesh `layout` is the cell's
    (`LM.layout`), computed once here, not per call."""
    def prefill(params, batch):
        return lm.prefill(params, batch, layout=layout)
    return prefill


def make_decode_step(lm: LM, layout: Optional[dict] = None):
    """decode_step(params, cache, batch) -> (tokens, cache); `layout`
    as `make_prefill`'s."""
    def decode_step(params, cache, batch):
        _, tok, new_cache = lm.decode_step(params, cache, batch,
                                           layout=layout)
        return tok, new_cache
    return decode_step


def default_accum(cfg: ModelConfig, shape: ShapeSpec) -> int:
    """Microbatches of the production train cells: just enough that the
    residual stack fits (the reference's policy, sized for v5e's 16 GB
    a chip); serving cells 1."""
    if shape.kind != "train":
        return 1
    n = cfg.param_counts()["total"]
    if n > 100e9:
        return 8
    if cfg.moe is not None or n > 60e9:
        return 4
    if n > 20e9:
        return 2
    return 1


def _local(tree, spec_tree, mesh):
    """Meta tensors of this rank's block shapes."""
    return tree_map(lambda t, sp: torch.empty(
        shlib.local_block(t, sp, mesh).shape, dtype=t.dtype, device="meta"),
        tree, spec_tree)


def build_cell(cfg: ModelConfig, shape: ShapeSpec, mesh, *, policy=None,
               opt_cfg=None, remat=True, accum: Optional[int] = None):
    """(step function, local argument shapes) of one (cfg, shape, mesh)
    cell on this rank: prefill `fn(params, batch) -> (logits (B, Vp)
    whole, the rank's cache blocks)` with args (params, batch); decode
    `fn(params, cache, batch) -> (tokens (B,) whole, cache)` with args
    (params, cache, batch).  Parameters are int8 serving weights unless
    REPRO_BASELINE=1 (`LM.init_local(..., int8=True)` builds them);
    `policy` selects the kernels or the plain paths."""
    if shape.kind == "train":
        raise NotImplementedError(
            "build_cell: the train cell under a mesh (the optimizer state's "
            "shardings, _opt_shardings_like in the step) is the next slice "
            "of the port (ROADMAP Queue 1, item 11)")
    lm = build_lm(cfg, mesh, policy)
    if lm.sh is None:
        raise ValueError("build_cell needs a mesh")
    int8_serving = os.environ.get("REPRO_BASELINE", "0") != "1"
    p_shapes = lm.param_shapes()
    if int8_serving:
        p_shapes = layers.quantize_params_for_serving(p_shapes)
    p_loc = _local(p_shapes, lm.param_specs(int8_serving), mesh)
    batch_shapes = input_specs(cfg, shape)
    b_loc = _local(batch_shapes, shlib.batch_shardings(batch_shapes, mesh),
                   mesh)
    layout = lm.layout(shape, int8=int8_serving)
    if shape.kind == "prefill":
        return make_prefill(lm, layout), (p_loc, b_loc)
    c_loc = _local(cache_specs(lm, shape), layout["cache"], mesh)
    return make_decode_step(lm, layout), (p_loc, c_loc, b_loc)


def _opt_shardings_like(cfg, opt_shapes, mesh) -> dict:
    """The spec tree of an AdamW state: the moments inherit the
    parameter rules by path (the 'm'/'v' prefix and a trailing int8
    'q'/'scale' stripped); the count is whole."""
    def f(path, leaf):
        names = [str(k) for k in path]
        if names and names[0] in ("m", "v"):
            names = names[1:]
        if names and names[-1] in ("q", "scale") and leaf.dim() >= 1:
            names = names[:-1]
        if not names:
            return (None,) * leaf.dim()
        return shlib._param_rule(names, tuple(leaf.shape), cfg, mesh)
    return map_with_paths(f, opt_shapes)
