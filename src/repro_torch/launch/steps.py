"""Step builders, port of `repro/launch/steps.py`: the LM train step on
one device or on a mesh, and the cells of a (cfg, shape, mesh).

Autograd stands in for `jax.value_and_grad`: each train step
differentiates `LM.loss_fn` with respect to detached copies of the
parameters, so the state it is given is never written.  On a mesh
every rank differentiates its own copy of the program on its blocks
(the collectives' backward rules are `launch/mesh.py`'s), completes
its gradients over the batch axes (`sharding.complete_grads`) and
updates its blocks (`adamw.update(..., mesh=)`).

`build_cell(cfg, shape, mesh)` is the reference's one source of truth
for a production cell, SPMD: it returns this rank's step function and
the local shapes of its arguments (meta tensors standing in for
`ShapeDtypeStruct`s: the rank's blocks under the reference's
parameter, optimizer-state, batch and cache specs).  Serving cells run
on int8 serving weights unless REPRO_BASELINE=1, as the reference's;
the train cell runs the plain paths (`KernelPolicy("ref")`: no kernel
has a backward).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.core.treeutil import map_with_paths, tree_map, value_and_grad
from repro_torch.kernels.policy import KernelPolicy
from repro_torch.launch import mesh as meshlib
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


def _grads(lm: LM, params, batch, remat: bool, layout=None):
    """(gradients with `params`' tree and dtypes, detached metrics)."""
    (_, metrics), grads = value_and_grad(
        lambda p: lm.loss_fn(p, batch, remat=remat, layout=layout), params,
        has_aux=True)
    return grads, metrics


def opt_specs(lm: LM, opt_cfg: adamw.AdamWConfig) -> dict:
    """The spec tree of the optimizer state of `lm`'s mesh
    (`_opt_shardings_like` of `adamw.init`'s shapes)."""
    return _opt_shardings_like(lm.cfg, adamw.init(lm.param_shapes(),
                                                  opt_cfg), lm.sh.mesh)


def make_train_step(lm: LM, opt_cfg: adamw.AdamWConfig, *, remat=True,
                    accum: int = 1, accum_dtype=torch.float32,
                    shape: Optional[ShapeSpec] = None):
    """`train_step(state, batch) -> (new_state, metrics)` with state
    {"params", "opt", "step"} and batch {"tokens", "labels"} (B, S).

    accum > 1: microbatched gradient accumulation over `accum` equal
    slices of the batch, summed in `accum_dtype` and averaged; the
    metrics are the last microbatch's.  Divides the activation footprint
    by `accum` at equal FLOPs.

    Under a mesh (`lm.sh`) `shape` is the cell's (global batch, seq_len)
    and the state and the batch hold the rank's blocks (the batch's rows
    over the batch axes, `sharding.batch_shardings`; the whole batch
    where it does not split).  Microbatch i is the reference's, global
    rows [i·B/accum, (i+1)·B/accum): a rank's part of it is its block of
    those rows, or all of them where they do not split over the batch
    axes (the batch is gathered whole first)."""
    sh = lm.sh
    mesh = layout = o_specs = None          # one device
    if sh is not None:
        mesh = sh.mesh
        if shape is None:
            raise ValueError("make_train_step under a mesh takes the cell's "
                             "shape")
        if shape.global_batch % accum:
            raise ValueError(f"a batch of {shape.global_batch} does not "
                             f"split into {accum} microbatches")
        mb = shape.global_batch // accum
        layout = lm.layout(dataclasses.replace(shape, global_batch=mb),
                           int8=False)
        whole_split = sh.batch_split(shape.global_batch)
        o_specs = opt_specs(lm, opt_cfg)

    def microbatches(batch):
        """This rank's part of each microbatch."""
        if accum == 1:
            return [batch]
        if sh is None:
            n = next(iter(batch.values())).shape[0] // accum
            return [{k: v[i * n:(i + 1) * n] for k, v in batch.items()}
                    for i in range(accum)]
        bax = sh.batch_axis
        if whole_split:
            batch = {k: bax.all_gather(v, 0) for k, v in batch.items()}
        out = []
        for i in range(accum):
            part = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            if layout["bl"]:
                part = {k: meshlib.split_to(v, bax, 0)
                        for k, v in part.items()}
            out.append(part)
        return out

    def train_step(state, batch):
        params = state["params"]
        parts = microbatches(batch)
        if accum == 1:
            grads, metrics = _grads(lm, params, parts[0], remat, layout)
        else:
            gsum = tree_map(lambda p: torch.zeros(p.shape, dtype=accum_dtype,
                                                  device=p.device), params)
            for part in parts:
                g, metrics = _grads(lm, params, part, remat, layout)
                gsum = tree_map(lambda s, x: s + x.to(accum_dtype), gsum, g)
            grads = tree_map(lambda g: g / accum, gsum)
        if sh is not None:
            grads = shlib.complete_grads(grads, lm.param_specs(False), mesh,
                                         layout["bl"])
        new_p, new_opt = adamw.update(grads, state["opt"], params, opt_cfg,
                                      mesh=mesh, specs=o_specs)
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
    `policy` selects the kernels or the plain paths.

    The train cell: `fn(state, batch) -> (state, metrics)` with args
    (state, batch), state {"params" (the rank's blocks under
    `param_specs(False)`), "opt" (`_opt_shardings_like`), "step"
    (whole)}.  As the reference's: AdamW with int8 moments above 100 B
    parameters (fp32 below) unless `opt_cfg` is given, `default_accum`
    microbatches unless `accum` is, accumulated in bf16 above 100 B
    parameters; the plain paths unless `policy` is given."""
    if shape.kind == "train":
        return _train_cell(cfg, shape, mesh, policy, opt_cfg, remat, accum)
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


def _train_cell(cfg, shape, mesh, policy, opt_cfg, remat, accum):
    lm = build_lm(cfg, mesh, KernelPolicy("ref") if policy is None
                  else policy)
    if lm.sh is None:
        raise ValueError("build_cell needs a mesh")
    big = cfg.param_counts()["total"] > 100e9
    if opt_cfg is None:
        opt_cfg = adamw.AdamWConfig(moment_dtype="int8" if big
                                    else "float32")
    if accum is None:
        accum = default_accum(cfg, shape)
    p_shapes = lm.param_shapes()
    opt_shapes = adamw.init(p_shapes, opt_cfg)
    state = {"params": _local(p_shapes, lm.param_specs(False), mesh),
             "opt": _local(opt_shapes, opt_specs(lm, opt_cfg), mesh),
             "step": torch.empty((), dtype=torch.int32, device="meta")}
    batch_shapes = input_specs(cfg, shape)
    b_loc = _local(batch_shapes, shlib.batch_shardings(batch_shapes, mesh),
                   mesh)
    fn = make_train_step(lm, opt_cfg, remat=remat, accum=accum,
                         accum_dtype=torch.bfloat16 if big
                         else torch.float32, shape=shape)
    return fn, (state, b_loc)


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
