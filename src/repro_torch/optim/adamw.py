"""AdamW with optional int8-quantized moments, port of `repro/optim/adamw.py`.

Functional, as the reference: `update` returns new parameter and state
trees and writes into none of the tensors it is given, so a checkpoint
taken asynchronously from a state (`runtime.fault.run_resilient`) never
sees it change.  The moment trees are stored in `moment_dtype`
(float32 | bfloat16 | int8; int8 as `core.quant` blocks {'q', 'scale'}).

Leaves are walked in `jax.tree.leaves`' order (dict keys sorted), so the
global gradient norm sums its per-leaf terms in the reference's order.
Decoupled weight decay applies to matrices (ndim >= 2) only; parameters
of any dtype are updated in fp32 and cast back.

Under a mesh (`mesh`: this rank's view; `specs`: the spec tree of the
optimizer state, `launch.steps._opt_shardings_like`) every tree holds
the rank's blocks and the update is the reference's on the whole
trees: the clip's norm counts every element of the whole gradient once
(each leaf's squares summed over the axes its spec splits it over, not
over those it is replicated on), and int8 moments keep the reference's
blocks of 128 along each whole row: a rank whose block of a row is not
a whole number of quantization blocks gathers the row first
(`_int8_rows`).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core import quant
from repro_torch.core.treeutil import (leaves_with_paths, map_with_paths,
                                       tree_map)
from repro_torch.parallel.sharding import split_axis

MOMENT_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "float32"     # float32 | bfloat16 | int8


def _int8_rows(spec, mesh):
    """(the axis splitting an int8 moment's rows, that of its scales) when
    the rank's block of a row is not a whole number of quantization
    blocks, else None: its blocks then straddle ranks."""
    if mesh is None:
        return None
    ax = split_axis(mesh, spec["q"][-1])
    return None if ax is None else (ax, split_axis(mesh, spec["scale"][-1]))


def _row_block(t, ax):
    return t if ax is None else t.narrow(
        -1, ax.index * (t.shape[-1] // ax.size), t.shape[-1] // ax.size)


def _encode(x, cfg: AdamWConfig, spec=None, mesh=None):
    if cfg.moment_dtype == "int8":
        axes = _int8_rows(spec, mesh)
        if axes is None or x.shape[-1] % quant.BLOCK == 0:
            return quant.quantize(x)
        qs = quant.quantize(axes[0].all_gather(x, x.dim() - 1))
        return {"q": _row_block(qs["q"], axes[0]).contiguous(),
                "scale": _row_block(qs["scale"], axes[1]).contiguous()}
    return x.to(MOMENT_DTYPES[cfg.moment_dtype])


def _decode(x, cfg: AdamWConfig, spec=None, mesh=None):
    if cfg.moment_dtype == "int8":
        axes = _int8_rows(spec, mesh)
        if axes is None or x["q"].shape[-1] % quant.BLOCK == 0:
            return quant.dequantize(x)
        q, scale = x["q"], x["scale"]
        whole = quant.dequantize({
            "q": axes[0].all_gather(q, q.dim() - 1),
            "scale": (scale if axes[1] is None
                      else axes[1].all_gather(scale, scale.dim() - 1))})
        return _row_block(whole, axes[0])
    return x.float()


def init(params, cfg: AdamWConfig, *, mesh=None, specs=None) -> dict:
    """Zero moments beside `params` (on each leaf's device) and a count
    of 0 (int32, on the first leaf's device).  Under a mesh, `params`
    are the rank's blocks and `specs` the state's spec tree (see the
    module docstring)."""
    def zeros(key):
        return map_with_paths(lambda path, p: _encode(
            torch.zeros(p.shape, dtype=torch.float32, device=p.device), cfg,
            None if specs is None else _at(specs[key], path), mesh), params)
    dev = next(leaves_with_paths(params))[1].device
    return {"m": zeros("m"), "v": zeros("v"),
            "count": torch.zeros((), dtype=torch.int32, device=dev)}


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _global_sq(grads, paths, specs, mesh):
    """The whole gradient's sum of squares from the rank's blocks: each
    leaf's squares summed over the axes its spec splits it over, leaves
    grouped by those axes (one all-reduce a group)."""
    groups = {}
    for path in paths:
        spec = _at(specs["m"], path)
        if isinstance(spec, dict):          # int8 moments: {'q', 'scale'}
            spec = spec["q"]
        names = set()
        for entry in spec:
            if entry:
                names.update(entry if isinstance(entry, tuple) else (entry,))
        key = tuple(a for a in mesh.axis_names if a in names)
        sq = torch.sum(torch.square(_at(grads, path).float()))
        groups[key] = groups[key] + sq if key in groups else sq
    total = None
    for key in sorted(groups):
        part = groups[key].clone()
        if key:
            mesh.axis(key).all_reduce(part)
        total = part if total is None else total + part
    return total


def update(grads, opt_state, params, cfg: AdamWConfig, lr_scale=1.0, *,
           mesh=None, specs=None):
    """Returns (new_params, new_opt_state).  Under a mesh every tree holds
    the rank's blocks, with the gradients complete for them
    (`sharding.complete_grads`), and `specs` is the state's spec tree."""
    count = opt_state["count"] + 1
    paths = [path for path, _ in leaves_with_paths(params)]
    if mesh is None:
        # global-norm clip (fp32), summed leaf by leaf in the reference's
        # order
        gsq = sum(torch.sum(torch.square(_at(grads, path).float()))
                  for path in paths)
    else:
        gsq = _global_sq(grads, paths, specs, mesh)
    gnorm = torch.sqrt(gsq)
    # true divisions: torch computes `float / tensor` as a product with
    # the reciprocal, one ulp off the reference's quotient
    clip = torch.clamp(torch.full_like(gnorm, cfg.grad_clip)
                       / torch.clamp(gnorm, min=1e-12), max=1.0)
    cf = count.float()
    bc1 = 1.0 - torch.pow(torch.full_like(cf, cfg.b1), cf)
    bc2 = 1.0 - torch.pow(torch.full_like(cf, cfg.b2), cf)
    lr = cfg.lr * lr_scale

    def upd(p, g, m, v, spec):
        g = g.float() * clip
        m = cfg.b1 * _decode(m, cfg, spec, mesh) + (1 - cfg.b1) * g
        v = cfg.b2 * _decode(v, cfg, spec, mesh) + (1 - cfg.b2) * \
            torch.square(g)
        step = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        if p.dim() >= 2:  # decoupled weight decay on matrices only
            step = step + cfg.weight_decay * p.float()
        new_p = (p.float() - lr * step).to(p.dtype)
        return new_p, _encode(m, cfg, spec, mesh), _encode(v, cfg, spec,
                                                           mesh)

    out = {path: upd(_at(params, path), _at(grads, path),
                     _at(opt_state["m"], path), _at(opt_state["v"], path),
                     None if specs is None else _at(specs["m"], path))
           for path in paths}

    def rebuild(i):
        return map_with_paths(lambda path, _: out[path][i], params)
    return rebuild(0), {"m": rebuild(1), "v": rebuild(2), "count": count}
