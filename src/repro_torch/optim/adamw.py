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
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core import quant
from repro_torch.core.treeutil import (leaves_with_paths, map_with_paths,
                                       tree_map)

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


def _encode(x, cfg: AdamWConfig):
    if cfg.moment_dtype == "int8":
        return quant.quantize(x)
    return x.to(MOMENT_DTYPES[cfg.moment_dtype])


def _decode(x, cfg: AdamWConfig):
    if cfg.moment_dtype == "int8":
        return quant.dequantize(x)
    return x.float()


def init(params, cfg: AdamWConfig) -> dict:
    """Zero moments beside `params` (on each leaf's device) and a count
    of 0 (int32, on the first leaf's device)."""
    def zeros():
        return tree_map(lambda p: _encode(
            torch.zeros(p.shape, dtype=torch.float32, device=p.device), cfg),
            params)
    dev = next(leaves_with_paths(params))[1].device
    return {"m": zeros(), "v": zeros(),
            "count": torch.zeros((), dtype=torch.int32, device=dev)}


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def update(grads, opt_state, params, cfg: AdamWConfig, lr_scale=1.0):
    """Returns (new_params, new_opt_state)."""
    count = opt_state["count"] + 1
    paths = [path for path, _ in leaves_with_paths(params)]
    # global-norm clip (fp32), summed leaf by leaf in the reference's order
    gsq = sum(torch.sum(torch.square(_at(grads, path).float()))
              for path in paths)
    gnorm = torch.sqrt(gsq)
    # true divisions: torch computes `float / tensor` as a product with
    # the reciprocal, one ulp off the reference's quotient
    clip = torch.clamp(torch.full_like(gnorm, cfg.grad_clip)
                       / torch.clamp(gnorm, min=1e-12), max=1.0)
    cf = count.float()
    bc1 = 1.0 - torch.pow(torch.full_like(cf, cfg.b1), cf)
    bc2 = 1.0 - torch.pow(torch.full_like(cf, cfg.b2), cf)
    lr = cfg.lr * lr_scale

    def upd(p, g, m, v):
        g = g.float() * clip
        m = cfg.b1 * _decode(m, cfg) + (1 - cfg.b1) * g
        v = cfg.b2 * _decode(v, cfg) + (1 - cfg.b2) * torch.square(g)
        step = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        if p.dim() >= 2:  # decoupled weight decay on matrices only
            step = step + cfg.weight_decay * p.float()
        new_p = (p.float() - lr * step).to(p.dtype)
        return new_p, _encode(m, cfg), _encode(v, cfg)

    out = {path: upd(_at(params, path), _at(grads, path),
                     _at(opt_state["m"], path), _at(opt_state["v"], path))
           for path in paths}

    def rebuild(i):
        return map_with_paths(lambda path, _: out[path][i], params)
    return rebuild(0), {"m": rebuild(1), "v": rebuild(2), "count": count}
