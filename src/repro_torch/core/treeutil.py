"""Helpers for slot-pooled (leading-batch-axis) state, port of
`repro/core/treeutil.py`.

Per-stream carried state — TDS left-context buffers (a dict of tensors)
and the decoder `BeamState` (a NamedTuple of tensors) — carries a
leading slot axis.  Broadcast a single-stream init to B slots, and
reset one slot back to a fresh init (utterance boundary in that slot).
Both return new tensors: pool state is never updated in place.
`params_from_numpy` carries a parameter tree of arrays (the reference's
included) across as tensors.  `leaves_with_paths` and `map_with_paths`
walk a tree in `jax.tree.leaves`' order with each leaf's path (the
optimizer's summation order and the checkpoint's file names), and
`value_and_grad` is training's stand-in for `jax.value_and_grad`.
"""
from __future__ import annotations

import numpy as np
import torch


def tree_map(fn, tree, *rest):
    """Map `fn` over the tensor leaves of a dict / NamedTuple tree."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v, *(r[i] for r in rest))
                            for i, v in enumerate(tree)))
    return fn(tree, *rest)


def leaves_with_paths(tree, prefix: tuple = ()):
    """(path, leaf) pairs in `jax.tree.leaves`' order: dict keys sorted,
    list and tuple items in order.  A path is the tuple of the dict keys
    and sequence indices from the root to the leaf."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves_with_paths(tree[k], prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves_with_paths(v, prefix + (i,))
    else:
        yield prefix, tree


def map_with_paths(fn, tree, prefix: tuple = ()):
    """`fn(path, leaf)` over the leaves (see `leaves_with_paths`); dicts
    and plain lists and tuples keep their structure."""
    if isinstance(tree, dict):
        return {k: map_with_paths(fn, v, prefix + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_paths(fn, v, prefix + (i,))
                          for i, v in enumerate(tree))
    return fn(prefix, tree)


def value_and_grad(fn, params, *, has_aux: bool = False):
    """`fn(params)` and its gradient with respect to every leaf of
    `params` (autograd standing in for `jax.value_and_grad`): returns
    (value, grads), grads with `params`' tree and leaf dtypes.  With
    `has_aux`, `fn` returns (scalar, aux) and the value is that pair,
    aux detached.  `fn` sees detached aliases of the leaves that require
    grad, so the given tensors gain no graph; a leaf that does not reach
    the value gets a zero gradient."""
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    leaves = list(leaves_with_paths(live))
    with torch.enable_grad():
        out = fn(live)
        value = out[0] if has_aux else out
        gs = torch.autograd.grad(value, [t for _, t in leaves],
                                 allow_unused=True)
    grad = {path: torch.zeros_like(t) if g is None else g
            for (path, t), g in zip(leaves, gs)}
    grads = map_with_paths(lambda path, _: grad[path], params)
    if has_aux:
        return (value.detach(), tree_map(torch.Tensor.detach, out[1])), grads
    return value.detach(), grads


def batch_tree(tree, batch: int):
    """Each leaf x -> a contiguous (batch,) + x.shape copy."""
    return tree_map(
        lambda x: x[None].expand((batch,) + tuple(x.shape)).contiguous(), tree)


def set_slot(tree, slot, fresh):
    """A copy of `tree` with `fresh` (no slot axis) written into `slot`."""
    def put(b: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
        out = b.clone()
        out[slot] = f
        return out
    return tree_map(put, tree, fresh)


def params_from_numpy(tree, device="cpu"):
    """A parameter (or cache) tree of arrays — numpy, or anything
    `np.asarray` accepts, the JAX package's arrays included — or tensors,
    as torch tensors on `device`.  bfloat16 leaves (ml_dtypes' `bfloat16`
    in numpy) are carried bit for bit through their uint16 view."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    a = np.array(tree, order="C")        # a writable copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)
