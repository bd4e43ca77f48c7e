"""Helpers for slot-pooled (leading-batch-axis) state, port of
`repro/core/treeutil.py`.

Per-stream carried state — TDS left-context buffers (a dict of tensors)
and the decoder `BeamState` (a NamedTuple of tensors) — carries a
leading slot axis.  Broadcast a single-stream init to B slots, and
reset one slot back to a fresh init (utterance boundary in that slot).
Both return new tensors: pool state is never updated in place.
`params_from_numpy` carries a parameter tree of arrays (the reference's
included) across as tensors.
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
