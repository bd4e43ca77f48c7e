"""Helpers for slot-pooled (leading-batch-axis) state, port of
`repro/core/treeutil.py`.

Per-stream carried state — TDS left-context buffers (a dict of tensors)
and the decoder `BeamState` (a NamedTuple of tensors) — carries a
leading slot axis.  Broadcast a single-stream init to B slots, and
reset one slot back to a fresh init (utterance boundary in that slot).
Both return new tensors: pool state is never updated in place.
"""
from __future__ import annotations

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
