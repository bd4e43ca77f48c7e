"""Pipeline parallelism, port of `repro/parallel/pipeline.py`: a GPipe
microbatch schedule over a 'stage' mesh axis, each tick handing every
stage's output one stage on along the ring.

The reference runs the schedule inside `shard_map`, with `ppermute` hops
and `jnp.where` on the stage index.  Here every rank runs its own copy
of the program (SPMD): the stage index is the rank's coordinate, a
Python int, so the `where`s become plain branches, while every rank
still makes the same collectives in the same order.  Autograd through
the schedule gives GPipe's pipelined backward, as in the reference:
the hop (`launch.mesh.ring_shift`) transposes to the reverse hop, and
the final sum (`launch.mesh.reduce_from`) to the identity.  Bubble
fraction (S - 1) / (M + S - 1).
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.treeutil import tree_map
from repro_torch.launch import mesh as meshlib


class _Pick(torch.autograd.Function):
    """`a`, with `b` kept in the graph at a zero gradient: the reference's
    `where(sid == 0, xm[inject], buf)` on stage 0, whose hop output `b`
    must still take part in the backward's reverse hops."""

    @staticmethod
    def forward(ctx, a, b):
        return a.view_as(a)

    @staticmethod
    def backward(ctx, g):
        return g, torch.zeros_like(g)


class _Zeroed(torch.autograd.Function):
    """Zeros of `a`'s shape, `a` kept in the graph at a zero gradient:
    the reference's `where(sid == n_stages - 1, outs, 0)` off the last
    stage."""

    @staticmethod
    def forward(ctx, a):
        return torch.zeros_like(a)

    @staticmethod
    def backward(ctx, g):
        return torch.zeros_like(g)


def pipeline_apply(stage_fn: Callable, stage_params, x_micro: torch.Tensor,
                   mesh, axis: str = "stage") -> torch.Tensor:
    """Run `x_micro` through `n_stages` chained applications of
    `stage_fn`, one stage a rank of `axis`.

    stage_fn: (params_one_stage, x) -> y   (the same shape as x)
    stage_params: this rank's block of the stage-stacked tree: every
        leaf with a leading axis of 1 (`sharding.local_block(params,
        (axis,) + (None,) * k, mesh)`), where the reference takes the
        whole tree sharded over `axis`
    x_micro: (n_micro, mb, ...) microbatches, the same on every rank
    Returns the last stage's (n_micro, mb, ...) output on every rank.

    Tick t of n_micro + n_stages - 1: stage 0 takes microbatch
    min(t, n_micro - 1), every stage applies `stage_fn`, the last stage
    keeps microbatch t - (n_stages - 1), and each output moves one
    stage on (the last tick's hop, whose result nobody reads, is left
    out on every rank alike).  The output is summed over the axis, so
    every rank returns it.  A gradient of the parameters is the rank's
    stage's; one of `x_micro` lands on stage 0, the rank that reads it.
    Every rank of the axis must call this alike."""
    ax = mesh.axis(axis)
    n_stages, sid = ax.size, ax.index
    n_micro = x_micro.shape[0]
    steps = n_micro + n_stages - 1

    def one(a):
        if a.shape[0] != 1:
            raise ValueError(f"pipeline_apply: a stage parameter block of "
                             f"{tuple(a.shape)}: its leading axis must be "
                             f"this rank's one stage")
        return a[0]
    p = tree_map(one, stage_params)
    buf = torch.zeros_like(x_micro[0])
    outs = [None] * n_micro
    for t in range(steps):
        if sid == 0:
            fresh = x_micro[min(t, n_micro - 1)]
            buf = fresh if t == 0 else _Pick.apply(fresh, buf)
        y = stage_fn(p, buf)
        if t >= n_stages - 1:
            outs[t - (n_stages - 1)] = y
        if t < steps - 1:
            buf = meshlib.ring_shift(y, ax)
    outs = torch.stack(outs)
    if sid != n_stages - 1:
        outs = _Zeroed.apply(outs)
    return meshlib.reduce_from(outs, ax)


def bubble_fraction(n_stages: int, n_micro: int) -> float:
    return (n_stages - 1) / (n_micro + n_stages - 1)
