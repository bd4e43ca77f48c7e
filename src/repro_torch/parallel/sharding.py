"""Sharding rules of the serving mesh, port of the TDS serving half of
`repro/parallel/sharding.py`.

A spec is a plain tuple, one entry per dimension of its leaf: the name
of the mesh axis the dimension is split over, or None (whole on every
rank).  The reference's `PartitionSpec`s carry the same names; a
`PartitionSpec()` is the tuple of Nones.

Axis roles on the serving mesh
  data  : the ASR slot pool, one contiguous sub-pool per data shard
  model : FC/head weights split on their feature (contraction) axis

`Sharder` and the LM's param, batch and cache rules wait for the LM
mesh (ROADMAP item 11).
"""
from __future__ import annotations

import torch

from repro_torch.core import treeutil


def axis_size(mesh, name: str):
    """Size of mesh axis `name`, or None when the mesh does not declare
    it: callers fall back to replicated (a 1D ('model',) serving mesh
    reaching the 'data' rules, and vice versa)."""
    if name in mesh.axis_names:
        return mesh.shape[name]
    return None


def _rep(ndim: int) -> tuple:
    return (None,) * ndim


def tds_param_specs(tds_cfg, mesh) -> dict:
    """Spec tree for a TDS params tree on the serving 'model' axis: every
    FC/head weight matrix (n_in, n_out) is split on its feature axis, so
    each rank holds n_in / n_model weight rows and computes a partial
    sum (ASRPU's pool-of-cores split, where each program computes one
    slice of a layer); convs, LayerNorm vectors and biases stay
    replicated.  A weight whose n_in does not divide the axis stays
    whole, as does every weight on a mesh without a 'model' axis."""
    from repro_torch.models.tds import build_kernel_specs
    nm = axis_size(mesh, "model")
    out = {}
    for s in build_kernel_specs(tds_cfg):
        if s.kind == "layernorm":
            out[s.name] = {"scale": _rep(1), "bias": _rep(1)}
        elif s.kind == "conv":
            out[s.name] = {"w": _rep(3), "b": _rep(1)}
        else:  # fc / head
            w = ("model", None) if nm and s.n_in % nm == 0 else _rep(2)
            out[s.name] = {"w": w, "b": _rep(1)}
    return out


def tds_prepared_specs(tds_cfg, mesh) -> dict:
    """Spec tree for `tds.quantize_params` output: the int8 payload `wq`
    splits like its source `w` (feature axis); the per-output-column
    scales `ws` stay whole, for the activations are quantized on their
    full rows, so the sharded int8 path sees the unsharded scales."""
    from repro_torch.models.tds import build_kernel_specs
    nm = axis_size(mesh, "model")
    return {s.name: {"wq": ("model", None) if nm and s.n_in % nm == 0
                     else _rep(2),
                     "ws": _rep(1)}
            for s in build_kernel_specs(tds_cfg)
            if s.kind in ("fc", "head")}


def asr_state_specs(tree, mesh):
    """Spec tree splitting the leading slot axis of every leaf of an ASR
    serving state tree (the TDS `StreamState`, the `BeamState`, the
    gathered step inputs) over the 'data' axis: ASRPU's pool of parallel
    decode workers, one sub-pool per data shard, which steps its slots
    with no collective outside the 'model' axis.  A leaf whose leading
    dimension does not divide the axis stays whole, as does everything
    on a mesh without a 'data' axis."""
    nd = axis_size(mesh, "data")

    def f(leaf):
        if nd and leaf.dim() >= 1 and leaf.shape[0] % nd == 0:
            return ("data",) + _rep(leaf.dim() - 1)
        return _rep(leaf.dim())

    return treeutil.tree_map(f, tree)


def _dense(x: torch.Tensor) -> torch.Tensor:
    """A dense copy of `x` in the memory order of its strides (a slice of
    the K-contiguous int8 weight view stays K-contiguous)."""
    order = sorted(range(x.dim()), key=lambda d: -x.stride(d))
    inverse = [order.index(d) for d in range(x.dim())]
    return x.permute(order).contiguous().permute(inverse)


def local_block(x: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """This rank's block of `x` under `spec`: along each dimension whose
    entry names an axis, the rank's contiguous slice [i*n/size,
    (i+1)*n/size) (i: its index along the axis); other dimensions
    whole."""
    if len(spec) != x.dim():
        raise ValueError(f"spec {spec} for a {tuple(x.shape)} leaf")
    for dim, name in enumerate(spec):
        if name is None:
            continue
        ax = mesh.axis(name)
        if x.shape[dim] % ax.size:
            raise ValueError(f"dimension {dim} of {tuple(x.shape)} does not "
                             f"split over {name!r} ({ax.size})")
        n = x.shape[dim] // ax.size
        x = x.narrow(dim, ax.index * n, n)
    return x


def shard_tree(tree, spec_tree, mesh, device=None):
    """Every leaf's local block on this rank (`local_block`), on
    `device` (default: where the leaf is), dense and in its memory
    order: the port's `place_tree`."""
    def f(x, spec):
        if device is not None:
            x = x.to(device)
        return _dense(local_block(x, spec, mesh))
    return treeutil.tree_map(f, tree, spec_tree)
