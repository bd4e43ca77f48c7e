"""Sharding rules, port of `repro/parallel/sharding.py`: the LM's
DP/FSDP over ('pod', 'data') and TP/EP/SP over 'model', and the TDS
serving specs.

A spec is a plain tuple, one entry per dimension of its leaf: the name
of the mesh axis the dimension is split over, a tuple of two or more
names (the dimension split over their row-major product, as ("data",
"model")), or None (whole on every rank): the entries of
`tuple(PartitionSpec(...))` as JAX normalizes them (a one-name tuple is
the name, an empty one None).  Paths are the
string keys of the port's dict trees.

Axis roles
  pod, data : batch DP + FSDP weight sharding (an LM weight's FSDP block
              is all-gathered at use, one layer at a time); the ASR slot
              pool, one contiguous sub-pool per data shard
  model     : tensor parallel (flattened head dim / d_ff / vocab),
              expert parallel (when n_experts % model == 0), sequence
              parallel KV caches; TDS FC/head weights on their feature
              (contraction) axis

Every rank runs its own copy of the program (SPMD): where the reference
constrains a layout and lets GSPMD insert the collectives, the port's
models compute on the rank's blocks and call the collectives of
`launch/mesh.py` themselves.  `Sharder` is the rank's view the models
are given.  Training: `local_block` and `gather_dims` are
differentiable, and `complete_grads` finishes a rank's gradient tree
(the sums over the batch axes that no FSDP gather made).
"""
from __future__ import annotations

import os

import torch

from repro_torch.core import treeutil
from repro_torch.launch import mesh as meshlib


def batch_axes(mesh) -> tuple:
    """The mesh's batch (DP/FSDP) axes, in mesh order."""
    if mesh is None:
        return ()
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def _entry(d):
    """A spec entry as JAX's `PartitionSpec` normalizes it."""
    if isinstance(d, tuple):
        return None if not d else d[0] if len(d) == 1 else d
    return d


def _axsize(mesh, axes) -> int:
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return n


class Sharder:
    """A rank's view of the LM mesh, threaded through the models.

    `batch`: the batch axes activations split over (none with
    `shard_batch=False`); `model`: 'model' when the mesh has it.
    REPRO_BASELINE=1 turns the beyond-baseline layouts off
    (`baseline`): no context-parallel attention (decode gathers the
    sequence-sharded cache instead of flash-decoding over it), no
    explicit expert-parallel MoE.  The reference's layout methods (`act`,
    `seq`, `heads`, ...) are GSPMD sharding constraints; a rank here
    computes on its blocks, so the models decide their splits from the
    blocks' shapes and the specs instead."""

    def __init__(self, mesh, shard_batch: bool = True):
        self.mesh = mesh
        self.batch = batch_axes(mesh) if shard_batch else ()
        self.model = ("model" if (mesh is not None
                                  and "model" in mesh.axis_names) else None)
        self.baseline = os.environ.get("REPRO_BASELINE", "0") == "1"

    # -- sizes and axes ----------------------------------------------------
    @property
    def nm(self) -> int:
        """Ranks on the 'model' axis (1 without one)."""
        return self.mesh.shape[self.model] if self.model else 1

    @property
    def nb(self) -> int:
        """Ranks over the batch axes (1 without any)."""
        return _axsize(self.mesh, self.batch) if self.batch else 1

    def axis(self, names):
        """The mesh axis (or combined axes) `names`; None or () gives a
        one-rank axis."""
        return self.mesh.axis(() if names is None else names)

    @property
    def model_axis(self):
        return self.axis(self.model)

    @property
    def batch_axis(self):
        return self.axis(self.batch)

    def batch_split(self, n: int) -> bool:
        """Whether a batch of n rows splits over the batch axes (else
        every rank holds all n)."""
        return bool(self.batch) and n % self.nb == 0


def axis_size(mesh, name: str):
    """Size of mesh axis `name`, or None when the mesh does not declare
    it: callers fall back to replicated (a 1D ('model',) serving mesh
    reaching the 'data' rules, and vice versa)."""
    if name in mesh.axis_names:
        return mesh.shape[name]
    return None


def _rep(ndim: int) -> tuple:
    return (None,) * ndim


# ---------------------------------------------------------------------------
# parameter sharding rules
# ---------------------------------------------------------------------------
def _param_rule(path, shape, cfg, mesh) -> tuple:
    """The spec of the LM parameter at `path` (its string keys from the
    root) of global `shape`, the reference's rule for rule: every
    'layers' leaf keeps its leading repeat axis whole, and an axis that
    does not divide its dimension is dropped (the safety net).  int8
    serving weights: `wq` splits like `w`; `wscale` (per output channel)
    takes the `w` rule with the contraction dimension removed, so a
    block of a row-parallel `wq` carries the scales of its full rows."""
    names = list(path)
    shape = tuple(shape)
    if names and names[-1] == "wq":
        names = names[:-1] + ["w"]
    elif names and names[-1] == "wscale":
        fake = shape[:-1] + (1 << 22, shape[-1])
        spec_w = _param_rule(names[:-1] + ["w"], fake, cfg, mesh)
        return spec_w[:-2] + spec_w[-1:]
    fsdp = batch_axes(mesh)
    nm = axis_size(mesh, "model")
    in_layers = "layers" in names
    leaf = names[-1]
    parent = names[-2] if len(names) >= 2 else ""

    def spec(*dims):
        if in_layers:
            dims = (None,) + dims  # leading repeat axis
        if len(dims) != len(shape):
            raise ValueError(f"{names}: {shape} against {dims}")
        out = []
        for size, d in zip(shape, dims):
            if d is None:
                out.append(None)
                continue
            axes = d if isinstance(d, tuple) else (d,)
            n = _axsize(mesh, axes) if all(
                a in mesh.axis_names for a in axes) else 0
            # drop axes that don't divide evenly (the safety net)
            out.append(_entry(d) if n and size % n == 0 else None)
        return tuple(out)

    # --- embeddings / head -------------------------------------------------
    if "embed" in names:
        return spec("model", fsdp)
    if "lm_head" in names:
        if leaf == "b":
            return spec("model")
        return spec(fsdp, "model")
    # --- norms / small vectors ---------------------------------------------
    if leaf in ("scale", "bias", "A_log", "D", "dt_bias") or parent in (
            "norm1", "norm2", "final_norm", "norm_gate"):
        return spec(*([None] * (len(shape) - (1 if in_layers else 0))))
    # --- attention -----------------------------------------------------------
    if parent == "wqkv":
        return spec(fsdp, "model") if leaf == "w" else spec("model")
    if parent == "wo":
        return spec("model", fsdp) if leaf == "w" else spec(None)
    # --- MoE -----------------------------------------------------------------
    if "router" in names:
        return spec(fsdp, None)
    if "mlp" in names and cfg is not None and cfg.moe is not None and \
            len(shape) - (1 if in_layers else 0) == 3:
        ep = nm is not None and cfg.moe.n_experts % nm == 0
        if leaf in ("w_gate", "w_up") or parent in ("w_gate", "w_up"):
            return spec("model", fsdp, None) if ep else spec(None, fsdp,
                                                             "model")
        return spec("model", None, fsdp) if ep else spec(None, "model", fsdp)
    # --- dense MLP / shared expert / mamba projections -----------------------
    if parent in ("w_gate", "w_up", "w_z", "w_x", "w_B", "w_C", "w_dt"):
        return spec(fsdp, "model") if leaf == "w" else spec("model")
    if parent in ("w_down", "out_proj", "wo"):
        return spec("model", fsdp) if leaf == "w" else spec(None)
    if parent == "conv_x":
        return spec(None, "model") if leaf == "w" else spec("model")
    # fallback: replicate
    return _rep(len(shape))


def _with_paths(fn, tree, path=()):
    """fn(path, leaf) over a dict tree, the tree's structure kept."""
    if isinstance(tree, dict):
        return {k: _with_paths(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def param_shardings(cfg, param_shapes, mesh) -> dict:
    """The spec tree of an LM parameter tree (`LM.param_shapes()`, or its
    `quantize_params_for_serving` image): `_param_rule` at every leaf."""
    return _with_paths(lambda path, leaf: _param_rule(
        path, tuple(leaf.shape), cfg, mesh), param_shapes)


# ---------------------------------------------------------------------------
# batch / cache shardings
# ---------------------------------------------------------------------------
def batch_shardings(batch_shapes, mesh) -> dict:
    """Dim 0 (the global batch) over the DP axes when it divides."""
    b_axes = batch_axes(mesh)

    def f(leaf):
        if leaf.dim() == 0:
            return ()
        if b_axes and leaf.shape[0] % _axsize(mesh, b_axes) == 0:
            return (_entry(b_axes),) + _rep(leaf.dim() - 1)
        return _rep(leaf.dim())
    return treeutil.tree_map(f, batch_shapes)


def cache_shardings(cfg, cache_shapes, mesh, global_batch: int) -> dict:
    """KV caches: batch over the DP axes when the batch divides them and
    the sequence over 'model', else the sequence over ('data', 'model');
    SSM state heads and conv channels over 'model'."""
    b_axes = batch_axes(mesh)
    nb = _axsize(mesh, b_axes)
    batch_ok = bool(b_axes) and global_batch % nb == 0
    nm = axis_size(mesh, "model")
    seq_axes = ("model",) if batch_ok and nm else tuple(
        a for a in ("data", "model") if a in mesh.axis_names)
    nseq = _axsize(mesh, seq_axes)

    def f(path, leaf):
        name = path[-1]
        if leaf.dim() == 0:
            return ()
        if name == "kpos":
            return (_entry(seq_axes) if leaf.shape[0] % nseq == 0
                    else None,)
        bspec = _entry(b_axes) if batch_ok else None
        if name in ("k", "v"):               # (R, B, Sc, K, Dh)
            sseq = _entry(seq_axes) if leaf.shape[2] % nseq == 0 else None
            return (None, bspec, sseq, None, None)
        if name == "ssm":                     # (R, B, H, P, N)
            sh = "model" if nm and leaf.shape[2] % nm == 0 else None
            return (None, bspec, sh, None, None)
        if name == "conv":                    # (R, B, ck-1, di)
            sd = "model" if nm and leaf.shape[3] % nm == 0 else None
            return (None, bspec, None, sd)
        return _rep(leaf.dim())
    return _with_paths(f, cache_shapes)


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


def split_axis(mesh, entry):
    """The mesh axis a spec entry splits its dimension over (a combined
    axis for a tuple of names), or None for a whole dimension."""
    if entry is None or entry == ():
        return None
    return mesh.axis(entry)


def local_block(x: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """This rank's block of `x` under `spec`: along each dimension whose
    entry names an axis (or a tuple of axes), the rank's contiguous
    slice [i*n/size, (i+1)*n/size) (i: its index along the axis, row-
    major over a tuple); other dimensions whole.  `x` is replicated:
    building a gradient, the blocks' gradients are all-gathered
    (`launch.mesh.split_to`)."""
    if len(spec) != x.dim():
        raise ValueError(f"spec {spec} for a {tuple(x.shape)} leaf")
    for dim, entry in enumerate(spec):
        ax = split_axis(mesh, entry)
        if ax is None:
            continue
        if x.shape[dim] % ax.size:
            raise ValueError(f"dimension {dim} of {tuple(x.shape)} does not "
                             f"split over {entry!r} ({ax.size})")
        x = meshlib.split_to(x, ax, dim)
    return x


def gather_dims(x: torch.Tensor, spec: tuple, mesh, keep=(),
                summed: bool = True) -> torch.Tensor:
    """The whole of every dimension of this rank's block `x` that `spec`
    splits, by an all-gather over its axis, except the dimensions whose
    entry is in `keep` (a weight's FSDP blocks gathered at use, its
    'model' block kept: `keep=("model",)`).

    Building a gradient: with `summed` the ranks apply the whole to
    different rows (a batch split over the batch axes), so the whole's
    gradient is summed over the axis and each rank keeps its block's
    (`launch.mesh.gather_sum`: FSDP's reduce-scatter); without, every
    rank computes the same on it (a batch whole on every rank), and
    keeps its slice of the whole gradient (`gather_from`)."""
    gather = meshlib.gather_sum if summed else meshlib.gather_from
    for dim, entry in enumerate(spec):
        if entry in keep:
            continue
        ax = split_axis(mesh, entry)
        if ax is not None:
            x = gather(x, ax, dim)
    return x


def complete_grads(grads, spec_tree, mesh, batch_split: bool):
    """A rank's gradient tree made whole for its blocks: each leaf summed
    (in place) over the batch axes its rows of the batch did not cover.
    A leaf whose spec splits it over a batch axis was summed over that
    axis by its FSDP gather's backward (`gather_dims`); over the batch
    axes it is replicated on, each rank holds its rows' share, summed
    here.  Over 'model' every rank already holds its block's whole
    gradient (Megatron's conventions, `launch.mesh`).  Where the batch
    does not split (`batch_split` false: every batch rank holds the same
    rows and computes the same) nothing is summed."""
    b_axes = batch_axes(mesh) if batch_split else ()

    def f(g, spec):
        named = set()
        for entry in spec:
            if entry:
                named.update(entry if isinstance(entry, tuple) else (entry,))
        rest = tuple(a for a in b_axes if a not in named)
        if rest:
            mesh.axis(rest).all_reduce(g)
        return g
    return treeutil.tree_map(f, grads, spec_tree)


def shard_tree(tree, spec_tree, mesh, device=None):
    """Every leaf's local block on this rank (`local_block`), on
    `device` (default: where the leaf is), dense and in its memory
    order: the port's `place_tree`."""
    def f(x, spec):
        if device is not None:
            x = x.to(device)
        return _dense(local_block(x, spec, mesh))
    return treeutil.tree_map(f, tree, spec_tree)
