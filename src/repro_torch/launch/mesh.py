"""Serving meshes over `torch.distributed` ranks, port of `repro/launch/mesh.py`.

A `Mesh` is the port's counterpart of `jax.sharding.Mesh` for the
serving step: named axes over a grid of ranks, laid out row-major as
`jax.make_mesh` lays out devices (on a ('data', 'model') mesh, rank
d * n_model + m sits at data shard d, model index m).  The reference
runs one controller over every device; here every rank runs its own
copy of the program (SPMD) and a `Mesh` is that rank's view: each axis's
size, the rank's index along it, and the process group of the ranks
that share its other coordinates (the group an all-reduce over that
axis runs in).  Every collective the sharded models need lives on
`MeshAxis` (sum and max all-reduces, all-gather, all-to-all, and the
ring shift of a pipeline), each a no-op on an axis of one rank; gloo
takes CUDA tensors in the collectives (ranks sharing one card), so
only the ring shift, a pair of point-to-point ops, is staged through
the host by hand.

Training calls the differentiable collectives below `MeshAxis`
(`reduce_from`, `copy_to`, `gather_from`, `split_to`, `gather_sum`,
`all_to_all`, `ring_shift`): each one's backward is chosen by what
consumes its output (Megatron-LM's f and g); the in-place serving
collectives refuse tensors that require grad.

Functions, not module-level state: importing this module reads nothing
of torch.distributed or of the cards.

  init_ranks(device)         the world, from torchrun's environment or an
                             explicit init_method (the tests: file://)
  make_mesh(shape, names)    a Mesh over the world's ranks (or a subset)
  make_local_mesh(model)     the reference's (world / model, model) mesh
  make_production_mesh(...)  the reference's (16, 16) / (2, 16, 16) meshes,
                             real or (given a rank) dry
  make_dry_mesh(shape, names, rank)
                             one rank's view of a mesh whose collectives
                             send nothing (`DryAxis`): the dry run's
                             stand-in for the reference's placeholder
                             devices
  count_collectives()        record every collective a `MeshAxis` issues
  choose_backend(...)        nccl or gloo, the one place that decides
  make_channel(ranks, ...)   a `CommandChannel`: rank 0's ordered messages
                             to the other ranks of a mesh (the network
                             server's command stream)
"""
from __future__ import annotations

import contextlib
import datetime
import itertools
import os
import pickle
from dataclasses import dataclass, field
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.analysis import guards
from repro_torch.device import rank_device

# how long a collective (and the rendezvous) may wait for the other ranks
# before it raises: ranks that diverge fail the run instead of hanging it
DEFAULT_TIMEOUT_S = 300.0
# a command channel's message buffer: a message up to this size is one
# broadcast, a longer one two
CHANNEL_HEAD_BYTES = 16384


class _Done:
    """The handle of a collective over a one-rank axis: nothing to wait
    for."""

    def wait(self) -> bool:
        return True


class _Lifted:
    """The handle of an asynchronous collective issued inside an engine's
    host-sync guard: the issuing thread's guard stays lifted
    (`guards.lift`) until the collective's `wait()`, since gloo stages
    a CUDA tensor through the host on its own thread while the caller
    runs on."""

    def __init__(self, work, owner):
        self._work, self._owner = work, owner

    def wait(self) -> bool:
        try:
            return self._work.wait()
        finally:
            if self._work is not None:
                self._work = None
                guards.unlift(self._owner)


class Collective(NamedTuple):
    """One collective a `MeshAxis` issued, as `count_collectives` records
    it: `kind` in the reference's names (all-gather, all-reduce,
    all-to-all, collective-permute), `nbytes` the rank's output tensor's
    bytes (the reference's HLO convention, before any ring factor),
    `axis` the axis's name, `size` its group's ranks and `ranks` their
    global ranks in index order (which link the group takes)."""
    kind: str
    nbytes: int
    axis: str
    size: int
    ranks: tuple


# the logs of the `count_collectives` blocks entered, innermost last
_LOGS: list = []


@contextlib.contextmanager
def count_collectives():
    """Yield a list that receives a `Collective` for every collective a
    `MeshAxis` (or a `DryAxis`) issues over more than one rank inside
    the block: the serving collectives, and through them the
    differentiable ones, forward and backward.  Blocks nest; each sees
    every collective issued inside it."""
    log: list = []
    _LOGS.append(log)
    try:
        yield log
    finally:
        _LOGS.remove(log)


def _record(kind: str, nbytes: int, ax) -> None:
    if _LOGS:
        c = Collective(kind, int(nbytes), ax.name, ax.size, ax.ranks)
        for log in _LOGS:
            log.append(c)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@dataclass(frozen=True, eq=False)
class MeshAxis:
    """One mesh axis as this rank sees it.  `ranks` lists the global
    ranks of its group in index order; `group` is None on an axis of
    size 1, where every collective is a no-op.

    These collectives are invisible to autograd (the serving path's,
    `all_reduce` in place): given a tensor that requires grad while
    grad mode is on, each raises, as the kernels' `refuse_grad` does,
    so that no serving helper drops a gradient silently.  Training
    calls the differentiable collectives below (`reduce_from`,
    `copy_to`, `gather_from`, `split_to`, `gather_sum`,
    `all_to_all`, `ring_shift`).

    Each collective checks its arguments, records itself for
    `count_collectives`, then moves its bytes through the transport
    methods (`_reduce`, `_gather`, `_exchange`, `_shift`), which
    `DryAxis` replaces: a dry rank records what a real one does."""
    name: str
    size: int
    index: int
    ranks: tuple
    group: Optional[object] = None

    def _refuse_grad(self, op: str, t: torch.Tensor) -> None:
        if self.size > 1 and torch.is_grad_enabled() and t.requires_grad:
            raise RuntimeError(
                f"MeshAxis.{op} over {self.name!r} was given a tensor that "
                f"requires grad: this collective is invisible to autograd "
                f"(the serving path's); train through launch.mesh's "
                f"differentiable collectives")

    def all_reduce(self, t: torch.Tensor, async_op: bool = False):
        """Sum `t` in place over the axis (the reference's `psum`).  With
        `async_op`, returns a handle whose `wait()` completes it."""
        if self.size == 1:
            return _Done() if async_op else None
        self._refuse_grad("all_reduce", t)
        _record("all-reduce", _nbytes(t), self)
        if not t.is_contiguous():
            if async_op:
                raise ValueError("all_reduce: an async sum needs a "
                                 "contiguous tensor")
            return self._strided(t, dist.ReduceOp.SUM)
        return self._reduce(t, dist.ReduceOp.SUM, async_op)

    def _strided(self, t: torch.Tensor, op) -> None:
        """All-reduce a strided view through a dense copy: gloo reduces
        the view's storage as if it were dense (wrong elements)."""
        dense = t.contiguous()
        self._reduce(dense, op, False)
        t.copy_(dense)

    # the transport: what a collective sends and receives.  Each is an
    # explicit transfer (gloo stages CUDA tensors through the host), so
    # it lifts an engine step's host-sync guard while it runs
    def _reduce(self, t: torch.Tensor, op, async_op: bool):
        if async_op:
            owner = guards.lift()
            work = None
            try:
                work = dist.all_reduce(t, op=op, group=self.group,
                                       async_op=True)
            finally:
                if work is None:        # the issue raised: nothing to wait
                    guards.unlift(owner)
            return _Lifted(work, owner)
        with guards.allow_transfers():
            return dist.all_reduce(t, op=op, group=self.group)

    def _gather(self, parts: list, t: torch.Tensor) -> None:
        with guards.allow_transfers():
            dist.all_gather(parts, t, group=self.group)

    def _exchange(self, out: torch.Tensor, t: torch.Tensor) -> None:
        with guards.allow_transfers():
            dist.all_to_all_single(out, t, group=self.group)

    def _shift(self, t: torch.Tensor, dst: int, src: int) -> torch.Tensor:
        """Send `t` to global rank `dst` and return what `src` sent.  Under
        gloo the tensor is staged through a host copy: gloo's
        point-to-point ops read a host pointer."""
        staged = (t.device.type != "cpu"
                  and dist.get_backend(self.group) == "gloo")
        with guards.allow_transfers():
            send = (t.detach().to("cpu") if staged else t).contiguous()
            recv = torch.empty_like(send)
            reqs = [dist.isend(send, dst, group=self.group),
                    dist.irecv(recv, src, group=self.group)]
            for r in reqs:
                r.wait()
            return recv.to(t.device) if staged else recv

    def all_reduce_max(self, t: torch.Tensor):
        """Elementwise maximum of `t` in place over the axis (the
        reference's `pmax`: flash-decoding's running maximum)."""
        if self.size == 1:
            return None
        self._refuse_grad("all_reduce_max", t)
        _record("all-reduce", _nbytes(t), self)
        if not t.is_contiguous():
            return self._strided(t, dist.ReduceOp.MAX)
        return self._reduce(t, dist.ReduceOp.MAX, False)

    def all_gather(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """The axis's blocks of `t` concatenated along `dim` in index
        order (each rank's `t` has the same shape): the whole of a
        dimension split over the axis."""
        if self.size == 1:
            return t
        self._refuse_grad("all_gather", t)
        _record("all-gather", self.size * _nbytes(t), self)
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.size)]
        self._gather(parts, t)
        return torch.cat(parts, dim=dim)

    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        """Equal splits of dim 0: block j of `t` goes to the rank at index
        j, and block i of the result came from the rank at index i (the
        reference's untiled `all_to_all(x, axis, 0, 0)` over a leading
        axis of the axis's size)."""
        if self.size == 1:
            return t
        self._refuse_grad("all_to_all", t)
        if t.shape[0] % self.size:
            raise ValueError(f"all_to_all: dim 0 of {tuple(t.shape)} does "
                             f"not split over {self.name!r} ({self.size})")
        _record("all-to-all", _nbytes(t), self)
        t = t.contiguous()
        out = torch.empty_like(t)
        self._exchange(out, t)
        return out

    def ring_shift(self, t: torch.Tensor, step: int = 1) -> torch.Tensor:
        """A new tensor: the `t` of the rank `step` places before this one
        along the axis (the rank at index i sends its `t` to index
        (i + step) % size; the reference's `ppermute` over that ring).
        Each rank posts its send and its receive together (`isend` /
        `irecv`), so the ring cannot deadlock.  Under gloo the tensor is
        staged through a host copy: gloo's point-to-point ops read a
        host pointer, and the staged hop moves the tensor's bytes once
        (an `all_to_all` carrying it would move `size` times as many)."""
        if self.size == 1 or step % self.size == 0:
            return t.clone()
        self._refuse_grad("ring_shift", t)
        _record("collective-permute", _nbytes(t), self)
        return self._shift(t, self.ranks[(self.index + step) % self.size],
                           self.ranks[(self.index - step) % self.size])

    def broadcast_object(self, obj, src_index: int):
        """The picklable `obj` of the rank at `src_index` along the axis,
        on every rank of the axis (the other ranks pass anything).  A
        host object, not a tensor: no counterpart in the reference's
        HLO, and not recorded."""
        if self.size == 1:
            return obj
        box = [obj]
        with guards.allow_transfers():
            dist.broadcast_object_list(box, src=self.ranks[src_index],
                                       group=self.group)
        return box[0]


@dataclass(frozen=True, eq=False)
class DryAxis(MeshAxis):
    """A `MeshAxis` of a dry mesh (`make_dry_mesh`): every collective
    checks and records itself as a real axis's does, and returns a
    tensor of the right shape and dtype on its input's device (meta
    included) without sending anything.  Its values are not the
    collective's; a dry run reads shapes, never values."""

    def _reduce(self, t, op, async_op):
        return _Done() if async_op else None

    def _gather(self, parts, t):
        pass

    def _exchange(self, out, t):
        pass

    def _shift(self, t, dst, src):
        return torch.empty_like(t)

    def broadcast_object(self, obj, src_index: int):
        return obj


@dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's view of a serving mesh: `axis_names`, `shape` (a dict,
    as the reference's `mesh.shape[name]`) and each axis's `MeshAxis`."""
    axis_names: tuple
    shape: dict
    axes: dict = field(repr=False)
    rank: int = 0

    @property
    def size(self) -> int:
        return int(np.prod([self.shape[a] for a in self.axis_names]))

    @property
    def coords(self) -> dict:
        return {a: self.axes[a].index for a in self.axis_names}

    def axis(self, name) -> MeshAxis:
        """The axis `name`, or the combined axis of a tuple of names (its
        ranks row-major over them, as the reference's spec entry
        ("data", "model") splits a dimension); () gives a one-rank
        axis."""
        if isinstance(name, tuple):
            if not name:
                return MeshAxis((), 1, 0, (self.rank,))
            if len(name) == 1:
                name = name[0]
        return self.axes[name]

    def __repr__(self) -> str:
        dims = ", ".join(f"{a!r}: {self.shape[a]}" for a in self.axis_names)
        return f"Mesh({{{dims}}}, rank {self.rank} at {self.coords})"


# ---------------------------------------------------------------------------
# differentiable collectives (training over a mesh)
# ---------------------------------------------------------------------------
# Every rank runs the same program on its blocks, and autograd gives each
# rank the gradient of its own blocks.  The convention is Megatron-LM's
# (its f and g operators; Shoeybi et al. 2019, arXiv:1909.08053, §3): a
# tensor replicated over an axis, on which every rank computes the same
# thing, carries its whole gradient on every rank; a tensor that is the
# rank's block, or that only this rank's computation consumes, carries
# this rank's part.  So a collective's backward depends on what
# consumes its output:
#
#   reduce_from  partials -> replicated (all-reduce)     backward: identity
#   copy_to      replicated -> a per-rank consumer       backward: all-reduce
#   gather_from  blocks -> replicated (all-gather)       backward: this
#                                                        rank's slice
#   split_to     replicated -> this rank's block         backward: all-gather
#   gather_sum   blocks -> whole, consumed differently   backward: all-reduce,
#                on each rank (an FSDP weight gather)    then this rank's slice
#   all_to_all   equal dim-0 blocks exchanged            backward: all_to_all
#   ring_shift   each rank's tensor to the next rank     backward: the
#                (a pipeline's hop)                      reverse shift
#
# Without a gradient to build (grad mode off, or no input that requires
# grad) each is the serving path's collective, so the serving numerics
# are untouched; over a one-rank axis each is the identity.  Every rank
# of an axis must call them alike and in the same order, as the backward
# runs them in the reverse order on every rank.


def _grad_wanted(t: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and t.requires_grad


def _reduced(ax: MeshAxis, t: torch.Tensor) -> torch.Tensor:
    """A new tensor: `t` summed over `ax`."""
    out = t.contiguous().clone()
    ax.all_reduce(out)
    return out


def _block(t: torch.Tensor, ax: MeshAxis, dim: int) -> torch.Tensor:
    n = t.shape[dim] // ax.size
    return t.narrow(dim, ax.index * n, n)


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, ax):
        return _reduced(ax, t)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, ax):
        ctx.ax = ax
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return _reduced(ctx.ax, g), None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, ax, dim, summed):
        ctx.ax, ctx.dim, ctx.summed = ax, dim, summed
        return ax.all_gather(t, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.summed:
            g = _reduced(ctx.ax, g)
        return _block(g, ctx.ax, ctx.dim).contiguous(), None, None, None


class _SplitTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, ax, dim):
        ctx.ax, ctx.dim = ax, dim
        return _block(t, ax, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return ctx.ax.all_gather(g, ctx.dim), None, None


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, ax, step):
        ctx.ax, ctx.step = ax, step
        return ax.ring_shift(t, step)

    @staticmethod
    def backward(ctx, g):
        return ctx.ax.ring_shift(g, -ctx.step), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, ax):
        ctx.ax = ax
        return ax.all_to_all(t)

    @staticmethod
    def backward(ctx, g):
        return ctx.ax.all_to_all(g), None


def reduce_from(t: torch.Tensor, ax: MeshAxis) -> torch.Tensor:
    """`t`'s partials summed over `ax` into a replicated tensor (the
    serving path reduces `t` in place and returns it).  Backward: the
    identity (Megatron's g)."""
    if ax.size == 1:
        return t
    if _grad_wanted(t):
        return _ReduceFrom.apply(t, ax)
    ax.all_reduce(t)
    return t


def copy_to(t: torch.Tensor, ax: MeshAxis) -> torch.Tensor:
    """A replicated `t` handed to a computation that differs per rank of
    `ax`; the identity.  Backward: the ranks' partial gradients summed
    (Megatron's f)."""
    if ax.size == 1 or not _grad_wanted(t):
        return t
    return _CopyTo.apply(t, ax)


def gather_from(t: torch.Tensor, ax: MeshAxis, dim: int) -> torch.Tensor:
    """The blocks of `t` over `ax` concatenated along `dim` into a
    replicated tensor.  Backward: this rank's slice of the (whole,
    replicated) gradient."""
    if ax.size == 1:
        return t
    if _grad_wanted(t):
        return _GatherFrom.apply(t, ax, dim, False)
    return ax.all_gather(t, dim)


def gather_sum(t: torch.Tensor, ax: MeshAxis, dim: int) -> torch.Tensor:
    """The blocks of `t` over `ax` concatenated along `dim`, for a
    consumer that differs per rank (FSDP: each rank's rows of the batch
    use the whole weight).  Backward: the ranks' gradients summed, then
    this rank's slice (a reduce-scatter)."""
    if ax.size == 1:
        return t
    if _grad_wanted(t):
        return _GatherFrom.apply(t, ax, dim, True)
    return ax.all_gather(t, dim)


def split_to(t: torch.Tensor, ax: MeshAxis, dim: int) -> torch.Tensor:
    """This rank's block along `dim` of a replicated `t` (the serving
    path returns a view).  Backward: the ranks' block gradients
    all-gathered, the whole gradient on every rank."""
    if ax.size == 1:
        return t
    if _grad_wanted(t):
        return _SplitTo.apply(t, ax, dim)
    return _block(t, ax, dim)


def all_to_all(t: torch.Tensor, ax: MeshAxis) -> torch.Tensor:
    """`MeshAxis.all_to_all`, differentiable: its backward sends each
    gradient block back to the rank it came from (the same exchange)."""
    if ax.size == 1:
        return t
    if _grad_wanted(t):
        return _AllToAll.apply(t, ax)
    return ax.all_to_all(t)


def ring_shift(t: torch.Tensor, ax: MeshAxis, step: int = 1) -> torch.Tensor:
    """`MeshAxis.ring_shift`, differentiable: its backward hands each
    gradient back the other way round the ring (JAX's transpose of
    `ppermute`)."""
    if _grad_wanted(t) and ax.size > 1:
        return _RingShift.apply(t, ax, step)
    return ax.ring_shift(t, step)


def choose_backend(device_type: str, local_world_size: int,
                   n_cards: int) -> str:
    """The process-group backend: nccl when the ranks run on the card and
    each rank of this host has a card of its own; gloo when ranks share a
    card (NCCL refuses two ranks on one device; gloo stages CUDA tensors
    through the host) or run on the CPU."""
    if device_type == "cuda" and 0 < local_world_size <= n_cards:
        return "nccl"
    return "gloo"


def world_size() -> int:
    """Ranks in the world: the initialized group's, else torchrun's
    WORLD_SIZE, else 1."""
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def is_rank0() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def init_ranks(device=None, *, init_method: Optional[str] = None,
               rank: Optional[int] = None,
               world_size: Optional[int] = None,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> torch.device:
    """Initialize this process's rank of the world and bind it to its
    device (`device.rank_device`); returns the device.

    Without `init_method` the world comes from torchrun's environment
    (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR/MASTER_PORT); otherwise
    `rank` and `world_size` must be given (the tests pass a `file://`
    rendezvous, so concurrent test workers never share a port).  The
    backend is `choose_backend`'s, printed on rank 0.  Every collective
    waits at most `timeout_s`."""
    dev = rank_device(device)
    if dist.is_initialized():
        return dev
    if init_method is None:
        missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                               "MASTER_PORT") if k not in os.environ]
        if missing:
            raise RuntimeError(
                f"init_ranks: no {missing} in the environment; launch one "
                f"process per rank with torchrun --nproc-per-node N, or "
                f"pass init_method, rank and world_size")
        init_method = "env://"
        rank = int(os.environ["RANK"])
        world_size = int(os.environ["WORLD_SIZE"])
    elif rank is None or world_size is None:
        raise ValueError("init_ranks: an init_method needs rank and "
                         "world_size")
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    n_cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    backend = choose_backend(dev.type, local, n_cards)
    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s))
    if rank == 0:
        print(f"[mesh] {world_size} ranks, backend {backend} ({local} "
              f"ranks on this host, {n_cards} cards; rank 0 on {dev})",
              flush=True)
    return dev


def make_mesh(shape: Sequence[int], axis_names: Sequence[str],
              ranks: Optional[Sequence[int]] = None) -> Optional[Mesh]:
    """A mesh of `shape` over `ranks` (default: every rank of the world),
    row-major.  Every rank of the world must call it alike, for
    `dist.new_group` is collective over the world; a rank outside
    `ranks` gets None.  A mesh of one rank needs no initialized world."""
    shape = tuple(int(n) for n in shape)
    axis_names = tuple(axis_names)
    if len(shape) != len(axis_names) or min(shape, default=0) < 1:
        raise ValueError(f"make_mesh: shape {shape} for axes {axis_names}")
    n = int(np.prod(shape))
    if ranks is None:
        ranks = range(world_size())
    ranks = tuple(int(r) for r in ranks)
    if len(ranks) != n:
        raise ValueError(f"make_mesh: a {shape} mesh needs {n} ranks, got "
                         f"{len(ranks)}")
    if n > 1 and not dist.is_initialized():
        raise RuntimeError(f"make_mesh: a {shape} mesh needs an initialized "
                           f"world of ranks (init_ranks)")
    me = dist.get_rank() if dist.is_initialized() else ranks[0]
    axes = {}
    for key, line in _axis_lines(shape, axis_names, ranks):
        group = dist.new_group(list(line)) if len(line) > 1 else None
        if me in line:
            axes[key] = _axis(MeshAxis, key, line, me, group)
    if me not in ranks:
        return None
    return Mesh(axis_names, dict(zip(axis_names, shape)), axes, me)


def _axis_lines(shape: tuple, axis_names: tuple, ranks: tuple):
    """(key, line) of every line of ranks of a mesh, in the order every
    rank must make their groups: each single axis, then each
    combination of two or more axes in mesh order (an LM spec may split
    one dimension over ("data", "model")), the key its name or tuple of
    names; a line lists the ranks that share their coordinates on the
    other axes, in index order along the key (row-major)."""
    grid = np.asarray(ranks).reshape(shape)
    combos = [(i,) for i in range(len(shape))] + [
        c for n_ax in range(2, len(shape) + 1)
        for c in itertools.combinations(range(len(shape)), n_ax)]
    for combo in combos:
        key = (axis_names[combo[0]] if len(combo) == 1
               else tuple(axis_names[i] for i in combo))
        size = int(np.prod([shape[i] for i in combo]))
        rest = [i for i in range(len(shape)) if i not in combo]
        for line in np.transpose(grid, rest + list(combo)).reshape(-1, size):
            yield key, tuple(int(r) for r in line)


def _axis(cls, key, line: tuple, me: int, group) -> MeshAxis:
    return cls(key if isinstance(key, str) else "+".join(key), len(line),
               line.index(me), line, group)


def make_dry_mesh(shape: Sequence[int], axis_names: Sequence[str],
                  rank: int) -> Mesh:
    """Rank `rank`'s view of a mesh of `shape` over ranks 0..n-1, its
    axes `DryAxis`es: the same indices, lines and combined axes as a
    real rank's (`_axis_lines`, as `make_mesh` builds them), with
    collectives that record themselves and send nothing.  Needs no
    world of ranks: the dry run (`launch/dryrun.py`) traces one rank of
    a production mesh on meta tensors."""
    shape = tuple(int(n) for n in shape)
    axis_names = tuple(axis_names)
    n = int(np.prod(shape))
    if len(shape) != len(axis_names) or min(shape, default=0) < 1:
        raise ValueError(f"make_dry_mesh: shape {shape} for axes "
                         f"{axis_names}")
    if not 0 <= rank < n:
        raise ValueError(f"make_dry_mesh: rank {rank} of a {shape} mesh "
                         f"({n} ranks)")
    axes = {key: _axis(DryAxis, key, line, rank, None)
            for key, line in _axis_lines(shape, axis_names, tuple(range(n)))
            if rank in line}
    return Mesh(axis_names, dict(zip(axis_names, shape)), axes, rank)


def make_production_mesh(*, multi_pod: bool = False,
                         dry_rank: Optional[int] = None) -> Mesh:
    """The reference's production meshes: ('data', 'model') of (16, 16),
    256 ranks, or ('pod', 'data', 'model') of (2, 16, 16), 512 ranks,
    over the world's first ranks.  A smaller world raises, naming the
    count the mesh needs.  Given `dry_rank`, that rank's view of the
    mesh dry (`make_dry_mesh`), with no world."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if dry_rank is not None:
        return make_dry_mesh(shape, axes, dry_rank)
    need = int(np.prod(shape))
    if world_size() < need:
        raise ValueError(f"make_production_mesh: a {shape} {axes} mesh "
                         f"needs {need} ranks, the world has "
                         f"{world_size()}")
    return make_mesh(shape, axes, ranks=range(need))


def make_local_mesh(model: int = 1) -> Mesh:
    """The ('data', 'model') mesh over the whole world: model ranks on
    the 'model' axis, the rest on 'data' (tests, smoke runs)."""
    n = world_size()
    if model < 1 or n % model:
        raise ValueError(f"make_local_mesh: {n} ranks do not split into "
                         f"'model' axes of {model}")
    return make_mesh((n // model, model), ("data", "model"))


class CommandChannel:
    """An ordered stream of picklable messages from the first rank of a
    group (the source) to the others, over a process group of its own:
    its `timeout_s` bounds how long a receiver waits for the next
    message, apart from the bounded timeout of the collectives a
    serving step makes.  A message is `(seq, obj)` pickled; `recv`
    checks the sequence number.  It travels in one broadcast of a
    `CHANNEL_HEAD_BYTES` buffer (its length, then its bytes), and a
    second for the rest of a longer one: `dist.broadcast_object_list`
    makes two for every message, and cut the mesh server's realtime
    factor at mesh 2 by 1.7-2.5x on ranks sharing an H100 (PERF.md
    §6).
    Every rank of the group calls `send` (the source) or `recv` (the
    others) alike, in order, from one thread."""

    def __init__(self, ranks: tuple, group, timeout_s: float):
        self.ranks = ranks
        self.group = group
        self.timeout_s = timeout_s
        self.src = ranks[0]
        self.rank = dist.get_rank()
        self.is_source = self.rank == self.src
        self.seq = 0                  # the last message sent or received

    def send(self, obj) -> int:
        """(the source) Send `obj` as the next message; returns its
        pickled bytes."""
        if not self.is_source:
            raise RuntimeError(f"command channel: rank {self.rank} is not "
                               f"its source (rank {self.src})")
        data = pickle.dumps((self.seq + 1, obj))
        self._broadcast(data)
        self.seq += 1
        return len(data)

    def recv(self):
        """(the other ranks) The next message; raises when its sequence
        number is not the one after the last."""
        seq, obj = pickle.loads(self._broadcast(None))
        if seq != self.seq + 1:
            raise RuntimeError(f"command channel: message {seq} after "
                               f"{self.seq}: the stream lost its order")
        self.seq = seq
        return obj

    def _broadcast(self, data: Optional[bytes]) -> bytes:
        """The source's `data` on every rank of the group (the others
        pass None)."""
        head = np.zeros(CHANNEL_HEAD_BYTES, np.uint8)
        room = CHANNEL_HEAD_BYTES - 8
        if data is not None:
            head[:8] = np.frombuffer(len(data).to_bytes(8, "little"), np.uint8)
            k = min(len(data), room)
            head[8:8 + k] = np.frombuffer(data[:k], np.uint8)
        dist.broadcast(torch.from_numpy(head), src=self.src, group=self.group)
        n = int.from_bytes(head[:8].tobytes(), "little")
        if n <= room:
            return head[8:8 + n].tobytes()
        rest = (np.frombuffer(data[room:], np.uint8).copy() if data is not None
                else np.empty(n - room, np.uint8))
        dist.broadcast(torch.from_numpy(rest), src=self.src, group=self.group)
        return head[8:].tobytes() + rest.tobytes()


def make_channel(ranks: Optional[Sequence[int]] = None,
                 timeout_s: float = DEFAULT_TIMEOUT_S
                 ) -> Optional[CommandChannel]:
    """A `CommandChannel` from the first of `ranks` (default: every rank
    of the world) to the rest, on a new gloo group whose collectives
    wait at most `timeout_s` (host tensors: the messages are host
    data).  Every rank of the world must call it alike, for
    `dist.new_group` is collective over the world; a rank outside
    `ranks` gets None."""
    if ranks is None:
        ranks = range(world_size())
    ranks = tuple(int(r) for r in ranks)
    if len(ranks) < 2 or not dist.is_initialized():
        raise ValueError(f"make_channel: a channel needs an initialized "
                         f"world and two ranks or more, got {ranks}")
    group = dist.new_group(list(ranks), backend="gloo",
                           timeout=datetime.timedelta(seconds=timeout_s))
    if dist.get_rank() not in ranks:
        return None
    return CommandChannel(ranks, group, timeout_s)
