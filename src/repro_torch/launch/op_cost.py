"""Per-rank op counter, the port's counterpart of `repro/launch/hlo_cost.py`.

The reference walks the post-SPMD HLO text of a compiled program; the
port has no compiled program, so it counts one eager call of a cell's
function on this rank, op by op, under a `TorchDispatchMode`
(`OpCounter`), usually on meta tensors (`launch/dryrun.py`):

  flops       — each aten op's operations from `torch.utils.flop_counter`'s
                registry (matmuls, convolutions, attention: the products
                the reference's walker counts as `dot`s), by operand
                dtype: "bf16" (bf16 and fp16), "fp32", "int8".  The
                reference multiplies a `while` body by its trip count
                because XLA's cost analysis counts the body once; an
                eager Python loop dispatches its ops on every trip, so
                the count needs no trip-count correction.
  bytes       — the eager HBM traffic model: every aten op reads each
                input once and writes each output once (the distinct
                elements: an expanded dimension is read once).  Views
                and metadata ops count nothing (the analogue of
                `_SKIP_BYTES`); gathers read only what they gather and
                scatters read and write only the region they update, as
                the reference counts dynamic-slice / gather and
                dynamic-update-slice / scatter.
  kernel ops  — each public wrapper of `kernels/ops.py` that launches a
                Hopper kernel is one fused op (the analogue of "a
                fusion is one HBM round trip"): its operations and bytes
                come from its own formula (`kernels/cost.py`), each input
                read once and each output written once, flash attention
                counting the (q, k) pairs its mask keeps; the plain ops
                inside the wrapper are not counted again.  `kernel_ops`
                counts them by `ops.launch_counts()`'s names: on the
                card the same call launches as many.
  collectives — every collective a `MeshAxis` issues
                (`launch.mesh.count_collectives`), forward and backward,
                with the reference's ring factors (`roofline.collective_bytes`).
  memory      — the peak of the bytes alive of every storage the call
                created, each tracked through its storage's lifetime
                (a view shares its base's; an in-place op creates none).

`analyze_hlo` and `parse_computations` read XLA text and have no
counterpart.
"""
from __future__ import annotations

import contextlib
import weakref
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import cost as kcost
from repro_torch.launch import mesh as meshlib
from repro_torch.launch import roofline

COLLECTIVES = roofline.COLLECTIVES
BUCKETS = ("bf16", "fp32", "int8")

aten = torch.ops.aten
# ops that move no bytes of their own: allocations left unwritten,
# metadata, and views the schema does not mark as views
_NO_BYTES = {aten.empty, aten.empty_like, aten.empty_strided,
             aten.new_empty, aten.new_empty_strided, aten.detach,
             aten.alias, aten.lift_fresh, aten._unsafe_view,
             aten._local_scalar_dense, aten.sym_size, aten.sym_stride,
             aten.sym_numel, aten.sym_storage_offset, aten.set_,
             aten.resize_, aten._reshape_alias}
# read only the elements they gather: out + indices, out written
_GATHERS = {aten.index, aten.index_select, aten.gather, aten.embedding,
            aten.take}
# update a region in place: indices and the update read, the region written
_SCATTERS = {aten.index_put_, aten.scatter_, aten.scatter_add_,
             aten.scatter_reduce_, aten.index_copy_, aten.index_add_,
             aten.index_fill_, aten.masked_scatter_}
_VIEWS: dict = {}


@dataclass
class Cost:
    """One rank's count of a call: operations by dtype bucket, HBM bytes,
    collectives' wire bytes by kind (the reference's `COLLECTIVES`) and
    their seconds on the links (`roofline.collective_bytes`)."""
    flops: dict = field(default_factory=lambda: dict.fromkeys(BUCKETS, 0.0))
    bytes: float = 0.0
    coll: dict = field(default_factory=lambda: {k: 0.0 for k in COLLECTIVES})
    coll_seconds: float = 0.0

    def add(self, other: "Cost", mult: float = 1.0):
        for k, v in other.flops.items():
            self.flops[k] = self.flops.get(k, 0.0) + v * mult
        self.bytes += other.bytes * mult
        for k in COLLECTIVES:
            self.coll[k] += other.coll[k] * mult
        self.coll_seconds += other.coll_seconds * mult

    @property
    def coll_total(self) -> float:
        return sum(self.coll.values())

    @property
    def total_flops(self) -> float:
        return sum(self.flops.values())


def tensors(obj):
    """The tensors of a (nested) tuple, list, dict or named tuple."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (tuple, list)):
        for v in obj:
            yield from tensors(v)
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from tensors(v)


def _is_view(func) -> bool:
    """Every return aliases an input without writing it."""
    v = _VIEWS.get(func)
    if v is None:
        rets = func._schema.returns
        v = _VIEWS[func] = bool(rets) and all(
            r.alias_info is not None and not r.alias_info.is_write
            for r in rets)
    return v


def _bytes(ts) -> int:
    return sum(kcost.tensor_bytes(t) for t in ts)


def _op_bytes(func, args, kwargs, out) -> int:
    packet = func._overloadpacket
    if packet in _NO_BYTES or _is_view(func):
        return 0
    ins = list(tensors((args, kwargs)))
    outs = list(tensors(out))
    if packet in _GATHERS:
        return 2 * _bytes(outs) + _bytes(ins[1:])
    if packet in _SCATTERS:
        rest = ins[1:]
        return _bytes(rest) + (kcost.tensor_bytes(rest[-1]) if rest else 0)
    if packet is aten.copy_:
        return _bytes(ins[1:2]) + _bytes(ins[:1])
    return _bytes(ins) + _bytes(outs)


def _operand_bucket(args) -> str:
    """The dtype bucket of a product: its first operand of two or more
    dimensions (addmm's bias is the first argument)."""
    for t in tensors(args):
        if t.dim() >= 2:
            return kcost.bucket(t.dtype)
    return "fp32"


class OpCounter(TorchDispatchMode):
    """Count the ops, kernel ops, collectives and live bytes of the calls
    made inside the block (see the module's docstring).  After the
    block: `cost` (a `Cost`), `kernel_ops` ({kernel: ops}),
    `flops_by_op` ({aten op or kernel name: operations}), `collectives`
    (the `Collective` log) and `peak_bytes` (the most bytes alive at
    once of the storages created inside the block).
    One counter at a time in a process."""

    def __init__(self):
        super().__init__()
        self.cost = Cost()
        self.kernel_ops: dict = {}
        self.flops_by_op: dict = {}
        self.collectives: list = []
        self.peak_bytes = 0
        self.live_bytes = 0
        self._live: dict = {}           # storage key -> (bytes, finalizer)
        self._paused = 0
        self._logs = None

    def __enter__(self):
        self._logs = meshlib.count_collectives()
        self.collectives = self._logs.__enter__()
        kcost.counting(self)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            kcost.done(self)
            self._logs.__exit__(*exc)
            coll = roofline.collective_bytes(self.collectives)
            for k in COLLECTIVES:
                self.cost.coll[k] = coll[k]
            self.cost.coll_seconds = coll["seconds"]
            for _, fin in self._live.values():
                fin.detach()
            self._live.clear()

    @contextlib.contextmanager
    def paused(self):
        """Neither count nor track what runs inside (a kernel wrapper's
        plain version)."""
        self._paused += 1
        try:
            yield
        finally:
            self._paused -= 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._paused:
            return out
        count = flop_registry.get(func._overloadpacket)
        if count is not None:
            self._flops(str(func._overloadpacket), _operand_bucket(args),
                        count(*args, **kwargs, out_val=out))
        self.cost.bytes += _op_bytes(func, args, kwargs, out)
        self._track(tensors(out), (args, kwargs))
        return out

    def kernel_op(self, name: str, bucket: str, ops: float, arguments: dict,
                  out) -> None:
        """One launch of kernel `name` (called by `kernels.cost.fused`)."""
        self.kernel_ops[name] = self.kernel_ops.get(name, 0) + 1
        self._flops(name, bucket, ops)
        ins = {id(t): t for t in tensors(arguments)}
        self.cost.bytes += _bytes(ins.values()) + _bytes(tensors(out))
        self._track(tensors(out), arguments)

    def _flops(self, op: str, bucket: str, ops: float) -> None:
        self.cost.flops[bucket] += ops
        self.flops_by_op[op] = self.flops_by_op.get(op, 0.0) + ops

    # live bytes: every storage an op creates, until it is freed
    def _track(self, outs, inputs) -> None:
        seen = None
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in self._live:
                continue
            if seen is None:
                seen = {i.untyped_storage()._cdata for i in tensors(inputs)}
            if key in seen:
                continue
            n = st.nbytes()
            self._live[key] = (n, weakref.finalize(st, self._freed, key))
            self.live_bytes += n
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def _freed(self, key) -> None:
        n, _ = self._live.pop(key)
        self.live_bytes -= n


def count(fn, *args, **kwargs):
    """(fn's result, its `OpCounter`) of one call `fn(*args, **kwargs)`."""
    with OpCounter() as counter:
        out = fn(*args, **kwargs)
    return out, counter
