"""Runtime counterparts to the static rules: a host-sync guard for the
engines' steps and a budget on kernel-library builds.

Port of `repro/analysis/guards.py`.  Static analysis can see an
`.item()` written in a step, but not a host read hidden in a callee it
cannot resolve or in an index by a 0-d tensor; those show only at run
time.

`no_implicit_transfers()` wraps the serving engines' steps.  On a CUDA
build it sets `torch.cuda.set_sync_debug_mode("error")` for the block,
so that anything inside that makes the host wait on the card (a scalar
readback, `nonzero`, a blocking upload of pageable memory) raises on
the card, at almost no cost.  `strict=True` also enters a
`TorchDispatchMode` on the calling thread that raises on the ops behind
every host read on any device (`_local_scalar_dense`, `nonzero`,
`bincount`, `unique`, a boolean-mask index, a copy to the CPU) and a
`TorchFunctionMode` that raises on `.tolist()` and `.numpy()`, which
reach no op on a CPU tensor: the CPU tests hold a step to the guard
with it.

**The guard is process-wide.**  The sync debug mode is one setting of
the process (jax's transfer guard, the reference's, is per thread), so
while any thread is inside a block, a synchronizing call on any thread
raises.  Two rules keep that from touching work outside the block:

* `card_turn()`: the engines' workers (`serving.server.EngineWorker`)
  take turns on the card, one iteration (commands, step, readouts) at a
  time, so that one worker's guarded step never overlaps another's
  readout or prefill in the same process (the `--serve` path hosts an
  ASR and an LM worker).
* The state is kept per thread: each thread's open blocks and lifts.
  The mode is error while some thread is in a block it has not lifted,
  the mode from before the first block while every open block is
  lifted, and that mode comes back when the last block closes.
  `release(thread)` drops a thread's blocks, lifts and turn: a worker
  abandoned inside a step (a watchdog restart) never closes its block,
  and what it does when it wakes is ignored by the guard.

`allow_transfers()` is the explicit way through: a `MeshAxis`
collective stages through the host under gloo, and lifts its thread's
guard for as long as it runs (an asynchronous one until its `wait()`,
`lift`/`unlift`).  The guard sets the mode only when it changes: once
when a block opens, and twice for each collective inside it.

`count_compilations()` / `compilation_budget(n)`: the port compiles
nothing per shape.  What it compiles is the kernel library, built by
`kernels/_build.py` at first use and loaded once a process, so these
count its builds and loads; `compilation_budget(0)` pins a warmed
step.

Nothing here is imported by `python -m repro_torch.analysis`, which
stays stdlib-only; torch is imported when a guard is entered.
"""
from __future__ import annotations

import collections
import contextlib
import threading
import weakref
from typing import Callable, Dict, Iterator, List, Optional

_lock = threading.Lock()
_owners: Dict[threading.Thread, List[int]] = {}   # thread -> [blocks, lifts]
_released: "weakref.WeakSet[threading.Thread]" = weakref.WeakSet()
_saved = None           # the sync debug mode before the guard set one
_set = None             # the mode the guard last set (None: it set none)
_cuda: Optional[bool] = None
# the card's turn: its holder, how deep it holds it, the threads waiting
_turn: Optional[threading.Thread] = None
_turn_depth = 0
_turn_queue: "collections.deque[threading.Thread]" = collections.deque()
_turn_free = threading.Condition(_lock)
_TURN_POLL_S = 0.05     # how often a thread waiting for the turn says so

# ops that make the host wait on the device, by schema name
_HOST_READ_OPS = {
    "aten::_local_scalar_dense": "a scalar readback (.item(), int(), "
                                 "float(), bool() or a 0-d index)",
    "aten::nonzero": "nonzero (sized by the data)",
    "aten::bincount": "bincount (sized by the data)",
    "aten::masked_select": "masked_select (sized by the data)",
    "aten::equal": "torch.equal (a host bool)",
    "aten::_unique": "unique (sized by the data)",
    "aten::_unique2": "unique (sized by the data)",
    "aten::unique_dim": "unique (sized by the data)",
    "aten::unique_consecutive": "unique_consecutive (sized by the data)",
    "aten::unique_dim_consecutive": "unique_consecutive (sized by the data)",
}


class HostSyncError(RuntimeError):
    """A guarded block made the host wait on the device (strict mode)."""


def _has_cuda() -> bool:
    global _cuda
    if _cuda is None:
        import torch
        _cuda = (hasattr(torch._C, "_cuda_set_sync_debug_mode")
                 and torch.cuda.is_available())
    return _cuda


def _apply() -> None:
    """Set the process's sync debug mode from the open blocks (under
    _lock), and only where it changes."""
    global _saved, _set
    if not _has_cuda():
        return
    import torch
    lifted = [lifts > 0 for blocks, lifts in _owners.values() if blocks]
    if not lifted:                      # no block open: give the mode back
        if _set is not None:
            torch.cuda.set_sync_debug_mode(_saved)
            _set = None
        return
    if _set is None:
        _saved = torch.cuda.get_sync_debug_mode()
    want = _saved if all(lifted) else "error"
    if want != _set:
        torch.cuda.set_sync_debug_mode(want)
        _set = want


def _count(slot: int, by: int,
           owner: Optional[threading.Thread] = None) -> None:
    """Add `by` to `owner`'s (this thread's) open blocks (slot 0) or
    lifts (slot 1).  A released thread counts nothing."""
    owner = owner or threading.current_thread()
    with _lock:
        if owner in _released:
            return
        counts = _owners.setdefault(owner, [0, 0])
        counts[slot] += by
        if counts == [0, 0]:
            del _owners[owner]
        _apply()


def _lifted() -> bool:
    """Whether this thread is inside a lift (strict mode's check)."""
    counts = _owners.get(threading.current_thread())
    return counts is not None and counts[1] > 0


def lift() -> threading.Thread:
    """Open an explicit-transfer scope on this thread (`allow_transfers`);
    `unlift(owner)` closes it, where `owner` is what this returned.  The
    pair spans an asynchronous collective from its issue to its
    `wait()`."""
    owner = threading.current_thread()
    _count(1, 1, owner)
    return owner


def unlift(owner: Optional[threading.Thread] = None) -> None:
    _count(1, -1, owner)


@contextlib.contextmanager
def allow_transfers() -> Iterator[None]:
    """Lift the guard for an explicit transfer: a collective that stages
    through the host, as the reference's default mode lets
    device-to-device transfers through."""
    owner = lift()
    try:
        yield
    finally:
        unlift(owner)


def release(thread: threading.Thread) -> None:
    """Drop `thread`'s part in the guard: its open blocks, its lifts and
    its turn on the card (handed to the next waiter).  For a worker
    abandoned inside a step: its blocks would never close.  Whatever the
    thread does later is ignored by the guard and takes no turn."""
    global _turn, _turn_depth
    with _lock:
        _released.add(thread)
        _owners.pop(thread, None)
        if thread in _turn_queue:
            _turn_queue.remove(thread)
        if _turn is thread:
            _turn, _turn_depth = None, 0
            _turn_free.notify_all()
        _apply()


@contextlib.contextmanager
def card_turn(waiting: Callable[[], None] = lambda: None) -> Iterator[None]:
    """Hold the card's turn for the block: the threads that enter it run
    their blocks one at a time, in the order they asked (re-entrant).
    While it waits, the thread calls `waiting()` every _TURN_POLL_S s,
    with the guard's lock held: it must only record (a worker bumps its
    heartbeat: it waits on the card, it is not wedged).  A released
    thread runs its block without a turn."""
    me = threading.current_thread()
    held = _take_turn(me, waiting)
    try:
        yield
    finally:
        if held:
            _give_turn(me)


def _take_turn(me, waiting) -> bool:
    global _turn, _turn_depth
    with _lock:
        if me in _released:
            return False
        if _turn is me:
            _turn_depth += 1
            return True
        _turn_queue.append(me)
        try:
            while _turn is not None or _turn_queue[0] is not me:
                if not _turn_free.wait(_TURN_POLL_S):
                    waiting()
                if me in _released:
                    return False
            _turn_queue.popleft()
            _turn, _turn_depth = me, 1
            return True
        finally:
            if me in _turn_queue:       # released, or `waiting` raised
                _turn_queue.remove(me)


def _give_turn(me) -> None:
    global _turn, _turn_depth
    with _lock:
        if _turn is not me:             # released while it held the turn
            return
        _turn_depth -= 1
        if not _turn_depth:
            _turn = None
            _turn_free.notify_all()


def _host_read(func, args, kwargs) -> Optional[str]:
    """Why `func(*args, **kwargs)` makes the host wait, or None."""
    import torch
    name = func._schema.name
    if name in _HOST_READ_OPS:
        return _HOST_READ_OPS[name]
    if name in ("aten::index", "aten::index_put", "aten::index_put_"):
        idx = args[1] if len(args) > 1 else kwargs.get("indices", ())
        if any(t is not None and t.dtype in (torch.bool, torch.uint8)
               for t in idx):
            return f"{name} with a boolean mask (nonzero inside)"
    if name == "aten::_to_copy":
        src, dst = args[0], kwargs.get("device")
        if dst is not None and torch.device(dst).type == "cpu" \
                and src.device.type != "cpu":
            return f"a copy from {src.device} to the CPU"
    if name == "aten::copy_":
        dst, src = args[0], args[1]
        if dst.device.type == "cpu" and src.device.type != "cpu":
            return f"a copy from {src.device} to the CPU"
    return None


def _strict_modes():
    """The dispatch and function modes of `strict=True` (made here so
    that importing this module imports no torch)."""
    import torch
    from torch.overrides import TorchFunctionMode
    from torch.utils._python_dispatch import TorchDispatchMode

    class HostReads(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if not _lifted():
                why = _host_read(func, args, kwargs)
                if why is not None:
                    raise HostSyncError(
                        f"host read inside no_implicit_transfers(): {why} "
                        f"({func})")
            return func(*args, **kwargs)

    readbacks = {torch.Tensor.tolist: ".tolist()",
                 torch.Tensor.numpy: ".numpy()"}

    class Readbacks(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            if func in readbacks and not _lifted():
                raise HostSyncError(
                    f"host read inside no_implicit_transfers(): "
                    f"{readbacks[func]}")
            return func(*args, **(kwargs or {}))

    return HostReads(), Readbacks()


@contextlib.contextmanager
def no_implicit_transfers(strict: bool = False) -> Iterator[None]:
    """Make a host read inside the block raise.

    Wraps the serving engines' steps: their inputs are uploaded before
    or (pinned, `non_blocking=True`) inside the block, and nothing in
    the step may wait on the card.  The default mode is the card's own
    check (`torch.cuda.set_sync_debug_mode("error")`; nothing on a build
    without CUDA).  `strict=True` adds the dispatch check of every
    device, for the CPU tests; it costs a Python call per op, so no
    engine enters it.  Process-wide: see the module's docstring."""
    owner = threading.current_thread()
    _count(0, 1, owner)
    try:
        if not strict:
            yield
            return
        reads, calls = _strict_modes()
        with reads, calls:
            yield
    finally:
        _count(0, -1, owner)


class CompilationCounter:
    """Builds and loads of the kernel library since the counter began."""

    def __init__(self) -> None:
        from repro_torch.kernels import _build
        self._build = _build
        self._start = _build.builds + _build.loads

    @property
    def count(self) -> int:
        return self._build.builds + self._build.loads - self._start


@contextlib.contextmanager
def count_compilations() -> Iterator[CompilationCounter]:
    """Yield a CompilationCounter of the kernel library's builds (nvcc
    runs) and loads (`ctypes` opens) in the block: a warmed process
    counts 0."""
    yield CompilationCounter()


@contextlib.contextmanager
def compilation_budget(budget: int, what: str = "block") -> \
        Iterator[CompilationCounter]:
    """Assert at most `budget` builds or loads of the kernel library in
    the block.  The assertion is skipped if the body raised, so the
    budget never masks the original failure."""
    with count_compilations() as counter:
        yield counter
    if counter.count > budget:
        raise AssertionError(
            f"compilation budget exceeded for {what}: {counter.count} "
            f"kernel-library builds or loads > budget {budget} (a step "
            f"rebuilt or reloaded the kernels)")
