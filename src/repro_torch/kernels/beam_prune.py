"""Beam-threshold prune: entries of an (N,) score vector below
max - beam are set to -1e30.

Replaces the TPU kernel `beam_prune_pallas` (src/repro/kernels/
beam_prune.py), the hypothesis unit's standalone threshold stage.
CUDA source: `csrc/beam_prune.cu`.

What bounds it on the H100: bytes (8 N).  At the reference benchmark's
N = 8448 that is ~20 ns of memory time, so launch latency sets the time.
The design is one launch at every N that reads each score once: up to
N = 32768 one block holds the vector in registers; above it a
cooperative grid of at most one block per SM stages its slices in
shared memory, and the blocks agree on the max through an atomic and one
grid barrier.  The barrier's four scratch words are zeroed once per
(device, stream), and every call leaves them ready for the next, so no
fill runs before a call.  The max never goes back to the host: a
readback would synchronise.

On a CPU tensor the wrapper runs the plain version (`ref.beam_prune`).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

launches = 0        # kernel launches made by this wrapper
# largest N that one block holds in registers (BP_SMALL in the source)
SMALL = 1 << 15
_scratch = {}       # (device, stream) -> the grid barrier's scratch words


def capacity(device) -> int:
    """Scores the grid path keeps in shared memory on `device`: above it
    each block re-reads the tail of its slice from L2."""
    with torch.cuda.device(device):
        cap = _build.lib().beam_prune_capacity()
    if cap < 0:
        _build.check(-cap, "beam_prune_capacity")
    return cap


def beam_prune(scores: torch.Tensor, beam: float) -> torch.Tensor:
    """scores: (N,) f32, N >= 1 -> (N,) f32 with entries < max - beam
    set to -1e30 (bitwise `ref.beam_prune`)."""
    global launches
    if not scores.is_cuda:
        return ref.beam_prune(scores, beam)
    _build.refuse_grad("beam_prune", scores)
    dev = scores.device
    _build.require(scores, "scores", torch.float32, 1, dev)
    n = scores.shape[0]
    if not 1 <= n < 2 ** 31:
        raise ValueError(f"beam_prune: expected 1 <= N < 2**31 scores, got {n}")
    out = torch.empty_like(scores)
    stream = _build.stream(dev)
    scratch = None
    if n > SMALL:
        scratch = _scratch.get((dev, stream))
        if scratch is None:
            scratch = _scratch[(dev, stream)] = torch.zeros(
                (4,), dtype=torch.int32, device=dev)
    err = _build.lib().beam_prune_launch(
        scores.data_ptr(), out.data_ptr(),
        None if scratch is None else scratch.data_ptr(), n, float(beam),
        stream)
    _build.check(err, "beam_prune")
    launches += 1
    return out
