"""Beam-threshold prune: entries of an (N,) score vector below
max - beam are set to -1e30.

Replaces the TPU kernel `beam_prune_pallas` (src/repro/kernels/
beam_prune.py), the hypothesis unit's standalone threshold stage.
CUDA source: `csrc/beam_prune.cu`.

What bounds it on the H100: bytes (8 N).  At the reference benchmark's
N = 8448 that is ~20 ns of memory time, so launch latency sets the time;
the design keeps that to one launch up to N = 65536 (one block does both
passes) and uses two launches above it (per-block maxima into a small
scratch, then a mask pass whose blocks each reduce those maxima).  The
max never goes back to the host: a readback would synchronise.

On a CPU tensor the wrapper runs the plain version (`ref.beam_prune`).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

launches = 0        # kernel launches made by this wrapper
# largest N that one block handles in one launch (BP_SMALL in the source)
_SMALL = 1 << 16
# capacity of the per-block maxima scratch: at most this many blocks
# (each of at least 4096 scores) in the two-pass path
_PARTIALS = 1024


def beam_prune(scores: torch.Tensor, beam: float) -> torch.Tensor:
    """scores: (N,) f32, N >= 1 -> (N,) f32 with entries < max - beam
    set to -1e30 (bitwise `ref.beam_prune`)."""
    global launches
    if not scores.is_cuda:
        return ref.beam_prune(scores, beam)
    dev = scores.device
    _build.require(scores, "scores", torch.float32, 1, dev)
    n = scores.shape[0]
    if not 1 <= n < 2 ** 31:
        raise ValueError(f"beam_prune: expected 1 <= N < 2**31 scores, got {n}")
    out = torch.empty_like(scores)
    if n <= _SMALL:         # one launch; the kernel takes no scratch
        partial, n_partials, n_launch = out, 1, 1
    else:
        partial = torch.empty((_PARTIALS,), dtype=torch.float32, device=dev)
        n_partials, n_launch = _PARTIALS, 2
    err = _build.lib().beam_prune_launch(
        scores.data_ptr(), out.data_ptr(), partial.data_ptr(), n, n_partials,
        float(beam), _build.stream(dev))
    _build.check(err, "beam_prune")
    launches += n_launch
    return out
