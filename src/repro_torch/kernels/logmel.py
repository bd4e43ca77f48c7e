"""Fused log-mel + DCT (the MFCC tail): out = log(max(P @ fb, 1e-10)) @ dct.

Replaces the TPU kernel `logmel_pallas` (src/repro/kernels/logmel.py).
CUDA source: `csrc/logmel.cu`.

What bounds it on the H100: neither bytes nor operations at the main
path's size.  One decoding step passes R = b*w*8 <= 128 power rows
(about 0.3 MB with fb and dct, 7 MFLOP), a few hundred nanoseconds of
either; latency sets the time.  The design: one block per row, the mel
and DCT sums split over the block's threads, and the mel intermediate
kept in shared memory, so the kernel reads each input once and writes
only the (R, 80) result.

On a CPU tensor the wrapper runs the plain version (`ref.logmel`).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

launches = 0        # kernel launches made by this wrapper


def logmel(power: torch.Tensor, fb: torch.Tensor,
           dct: torch.Tensor) -> torch.Tensor:
    """power: (R, F) f32; fb: (F, M); dct: (M, C) -> (R, C) f32."""
    global launches
    if not power.is_cuda:
        return ref.logmel(power, fb, dct)
    dev = power.device
    for t, name in ((power, "power"), (fb, "fb"), (dct, "dct")):
        _build.require(t, name, torch.float32, 2, dev)
    R, F = power.shape
    if fb.shape[0] != F or dct.shape[0] != fb.shape[1]:
        raise ValueError(f"logmel: shapes {tuple(power.shape)}, "
                         f"{tuple(fb.shape)}, {tuple(dct.shape)} do not chain")
    M, C = dct.shape
    if M > 256 or C > 256:
        raise ValueError(f"logmel: at most 256 mel bins and coefficients, "
                         f"got {M} and {C}")
    out = torch.empty((R, C), dtype=torch.float32, device=dev)
    err = _build.lib().logmel_launch(
        power.data_ptr(), fb.data_ptr(), dct.data_ptr(), out.data_ptr(),
        R, F, M, C, _build.stream(dev))
    _build.check(err, "logmel")
    launches += 1
    return out
