"""Block-wise symmetric int8 quantization, port of `repro/core/quant.py`.

Over the last dim in blocks of 128: per block `scale = max|x| / 127`,
`q = round(x / max(scale, 1e-12))` clipped to [-127, 127].  Used by
`optim/adamw` (8-bit optimizer moments).

The values equal the reference's bit for bit on every device:
`torch.round` rounds half to even as `jnp.round` does (a cast would
truncate), and both divisions divide by a tensor.  On the card torch
divides by a Python scalar as a product with its reciprocal, which
rounds some scales one ulp away from the division.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

BLOCK = 128


def quantize(x: torch.Tensor, block: int = BLOCK) -> dict:
    """x: (..., D) -> {'q': int8 (..., D), 'scale': f32 (..., D/block)}."""
    D = x.shape[-1]
    pad = (-D) % block
    xf = x.float()
    if pad:
        xf = F.pad(xf, (0, pad))
    nb = xf.shape[-1] // block
    xb = xf.reshape(*xf.shape[:-1], nb, block)
    amax = xb.abs().amax(dim=-1)                                  # (..., nb)
    scale = amax / torch.full_like(amax, 127.0)
    q = torch.round(xb / torch.clamp(scale[..., None], min=1e-12))
    q = torch.clamp(q, -127, 127).to(torch.int8)
    q = q.reshape(*xf.shape[:-1], nb * block)[..., :D]
    return {"q": q, "scale": scale}


def dequantize(qs: dict, block: int = BLOCK) -> torch.Tensor:
    q, scale = qs["q"], qs["scale"]
    D = q.shape[-1]
    pad = (-D) % block
    qf = q.float()
    if pad:
        qf = F.pad(qf, (0, pad))
    nb = qf.shape[-1] // block
    xb = qf.reshape(*qf.shape[:-1], nb, block) * scale[..., None]
    return xb.reshape(*qf.shape[:-1], nb * block)[..., :D]
