"""Row LayerNorm with fp32 statistics (mean, then mean of squared deviations).

Replaces the TPU kernel `norm_pallas(kind="layernorm")`
(src/repro/kernels/layernorm.py); its `kind="rmsnorm"` half serves the
LM stack and is not ported yet.  CUDA source: `csrc/layernorm.cu`.

What bounds it on the H100: bytes.  Each row of D <= 1840 floats is read
once and written once, and the arithmetic is a handful of operations per
element.  The design: one block per row, the row staged in shared
memory so the two reduction passes and the affine step read device
memory once, warp-shuffle reductions.

On a CPU tensor the wrapper runs the plain version (`ref.layernorm`).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

launches = 0        # kernel launches made by this wrapper


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """x: (R, D) f32; scale/bias: (D,) -> (R, D) f32."""
    global launches
    if not x.is_cuda:
        return ref.layernorm(x, scale, bias, eps=eps)
    dev = x.device
    _build.require(x, "x", torch.float32, 2, dev)
    _build.require(scale, "scale", torch.float32, 1, dev)
    _build.require(bias, "bias", torch.float32, 1, dev)
    R, D = x.shape
    if scale.shape[0] != D or bias.shape[0] != D:
        raise ValueError(f"layernorm: x {tuple(x.shape)}, scale "
                         f"{tuple(scale.shape)}, bias {tuple(bias.shape)}")
    out = torch.empty_like(x)
    err = _build.lib().layernorm_launch(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(),
        R, D, float(eps), _build.stream(dev))
    _build.check(err, "layernorm")
    launches += 1
    return out
