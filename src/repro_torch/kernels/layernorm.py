"""Row LayerNorm and RMSNorm with fp32 statistics.

Replaces the TPU kernel `norm_pallas` (src/repro/kernels/layernorm.py):
`layernorm` its `kind="layernorm"` half (the TDS acoustic model),
`rmsnorm` its `kind="rmsnorm"` half (every norm of the LM stack).  CUDA
source: `csrc/layernorm.cu`.  Each wrapper counts its own launches.

What bounds them on the H100: bytes.  Each row (D <= 1840 floats for the
TDS LayerNorms, D = 2560 bf16 for h2o-danube-1.8b) is read once and
written once, and the arithmetic is a handful of operations per element.
`layernorm`: one block per row, the row staged in shared memory as fp32
so the reduction and the normalising pass read device memory once,
warp-shuffle reductions.  `rmsnorm` keeps the row in registers and
moves 16 bytes a lane (8 bf16 or 4 fp32; `scale` as float4), one block
of 256 threads per row with one barrier; rows that are not 16-byte
aligned take a scalar block-per-row kernel.  The statistics and
rounding are `apply_norm`'s: var = mean(x²) in fp32, then
(x·rsqrt(var + eps))·scale, rounded once to x's dtype.

On a CPU tensor a wrapper runs its plain version (`ref.layernorm`,
`ref.rmsnorm`).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

launches = 0            # kernel launches made by `layernorm`
rmsnorm_launches = 0    # kernel launches made by `rmsnorm`


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


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """x: (R, D) bf16 or f32; scale: (D,) f32 -> (R, D) in x's dtype."""
    global rmsnorm_launches
    if not x.is_cuda:
        return ref.rmsnorm(x, scale, eps=eps)
    dev = x.device
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"rmsnorm: expected float32 or bfloat16 rows, got "
                         f"{x.dtype}")
    _build.require(x, "x", x.dtype, 2, dev)
    _build.require(scale, "scale", torch.float32, 1, dev)
    R, D = x.shape
    if scale.shape[0] != D:
        raise ValueError(f"rmsnorm: x {tuple(x.shape)}, scale "
                         f"{tuple(scale.shape)}")
    out = torch.empty_like(x)
    err = _build.lib().rmsnorm_launch(
        x.data_ptr(), scale.data_ptr(), out.data_ptr(), R, D, float(eps),
        int(x.dtype == torch.bfloat16), _build.stream(dev))
    _build.check(err, "rmsnorm")
    rmsnorm_launches += 1
    return out
