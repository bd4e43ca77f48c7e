"""Row LayerNorm (with an optional bias + residual prologue) and RMSNorm
with fp32 statistics.

Replaces the TPU kernel `norm_pallas` (src/repro/kernels/layernorm.py):
`layernorm` and `bias_residual_layernorm` its `kind="layernorm"` half
(the TDS acoustic model's fp32 rows; `layernorm` also the LM's bf16
rows, musicgen-medium's), `rmsnorm` its `kind="rmsnorm"` half (the LM's
RMSNorms).  CUDA source: `csrc/layernorm.cu`.  `layernorm` and
`bias_residual_layernorm` launch one kernel and count into `launches`;
`rmsnorm` counts into `rmsnorm_launches`.

What bounds them on the H100: bytes.  Each row (D <= 1840 floats for the
TDS LayerNorms, D = 1536 bf16 for musicgen-medium, D = 2560 bf16 for
h2o-danube-1.8b) is read once and written once, and the arithmetic is a
handful of operations per element.  Both keep the row in registers and
move 16 bytes a lane.  LayerNorm: (y + add_bias) + res in fp32 (the TDS
FC block's bias and residual, which would otherwise be two elementwise
launches; fp32 rows only), the mean, then the mean of squared
deviations, one block of up to 512 threads per row with one barrier
(each warp's partial statistics combined exactly), then
((x - mu) * rsqrt(var + eps)) * scale + bias rounded once to the row's
type.  RMSNorm: one block of 256 threads per row with one barrier; var =
mean(x²) in fp32, then (x·rsqrt(var + eps))·scale, rounded once to x's
dtype, as `apply_norm` does.  Rows that are not 16-byte aligned take
scalar block-per-row kernels.

On a CPU tensor a wrapper runs its plain version
(`ref.bias_residual_layernorm`, `ref.layernorm`, `ref.rmsnorm`).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build, ref

launches = 0            # launches of `layernorm`/`bias_residual_layernorm`
rmsnorm_launches = 0    # kernel launches made by `rmsnorm`


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """x: (R, D) f32 or bf16; scale/bias: (D,) f32 -> (R, D) in x's
    dtype."""
    if not x.is_cuda:
        return ref.layernorm(x, scale, bias, eps=eps)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"layernorm: expected float32 or bfloat16 rows, got "
                         f"{x.dtype}")
    return _launch(x, x.dtype, scale, bias, None, None, eps)


def bias_residual_layernorm(y: torch.Tensor, scale: torch.Tensor,
                            bias: torch.Tensor, *,
                            add_bias: Optional[torch.Tensor] = None,
                            res: Optional[torch.Tensor] = None,
                            eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm of (y + add_bias) + res.  y, res: (R, D) f32; add_bias,
    scale, bias: (D,) -> (R, D) f32."""
    if not y.is_cuda:
        return ref.bias_residual_layernorm(y, scale, bias, add_bias=add_bias,
                                           res=res, eps=eps)
    return _launch(y, torch.float32, scale, bias, add_bias, res, eps)


def _launch(y, dtype, scale, bias, add_bias, res, eps) -> torch.Tensor:
    """Checks, then one launch of `layernorm_launch` over y's rows of
    `dtype` (f32 with the optional addends, or bf16 without them)."""
    global launches
    _build.refuse_grad("layernorm", y, scale, bias, add_bias, res)
    dev = y.device
    _build.require(y, "y", dtype, 2, dev)
    _build.require(scale, "scale", torch.float32, 1, dev)
    _build.require(bias, "bias", torch.float32, 1, dev)
    R, D = y.shape
    if scale.shape[0] != D or bias.shape[0] != D:
        raise ValueError(f"layernorm: y {tuple(y.shape)}, scale "
                         f"{tuple(scale.shape)}, bias {tuple(bias.shape)}")
    if add_bias is not None:
        _build.require(add_bias, "add_bias", torch.float32, 1, dev)
        if add_bias.shape[0] != D:
            raise ValueError(f"layernorm: add_bias {tuple(add_bias.shape)} "
                             f"!= ({D},)")
    if res is not None:
        _build.require(res, "res", torch.float32, 2, dev)
        if res.shape != y.shape:
            raise ValueError(f"layernorm: res {tuple(res.shape)} != y "
                             f"{tuple(y.shape)}")
    out = torch.empty_like(y)
    err = _build.lib().layernorm_launch(
        y.data_ptr(), None if add_bias is None else add_bias.data_ptr(),
        None if res is None else res.data_ptr(), scale.data_ptr(),
        bias.data_ptr(), out.data_ptr(), R, D, float(eps),
        int(y.dtype == torch.bfloat16), _build.stream(dev))
    _build.check(err, "layernorm")
    launches += 1
    return out


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """x: (R, D) bf16 or f32; scale: (D,) f32 -> (R, D) in x's dtype."""
    global rmsnorm_launches
    if not x.is_cuda:
        return ref.rmsnorm(x, scale, eps=eps)
    _build.refuse_grad("rmsnorm", x, scale)
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
