"""Causal strided TDS time convolution with the fused conv epilogue.

Replaces the TPU kernel `tds_conv_pallas` (src/repro/kernels/tds_conv.py).
CUDA source: `csrc/tds_conv.cu`.

x (B, k-1+T, W, Cin) left-padded, channels last; w (k, Cin, Cout);
b (Cout,); optional res (B, T//stride, W, Cout) added after the ReLU.
Returns (B, T//stride, W, Cout).

What bounds it on the H100: at the main path's shapes (B*T_out*W rows
of at most 23 channels) the FMA count is small (at most about 3 MFLOP a
launch) and the bytes are a few hundred KB, so one launch is far below
both roofs and latency sets its time.  The design: one thread per
output element, plain fp32 FMA (channel counts this small use no
tensor-core tile), the whole k x Cin x Cout weight in shared memory,
and the bias -> ReLU -> residual epilogue fused so the activation is
written once.

On a CPU tensor the wrapper runs the plain version
(`ref.tds_conv_fused`).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build, ref

launches = 0        # kernel launches made by this wrapper


def tds_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
             res: Optional[torch.Tensor] = None, *, stride: int = 1,
             relu: bool = False) -> torch.Tensor:
    global launches
    if not x.is_cuda:
        return ref.tds_conv_fused(x, w, b, stride=stride, relu=relu, res=res)
    dev = x.device
    _build.require(x, "x", torch.float32, 4, dev)
    _build.require(w, "w", torch.float32, 3, dev)
    _build.require(b, "b", torch.float32, 1, dev)
    B, Tp, W, Cin = x.shape
    k, wcin, Cout = w.shape
    T = Tp - (k - 1)
    if wcin != Cin or b.shape[0] != Cout:
        raise ValueError(f"tds_conv: x {tuple(x.shape)}, w {tuple(w.shape)}, "
                         f"b {tuple(b.shape)} disagree")
    if T < 0 or T % stride:
        raise ValueError(f"tds_conv: T={T} must be >= 0 and a multiple of "
                         f"stride={stride}")
    t_out = T // stride
    if res is not None:
        _build.require(res, "res", torch.float32, 4, dev)
        if tuple(res.shape) != (B, t_out, W, Cout):
            raise ValueError(f"tds_conv: res {tuple(res.shape)} != output "
                             f"{(B, t_out, W, Cout)}")
    out = torch.empty((B, t_out, W, Cout), dtype=torch.float32, device=dev)
    err = _build.lib().tds_conv_launch(
        x.data_ptr(), w.data_ptr(), b.data_ptr(),
        None if res is None else res.data_ptr(), out.data_ptr(),
        B, Tp, W, Cin, Cout, k, stride, t_out, int(relu), _build.stream(dev))
    _build.check(err, "tds_conv")
    launches += 1
    return out
