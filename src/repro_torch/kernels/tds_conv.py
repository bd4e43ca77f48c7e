"""Causal strided TDS time convolution with the fused conv epilogue, and
the same conv with the LayerNorm that follows it fused in.

Replaces the TPU kernel `tds_conv_pallas` (src/repro/kernels/tds_conv.py)
and, in `tds_conv_ln`, the `norm_pallas` LayerNorm after it.  CUDA
source: `csrc/tds_conv.cu`; both wrappers launch its one kernel and count
into `launches`.

x (B, k-1+T, W, Cin) left-padded, channels last; w (k, Cin, Cout) with
Cout <= 24; b (Cout,); optional res (B, T//stride, W, Cout) added after
the ReLU.  Returns (B, T//stride, W, Cout).  `tds_conv_ln` then
normalises each (b, t) row of W*Cout values with `ln_scale`/`ln_bias`
(W*Cout,).

What bounds it on the H100: neither roof.  At the main path's shapes a
launch moves a few hundred KB and does at most ~10 M FMAs, so latency
sets its time.  The design (header of the CUDA source): a LayerNorm row
per thread block cluster of up to 6 blocks that split its W positions,
the row's input frames and the weight staged once per block with
cp.async, 2 positions x 8 channels of accumulators a thread (fp32 FMA:
channel counts this small fill no tensor-core tile), the row's mean and
variance combined from per-warp partials through distributed shared
memory after one cluster barrier, and the output written once.

On a CPU tensor the wrappers run the plain versions
(`ref.tds_conv_fused`, `ref.tds_conv_ln`).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build, ref

launches = 0        # kernel launches made by this module's wrappers

MAX_COUT = 24       # at most three groups of 8 output channels
# values of a LayerNorm row one block of its cluster (at most 8) can hold:
# 4 a thread, 512 threads
LN_BLOCK_MAX = 4 * 512


def tds_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
             res: Optional[torch.Tensor] = None, *, stride: int = 1,
             relu: bool = False) -> torch.Tensor:
    if not x.is_cuda:
        return ref.tds_conv_fused(x, w, b, stride=stride, relu=relu, res=res)
    return _launch(x, w, b, res, None, None, stride, relu, 1e-5, 0)


def tds_conv_ln(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                ln_scale: torch.Tensor, ln_bias: torch.Tensor,
                res: Optional[torch.Tensor] = None, *, stride: int = 1,
                relu: bool = False, eps: float = 1e-5,
                split: int = 0) -> torch.Tensor:
    """`split` is the blocks per LayerNorm row: 0 lets the kernel choose
    (a cluster per row), 1 is the block-per-row variant, kept so that
    the two designs can be timed against each other."""
    if not x.is_cuda:
        return ref.tds_conv_ln(x, w, b, ln_scale, ln_bias, stride=stride,
                               relu=relu, res=res, eps=eps)
    return _launch(x, w, b, res, ln_scale, ln_bias, stride, relu, eps, split)


def _launch(x, w, b, res, ln_scale, ln_bias, stride, relu, eps, split):
    global launches
    _build.refuse_grad("tds_conv", x, w, b, res, ln_scale, ln_bias)
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
    if Cout > MAX_COUT:
        raise ValueError(f"tds_conv: Cout={Cout} > {MAX_COUT}")
    if T < 0 or T % stride:
        raise ValueError(f"tds_conv: T={T} must be >= 0 and a multiple of "
                         f"stride={stride}")
    t_out = T // stride
    if res is not None:
        _build.require(res, "res", torch.float32, 4, dev)
        if tuple(res.shape) != (B, t_out, W, Cout):
            raise ValueError(f"tds_conv: res {tuple(res.shape)} != output "
                             f"{(B, t_out, W, Cout)}")
    if ln_scale is not None:
        _build.require(ln_scale, "ln_scale", torch.float32, 1, dev)
        _build.require(ln_bias, "ln_bias", torch.float32, 1, dev)
        if ln_scale.shape[0] != W * Cout or ln_bias.shape[0] != W * Cout:
            raise ValueError(f"tds_conv_ln: ln_scale {tuple(ln_scale.shape)}"
                             f", ln_bias {tuple(ln_bias.shape)} != "
                             f"({W * Cout},)")
        if -(-W // 8) * Cout > LN_BLOCK_MAX:
            raise ValueError(f"tds_conv_ln: a row of W={W} positions of "
                             f"{Cout} channels does not fit 8 blocks of "
                             f"{LN_BLOCK_MAX} values")
    out = torch.empty((B, t_out, W, Cout), dtype=torch.float32, device=dev)
    ptr = (lambda t: None if t is None else t.data_ptr())
    err = _build.lib().tds_conv_launch(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), ptr(res), ptr(ln_scale),
        ptr(ln_bias), out.data_ptr(), B, Tp, W, Cin, Cout, k, stride, t_out,
        int(relu), int(split), float(eps), _build.stream(dev))
    _build.check(err, "tds_conv_ln" if ln_scale is not None else "tds_conv")
    launches += 1
    return out
