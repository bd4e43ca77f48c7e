"""Public kernel entry points, dispatched by `KernelPolicy`.

Port of the decode-path half of `repro/kernels/ops.py`.  Each function
resolves its policy against the device of its input (see
`kernels/policy.py`): ``ref`` runs the plain PyTorch version in
`kernels/ref.py` (CPU or card), ``kernel`` the CUDA kernel's wrapper
(card only).  The wrappers never fall back: a failed build or launch
raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import hypothesis_unit as _hu
from repro_torch.kernels import layernorm as _ln
from repro_torch.kernels import logmel as _lm
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import tds_conv as _tc
from repro_torch.kernels.policy import resolve

KERNEL_MODULES = {"logmel": _lm, "tds_conv": _tc, "layernorm": _ln,
                  "hypothesis_unit": _hu}


def launch_counts() -> dict:
    """Launches each CUDA kernel's wrapper has made: {name: count}."""
    return {name: mod.launches for name, mod in KERNEL_MODULES.items()}


def reset_launch_counts() -> None:
    for mod in KERNEL_MODULES.values():
        mod.launches = 0


def layernorm(x, scale, bias, *, eps=1e-5, policy=None):
    if resolve(policy, x) == "ref":
        return _ref.layernorm(x, scale, bias, eps=eps)
    return _ln.layernorm(x.contiguous(), scale, bias, eps=eps)


def logmel(power, fb, dct, policy=None):
    if resolve(policy, power) == "ref":
        return _ref.logmel(power, fb, dct)
    return _lm.logmel(power.contiguous(), fb, dct)


def tds_conv(x, w, b, *, stride=1, relu=False, res=None, policy=None):
    """Causal strided TDS conv with the fused bias+ReLU+residual
    epilogue.  x: (B, k-1+T, W, Cin) slot-batched (3-D = B=1)."""
    mode = resolve(policy, x)
    squeeze = x.dim() == 3
    if squeeze:
        x = x[None]
        res = None if res is None else res[None]
    if mode == "ref":
        out = _ref.tds_conv_fused(x, w, b, stride=stride, relu=relu, res=res)
    else:
        out = _tc.tds_conv(x.contiguous(), w, b,
                           None if res is None else res.contiguous(),
                           stride=stride, relu=relu)
    return out[0] if squeeze else out


def hypothesis_unit(hashes, pb, pnb, k, beam, policy=None):
    """Fused hypothesis unit over a batch of candidate rows.

    hashes: (B, N) int 31-bit prefix hashes; pb/pnb: (B, N) f32 CTC
    channels.  Merges duplicate hashes (channel-wise logsumexp), applies
    the beam threshold, and selects the top-`k` per row.  Returns a dict
    of (B, k) tensors: `idx` (int32 index of each selected
    representative into the original row), merged `pb`/`pnb` (NEG_INF
    where pruned), and bool `valid`."""
    B, N = hashes.shape
    if N < k:
        raise ValueError(f"hypothesis_unit: N={N} < k={k}")
    if resolve(policy, hashes) == "ref":
        return _ref.hypothesis_unit(hashes, pb, pnb, k=k, beam=float(beam))
    return _hu.hypothesis_unit(hashes.to(torch.int32).contiguous(),
                               pb.contiguous(), pnb.contiguous(), k=k,
                               beam=float(beam))
