"""What one launch of each Hopper kernel costs, by formula, and the hook
through which an op counter counts a launch as one fused op.

The formulas are the kernels' work as their bounds count it: each input
read once and each output written once (`tensor_bytes`), and the
products' operations (matmuls, the convolution, attention), as
`torch.utils.flop_counter` and the reference's HLO walker count
operations; elementwise work is in the bytes only.  Flash attention
counts the (q, k) pairs its mask keeps (`attn_pairs`), not the masked
tiles a plain version computes.  `chip_smoke.py` takes its bounds from
here, and `launch/op_cost.py`'s counter its kernel ops.

The hook: `kernels/ops.py` decorates each public wrapper that launches a
kernel with `fused(name)`.  While a counter is active (`counting`), a
call whose policy would launch the kernel on the card (`auto` or
`kernel`) runs its plain version with the counter paused, then reports
itself as one op to the counter; without a counter the wrapper runs as
it always does.
"""
from __future__ import annotations

import functools
import inspect

import numpy as np
import torch

# the counters entered (`counting`), innermost last
_ACTIVE: list = []


def bucket(dtype: torch.dtype) -> str:
    """The peak an operation of `dtype` operands runs at: "bf16" (bf16
    and fp16 on the tensor cores), "int8", else "fp32" (the CUDA cores;
    the port keeps TF32 off)."""
    if dtype in (torch.bfloat16, torch.float16):
        return "bf16"
    if dtype in (torch.int8, torch.uint8):
        return "int8"
    return "fp32"


def tensor_bytes(t: torch.Tensor) -> int:
    """The bytes of the distinct elements `t` addresses: an expanded
    (stride 0) dimension is read once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size() if t.numel() else 0


@functools.lru_cache(maxsize=256)
def attn_pairs(sq: int, skv: int, window, causal: bool = True) -> int:
    """Unmasked (q, k) pairs of one head, q right-aligned to the end of
    kv: the work the flash kernel's inputs need."""
    qpos = np.arange(sq, dtype=np.int64) + (skv - sq)
    hi = np.minimum(qpos, skv - 1) if causal else np.full(sq, skv - 1)
    lo = np.maximum(qpos - window + 1, 0) if window else np.zeros(sq)
    return int(np.maximum(hi - lo + 1, 0).sum())


def flash_flops(q: torch.Tensor, k: torch.Tensor, causal: bool,
                window) -> float:
    """Both products of flash attention: 4·D operations per kept (q, k)
    pair and query head."""
    B, H, Sq, D = q.shape
    return 4.0 * D * H * B * attn_pairs(Sq, k.shape[2], window,
                                        bool(causal))


def _flops(name: str, a: dict, out) -> tuple:
    """(peak bucket, operations) of one launch of kernel `name`, from the
    wrapper's bound arguments `a` and its output."""
    if name == "flash_attention":
        q = a["q"]
        return bucket(q.dtype), flash_flops(q, a["k"], a["causal"],
                                            a["window"])
    if name == "int8_matmul":
        x, wq = a["x"], a["wq"]
        return "int8", 2.0 * x.shape[0] * wq.shape[0] * wq.shape[1]
    if name == "tds_conv":
        x, w = a["x"], a["w"]
        if x.dim() == 3:
            x = x[None]
        k, _, cout = w.shape
        cin = x.shape[-1]
        t_out = out.shape[-3]
        return "fp32", 2.0 * x.shape[0] * t_out * x.shape[2] * cout * k * cin
    if name == "logmel":
        if "power" in a:                      # the tail: (R, F) rows
            rows = a["power"].numel() // a["power"].shape[-1]
            f, m = a["fb"].shape
            return "fp32", 2.0 * rows * (f * m + m * a["dct"].shape[1])
        tb = a["tables"]                      # the whole MFCC
        m, c = tb.dct.shape
        rows = out.numel() // c
        return "fp32", 2.0 * rows * (tb.band_weights.numel() + m * c)
    return "fp32", 0.0


def fused(name: str):
    """Decorate a public wrapper of `kernels/ops.py` that launches kernel
    `name` (its `launch_counts` key): under an active counter, one
    call is one op of the formula's operations and bytes."""
    def wrap(fn):
        sig = inspect.signature(fn)

        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _ACTIVE:
                return fn(*args, **kwargs)
            bound = sig.bind(*args, **kwargs)
            bound.apply_defaults()
            policy = bound.arguments.get("policy")
            if policy is not None and policy.mode == "ref":
                return fn(*args, **kwargs)
            counter = _ACTIVE[-1]
            with counter.paused():
                out = fn(*args, **kwargs)
            kind, ops = _flops(name, bound.arguments, out)
            counter.kernel_op(name, kind, ops, bound.arguments, out)
            return out
        return call
    return wrap


def counting(counter):
    """Enter `counter` as the active one (a context manager's body calls
    this and `done`)."""
    _ACTIVE.append(counter)


def done(counter) -> None:
    _ACTIVE.remove(counter)
