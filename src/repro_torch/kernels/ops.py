"""Public kernel entry points, dispatched by `KernelPolicy`.

Port of `repro/kernels/ops.py` (all but the mesh helpers).  Each
function resolves its policy against the device of its input (see
`kernels/policy.py`): ``ref`` runs the plain PyTorch version in
`kernels/ref.py` (CPU or card), ``kernel`` the CUDA kernel's wrapper
(card only).  The wrappers never fall back: a failed build or launch
raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import beam_prune as _bp
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import hypothesis_unit as _hu
from repro_torch.kernels import int8_matmul as _im
from repro_torch.kernels import layernorm as _ln
from repro_torch.kernels import logmel as _lm
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import tds_conv as _tc
from repro_torch.kernels.policy import resolve

KERNEL_MODULES = {"logmel": _lm, "tds_conv": _tc, "layernorm": _ln,
                  "hypothesis_unit": _hu, "int8_matmul": _im,
                  "rmsnorm": _ln, "flash_attention": _fa,
                  "beam_prune": _bp}
# the module attribute holding a kernel's count, where it is not
# `launches` (layernorm.py counts its two wrappers apart)
_COUNTERS = {"rmsnorm": "rmsnorm_launches"}


def launch_counts() -> dict:
    """Launches each CUDA kernel's wrapper has made: {name: count}."""
    return {name: getattr(mod, _COUNTERS.get(name, "launches"))
            for name, mod in KERNEL_MODULES.items()}


def reset_launch_counts() -> None:
    for name, mod in KERNEL_MODULES.items():
        setattr(mod, _COUNTERS.get(name, "launches"), 0)


def layernorm(x, scale, bias, *, eps=1e-5, policy=None):
    if resolve(policy, x) == "ref":
        return _ref.layernorm(x, scale, bias, eps=eps)
    return _ln.layernorm(x.contiguous(), scale, bias, eps=eps)


def rmsnorm(x, scale, *, eps=1e-6, policy=None):
    """x: (R, D) bf16/f32; scale: (D,) f32 -> (R, D) in x's dtype."""
    if resolve(policy, x) == "ref":
        return _ref.rmsnorm(x, scale, eps=eps)
    return _ln.rmsnorm(x.contiguous(), scale.float().contiguous(), eps=eps)


def flash_attention(q, k, v, *, causal=True, window=None, policy=None):
    """q: (B, H, Sq, D); k, v: (B, K, Skv, D) with K | H -> (B, H, Sq, D).

    Forward attention with fp32 softmax, q right-aligned to the end of
    kv.  The kernel path makes the operands contiguous (a transposed
    view, such as the model's (B, S, H, D) activations seen as
    (B, H, S, D), is copied once)."""
    if resolve(policy, q) == "ref":
        return _ref.flash_attention(q, k, v, causal=causal, window=window)
    return _fa.flash_attention(q.contiguous(), k.contiguous(),
                               v.contiguous(), causal=causal, window=window)


def logmel(power, fb, dct, policy=None):
    if resolve(policy, power) == "ref":
        return _ref.logmel(power, fb, dct)
    return _lm.logmel(power.contiguous(), fb, dct)


def beam_prune(scores, beam, policy=None):
    """scores: (N,) f32 -> scores with entries < max - beam set to -1e30
    (the hypothesis unit's standalone threshold stage)."""
    if resolve(policy, scores) == "ref":
        return _ref.beam_prune(scores, beam)
    return _bp.beam_prune(scores.contiguous(), beam)


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


# ---------------------------------------------------------------------------
# int8 path: ASRPU's 8-bit MAC (paper §3.4)
# ---------------------------------------------------------------------------
def quantize_rows(x):
    """Symmetric per-row int8: x (M, K) -> (q i8, scale f32 (M,)).

    Plain torch on every device, as the reference computes it outside
    any kernel.  `torch.round` rounds half to even like `jnp.round`, and
    the division is by the clamped scale (not a product with its
    reciprocal), so q and the scales equal the reference's bit for bit."""
    xf = x.float()
    s = xf.abs().amax(dim=1) / 127.0
    q = torch.clamp(torch.round(xf / torch.clamp(s[:, None], min=1e-12)),
                    -127, 127).to(torch.int8)
    return q, s


def prepare_int8_weights(w):
    """Quantize a static weight matrix once: w (K, N) float -> (wq (K, N)
    i8, ws (N,) f32 per-output-column scales), so that the decode hot
    path only quantizes activations.  wq is the transposed view of the
    (N, K) quantization, K-contiguous: the int8 kernel's weight layout."""
    wq_t, ws = quantize_rows(w.t())
    # elementwise ops keep w.t()'s strides: make the (N, K) rows dense
    return wq_t.contiguous().t(), ws


def int8_matmul_prepared(x, wq, ws, *, policy=None, axis=None):
    """x: (M, K) float; wq/ws from `prepare_int8_weights` -> (M, N) f32.

    The hot-path half of the int8 pipeline: per-row activation
    quantization, the int8 matmul and the fp32 rescale.  `axis` (a
    model-parallel mesh axis in the reference) is not ported."""
    if axis is not None:
        raise NotImplementedError("int8_matmul_prepared: the sharded "
                                  "(axis=) contraction is not ported")
    xq, xs = quantize_rows(x)
    if resolve(policy, xq) == "ref":
        return _ref.int8_matmul(xq, wq, xs, ws)
    return _im.int8_matmul(xq, wq, xs, ws)


def int8_matmul(x, w, *, policy=None):
    """x: (M, K) float; w: (K, N) float -> (M, N) f32 through the int8
    path.  Quantizes both operands on every call: callers with static
    weights `prepare_int8_weights` once and use `int8_matmul_prepared`."""
    wq, ws = prepare_int8_weights(w)
    return int8_matmul_prepared(x, wq, ws, policy=policy)
