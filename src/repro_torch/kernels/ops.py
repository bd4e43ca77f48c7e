"""Public kernel entry points, dispatched by `KernelPolicy`.

Port of `repro/kernels/ops.py`.  Each function resolves its policy
against the device of its input (see `kernels/policy.py`): ``ref`` runs
the plain PyTorch version in `kernels/ref.py` (CPU or card), ``kernel``
the CUDA kernel's wrapper (card only).  The wrappers never fall back: a
failed build or launch raises.

Each wrapper that launches a kernel is decorated with `cost.fused`: under
an op counter (`launch/op_cost.py`) one call of it is one fused op of
its kernel's formula, its plain ops not counted again.

The mesh helpers (`shard_local_cols`, `overlap_splits`,
`psum_overlap_matmul`, and `int8_matmul_prepared(axis=)`) serve the
sharded ASR step: `axis` is a `launch.mesh.MeshAxis`, this rank's view
of the 'model' axis, whose `all_reduce` is the reference's `psum`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import beam_prune as _bp
from repro_torch.kernels import cost as _cost
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


@_cost.fused("layernorm")
def layernorm(x, scale, bias, *, eps=1e-5, policy=None):
    if resolve(policy, x) == "ref":
        return _ref.layernorm(x, scale, bias, eps=eps)
    return _ln.layernorm(x.contiguous(), scale, bias, eps=eps)


@_cost.fused("layernorm")
def bias_residual_layernorm(y, scale, bias, *, add_bias=None, res=None,
                            eps=1e-5, policy=None):
    """LayerNorm of (y + add_bias) + res, the addends optional: the TDS
    FC block's bias and residual added in the LayerNorm's one launch.
    y, res: (R, D); add_bias, scale, bias: (D,)."""
    if resolve(policy, y) == "ref":
        return _ref.bias_residual_layernorm(y, scale, bias, add_bias=add_bias,
                                            res=res, eps=eps)
    return _ln.bias_residual_layernorm(
        y.contiguous(), scale, bias, add_bias=add_bias,
        res=None if res is None else res.contiguous(), eps=eps)


@_cost.fused("rmsnorm")
def rmsnorm(x, scale, *, eps=1e-6, policy=None):
    """x: (R, D) bf16/f32; scale: (D,) f32 -> (R, D) in x's dtype."""
    if resolve(policy, x) == "ref":
        return _ref.rmsnorm(x, scale, eps=eps)
    return _ln.rmsnorm(x.contiguous(), scale.float().contiguous(), eps=eps)


@_cost.fused("flash_attention")
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


@_cost.fused("logmel")
def logmel(power, fb, dct, policy=None):
    if resolve(policy, power) == "ref":
        return _ref.logmel(power, fb, dct)
    return _lm.logmel(power.contiguous(), fb, dct)


@_cost.fused("logmel")
def mfcc(signal, cfg, tables, policy=None):
    """signal: (..., S) f32 -> (..., n_frames, n_mfcc) f32, the whole MFCC
    (`cfg`: a FeatureConfig; `tables`: `features._tables`); one launch
    on the card."""
    if resolve(policy, signal) == "ref":
        return _ref.mfcc(signal, cfg, tables)
    return _lm.mfcc(signal.contiguous(), cfg, tables)


@_cost.fused("beam_prune")
def beam_prune(scores, beam, policy=None):
    """scores: (N,) f32 -> scores with entries < max - beam set to -1e30
    (the hypothesis unit's standalone threshold stage)."""
    if resolve(policy, scores) == "ref":
        return _ref.beam_prune(scores, beam)
    return _bp.beam_prune(scores.contiguous(), beam)


@_cost.fused("tds_conv")
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


@_cost.fused("tds_conv")
def tds_conv_ln(x, w, b, ln_scale, ln_bias, *, stride=1, relu=False,
                res=None, eps=1e-5, policy=None):
    """`tds_conv`, then LayerNorm over each output frame's W*Cout values
    (ln_scale, ln_bias: (W*Cout,)), in one launch on the card.
    x: (B, k-1+T, W, Cin) slot-batched (3-D = B=1)."""
    mode = resolve(policy, x)
    squeeze = x.dim() == 3
    if squeeze:
        x = x[None]
        res = None if res is None else res[None]
    if mode == "ref":
        out = _ref.tds_conv_ln(x, w, b, ln_scale, ln_bias, stride=stride,
                               relu=relu, res=res, eps=eps)
    else:
        out = _tc.tds_conv_ln(x.contiguous(), w, b, ln_scale, ln_bias,
                              None if res is None else res.contiguous(),
                              stride=stride, relu=relu, eps=eps)
    return out[0] if squeeze else out


@_cost.fused("hypothesis_unit")
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

    Plain torch on every device (`ref.quantize_rows`), as the reference
    computes it outside any kernel: q and the scales equal the
    reference's bit for bit.  The int8 product's fused kernel
    (`int8_matmul_prepared` on the card) computes the same bits."""
    return _ref.quantize_rows(x)


def prepare_int8_weights(w):
    """Quantize a static weight matrix once: w (K, N) float -> (wq (K, N)
    i8, ws (N,) f32 per-output-column scales), so that the decode hot
    path only quantizes activations.  wq is the transposed view of the
    (N, K) quantization, K-contiguous: the int8 kernel's weight layout."""
    wq_t, ws = quantize_rows(w.t())
    # elementwise ops keep w.t()'s strides: make the (N, K) rows dense
    return wq_t.contiguous().t(), ws


def shard_local_cols(x, kloc, axis):
    """Model-parallel contraction helper: the activation columns matching
    this rank's feature-axis weight shard, rows [i*kloc, (i+1)*kloc) of
    the full weight, where i is the rank's index along `axis`.  Shared by
    the fp32 (`tds.forward_batched`) and int8 (`int8_matmul_prepared`)
    paths, so that the slicing rule cannot diverge between them; callers
    detect a sharded weight by shape (w.shape[0] != x.shape[1]) and
    all-reduce the partial products.  Returns a view."""
    return x[:, axis.index * kloc:(axis.index + 1) * kloc]


def overlap_splits(n: int, n_chunks: int = 2):
    """[lo, hi) output-column chunk boundaries for the latency-hiding
    all-reduce split (`psum_overlap_matmul`); one full-width chunk when
    n < n_chunks."""
    n_chunks = max(1, min(int(n_chunks), int(n)))
    return [(i * n // n_chunks, (i + 1) * n // n_chunks)
            for i in range(n_chunks)]


def _overlapped(n, product, axis, n_chunks=2):
    """Chunk c's all-reduce runs (async) while chunk c+1's product is
    computed; `product(lo, hi)` gives a chunk's local partial."""
    parts, works = [], []
    for lo, hi in overlap_splits(n, n_chunks):
        part = product(lo, hi)
        works.append(axis.all_reduce(part, async_op=True))
        parts.append(part)
    for work in works:
        work.wait()
    return torch.cat(parts, dim=1)


def psum_overlap_matmul(xloc, wm, axis, n_chunks: int = 2):
    """Latency-hiding model-parallel contraction: xloc (M, K/n) local
    activation columns, wm (K/n, N) this rank's feature-axis weight
    shard -> the full (M, N) all-reduced product.

    The output columns are split into chunks, and chunk c's all-reduce
    is started (`async_op`) before chunk c+1's local product, so a
    backend with asynchronous collectives sums c under c+1's product.
    Each output element is still one local dot and one all-reduce, as in
    the synchronous `all_reduce(xloc @ wm)`, but the narrower products
    may be blocked differently, so the two agree numerically (~1e-6),
    not bitwise; the synchronous path stays the parity reference."""
    return _overlapped(wm.shape[1], lambda lo, hi: xloc @ wm[:, lo:hi],
                       axis, n_chunks)


def int8_matmul_prepared(x, wq, ws, *, policy=None, axis=None,
                         overlap=False):
    """x: (M, K) float; wq/ws from `prepare_int8_weights` -> (M, N) f32.

    The hot-path half of the int8 pipeline: per-row activation
    quantization, the int8 matmul and the fp32 rescale, one launch on the
    card (`int8_matmul.int8_matmul_fused`).

    `axis` (a `MeshAxis`, the sharded step's 'model' axis): where `wq`
    arrives as a feature-axis shard, (K/n_model, N), detected by shape
    against `x`, the activations are quantized on their full rows first
    (`quantize_rows`, so the per-row scales equal the unsharded path's),
    this rank's xq columns are sliced (made contiguous), the rescaled
    partial product `(acc·xs)·ws` is taken by the pre-quantized kernel
    (`int8_matmul.int8_matmul`; the fused one would take its scales from
    the local columns alone), and the partials are all-reduced over
    `axis`.  `overlap` splits the output columns as `psum_overlap_matmul`
    does; the column slice of the K-contiguous weight view stays
    K-contiguous, so no chunk copies its weight."""
    if axis is None or wq.shape[0] == x.shape[1]:
        return _int8_fused(x, wq, ws, policy=policy)
    xq, xs = quantize_rows(x)
    xloc = shard_local_cols(xq, wq.shape[0], axis).contiguous()

    def product(lo, hi):
        return _int8_product(xloc, wq[:, lo:hi], xs, ws[lo:hi],
                             policy=policy)
    if overlap:
        return _overlapped(wq.shape[1], product, axis)
    out = product(0, wq.shape[1])
    axis.all_reduce(out)
    return out


@_cost.fused("int8_matmul")
def _int8_fused(x, wq, ws, *, policy=None):
    """One launch: x's rows quantized, the int8 product, the rescale."""
    if resolve(policy, x) == "ref":
        return _ref.int8_matmul_prepared(x, wq, ws)
    return _im.int8_matmul_fused(x.float().contiguous(), wq, ws)


@_cost.fused("int8_matmul")
def _int8_product(x, wq, xs, ws, *, policy=None):
    """One launch on pre-quantized rows: `(acc·xs)·ws`."""
    if resolve(policy, x) == "ref":
        return _ref.int8_matmul(x, wq, xs, ws)
    return _im.int8_matmul(x, wq, xs, ws)


def int8_matmul(x, w, *, policy=None):
    """x: (M, K) float; w: (K, N) float -> (M, N) f32 through the int8
    path.  Quantizes both operands on every call: callers with static
    weights `prepare_int8_weights` once and use `int8_matmul_prepared`."""
    wq, ws = prepare_int8_weights(w)
    return int8_matmul_prepared(x, wq, ws, policy=policy)
