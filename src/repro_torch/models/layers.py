"""Core NN layers of the LM stack: norms, RoPE (standard / 2d / M-RoPE),
GQA attention, gated MLP, int8 serving weights.

Attention has two paths, as in the reference:

  * `attention_chunked` — prefill: runs through `ops.flash_attention`,
    the hand-written Hopper kernel that is the TPU execution path of the
    reference's function (plain PyTorch on the CPU).  Positions given
    by the batch (`qpos`/`kpos`) take the reference's position-masked
    attention in plain torch instead (see there).
  * `attention_decode` — one query per row against a (ring-buffer) KV
    cache with absolute per-slot positions; plain torch, as the
    reference computes it outside any kernel.  On a mesh,
    `attention_decode_sharded` is its flash-decoding over a
    sequence-sharded cache.

Port of `repro/models/layers.py`.  The tensor-parallel helpers
(`linear_col`, `linear_row`, `apply_mlp_sharded`) compute on a rank's
blocks of a weight split over the 'model' axis and call that axis's
differentiable collectives (`launch/mesh.py`: Megatron's f and g, so
that they train as they serve).

Every norm goes through the norm kernel: rmsnorm through `ops.rmsnorm`,
layernorm through `ops.layernorm`.  All softmax math is fp32 whatever
the activation dtype.  Parameters are plain dicts of tensors with the
reference's tree layout, so `params_from_numpy` carries the reference's
own parameters across.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.launch import mesh as meshlib

MASK_VALUE = -1e30


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------
def init_norm(d: int, kind: str, dtype=torch.float32, device="cpu") -> dict:
    p = {"scale": torch.ones((d,), dtype=dtype, device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=dtype, device=device)
    return p


def apply_norm(p: dict, x: torch.Tensor, kind: str, eps: float = 1e-6,
               policy=None) -> torch.Tensor:
    """Norm over the last axis with fp32 statistics, output in x's
    dtype, through the norm kernel over (rows, D): rmsnorm
    `(x·rsqrt(mean x²+eps))·scale`, layernorm
    `((x-mu)·rsqrt(var+eps))·scale + bias`."""
    rows = x.reshape(-1, x.shape[-1])
    scale = p["scale"].float()
    if kind == "rmsnorm":
        y = ops.rmsnorm(rows, scale, eps=eps, policy=policy)
    else:
        bias = (p["bias"].float() if "bias" in p
                else torch.zeros_like(scale))
        y = ops.layernorm(rows, scale, bias, eps=eps, policy=policy)
    return y.reshape(x.shape)


# ---------------------------------------------------------------------------
# linear
# ---------------------------------------------------------------------------
def randn(generator, shape) -> torch.Tensor:
    """fp32 standard normal draws from `generator`, on its own device.
    With no generator, a meta tensor of that shape: the shapes and
    dtypes of an init, with no storage and no draw (`LM.param_shapes`)."""
    if generator is None:
        return torch.empty(shape, device="meta")
    return torch.randn(shape, generator=generator, device=generator.device)


def init_linear(generator: torch.Generator, d_in: int, d_out: int,
                bias: bool = False, dtype=torch.bfloat16,
                device="cpu") -> dict:
    """Normal weights scaled by 1/sqrt(d_in), drawn in fp32 from
    `generator` on its own device, then cast and placed on `device`."""
    std = 1.0 / math.sqrt(d_in)
    w = randn(generator, (d_in, d_out))
    p = {"w": (w * std).to(device=device, dtype=dtype)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=device)
    return p


def weight(p: dict, dtype) -> torch.Tensor:
    """A linear's weight (d_in, d_out); int8 serving weights (`wq`
    (d_in, d_out) int8, `wscale` (d_out,)) dequantized in `dtype`,
    `wq · wscale`, as the reference does at use: no int8 GEMM."""
    if "wq" in p:
        return p["wq"].to(dtype) * p["wscale"].to(dtype)[None, :]
    return p["w"]


def linear(p: dict, x: torch.Tensor) -> torch.Tensor:
    """x (..., d_in) @ w (d_in, d_out) (+ b), int8 serving weights
    dequantized at use in x's dtype (`weight`)."""
    y = torch.matmul(x, weight(p, x.dtype))
    if "b" in p:
        y = y + p["b"]
    return y


def _quantize(w: torch.Tensor, axis: int):
    """Symmetric int8 of fp32 `w` with one scale per slice over `axis`:
    (q int8, scale = max|w| / 127 f32).  Both divisions are true
    divisions by tensors (on the card torch turns a division by a Python
    float into a product with its reciprocal, an ulp off the
    reference's), and `torch.round` rounds half to even as `jnp.round`."""
    amax = w.abs().amax(dim=axis)
    scale = amax / torch.full_like(amax, 127.0)
    q = torch.clamp(torch.round(w / torch.clamp(scale.unsqueeze(axis),
                                                min=1e-12)),
                    -127, 127).to(torch.int8)
    return q, scale


def quantize_linear(p: dict) -> dict:
    """{'w': (din, dout), 'b'?} -> {'wq': int8, 'wscale': (dout,) f32, 'b'?}:
    symmetric per-output-channel int8, the serving-weight format."""
    q, scale = _quantize(p["w"].float(), 0)
    out = {"wq": q, "wscale": scale}
    if "b" in p:
        out["b"] = p["b"]
    return out


# embeddings (a lookup), the router (fp32 by design), the depthwise conv
# and the SSD dt/B/C projections (exp(cumsum(dt·A)) amplifies their
# quantization error) stay as they are, with everything under them
QUANT_SKIP = ("embed", "router", "conv_x", "w_dt", "w_B", "w_C")


def quantize_params_for_serving(params: dict) -> dict:
    """Every 2-D dense linear `w` of an LM parameter tree to int8
    (`quantize_linear`), and every stacked 3-D one (R, din, dout) with a
    scale per layer and output channel (R, dout); embeddings, norms, MoE
    expert tensors and SSM parameters stay as they are.  The given tree
    is not changed."""
    def rec(tree, path=()):
        if not isinstance(tree, dict):
            return tree
        if any(s in path for s in QUANT_SKIP):
            return {k: rec(v, path + (k,)) for k, v in tree.items()}
        w = tree.get("w")
        if isinstance(w, torch.Tensor) and w.dim() == 2:
            return quantize_linear(tree)
        if isinstance(w, torch.Tensor) and w.dim() == 3:
            q, scale = _quantize(w.float(), 1)
            out = {"wq": q, "wscale": scale}
            if "b" in tree:
                out["b"] = tree["b"]
            return out
        return {k: rec(v, path + (k,)) for k, v in tree.items()}
    return rec(params)


def activation(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "silu":
        return F.silu(x)
    if kind == "gelu":
        # jax.nn.gelu defaults to the tanh approximation
        return F.gelu(x, approximate="tanh")
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# RoPE family
# ---------------------------------------------------------------------------
def rope_tables(pos: torch.Tensor, d: int, theta: float):
    """(cos, sin), each (..., S, 1, d // 2) fp32, of the rotation of a
    d-wide slice at positions pos (..., S).  Every layer's q and k share
    them, so a model computes them once per forward."""
    half = d // 2
    freqs = torch.exp(-torch.arange(0, half, dtype=torch.float32,
                                    device=pos.device)
                      * (math.log(theta) / half))              # (half,)
    ang = pos.float()[..., None, None] * freqs                 # (..., S, 1, half)
    return torch.cos(ang), torch.sin(ang)


def _rope_rotate(x: torch.Tensor, pos: torch.Tensor, theta: float,
                 tables=None) -> torch.Tensor:
    """Rotate all of x's last dim. x: (..., S, H, D); pos: (..., S);
    `tables`: `rope_tables(pos, D, theta)` if already computed."""
    half = x.shape[-1] // 2
    cos, sin = (rope_tables(pos, x.shape[-1], theta) if tables is None
                else tables)
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin],
                     dim=-1).to(x.dtype)


def mrope_sections(d: int) -> tuple:
    """M-RoPE's three even head-dim sections (temporal, h, w): s0 = s1 =
    (d // 3) & ~1, s2 the rest (42 / 42 / 44 at d = 128).  The
    reference's layout, not Hugging Face's `mrope_section`."""
    s0 = (d // 3) & ~1
    return s0, s0, d - 2 * s0


def rope_tables_for(positions: torch.Tensor, d: int, mode: str,
                    theta: float):
    """The tables `apply_rope(x, positions, mode, theta, tables=)` takes
    for a head dim of d: one (cos, sin) pair (`rope`, `rope2d`: of the
    rotated width), three for `mrope` (section i rotated at
    positions[..., i]), None for `none`."""
    if mode == "none":
        return None
    if mode == "mrope":
        return tuple(rope_tables(positions[..., i], sec, theta)
                     for i, sec in enumerate(mrope_sections(d)))
    return rope_tables(positions, d // 2 if mode == "rope2d" else d, theta)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, mode: str,
               theta: float, tables=None) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) int, or (B, S, 3) for mrope.
    `tables`: `rope_tables_for(positions, D, mode, theta)` if the caller
    computed them already (the same values)."""
    if mode == "none":
        return x
    if mode == "rope":
        return _rope_rotate(x, positions, theta, tables)
    if mode == "rope2d":
        # chatglm: rotary on the first half of the head dim only
        d = x.shape[-1]
        rot = _rope_rotate(x[..., : d // 2], positions, theta, tables)
        return torch.cat([rot, x[..., d // 2:]], dim=-1)
    if mode == "mrope":
        # positions (B, S, 3): (temporal, h, w), one per head-dim section
        parts, off = [], 0
        for i, sec in enumerate(mrope_sections(x.shape[-1])):
            parts.append(_rope_rotate(
                x[..., off:off + sec], positions[..., i], theta,
                None if tables is None else tables[i]))
            off += sec
        return torch.cat(parts, dim=-1)
    raise ValueError(mode)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------
def _mask(qpos, kpos, causal: bool, window: Optional[int]):
    """qpos: (B, Sq), kpos: (B, Skv) -> bool (B, Sq, Skv). kpos<0 = invalid."""
    m = kpos[:, None, :] >= 0
    if causal:
        m = m & (kpos[:, None, :] <= qpos[:, :, None])
    if window is not None:
        m = m & ((qpos[:, :, None] - kpos[:, None, :]) < window)
    return m


def attention_chunked(q, k, v, *, qpos=None, kpos=None, causal=True,
                      window: Optional[int] = None,
                      policy=None) -> torch.Tensor:
    """Prefill attention.  q: (B, S, H, D); k, v: (B, Skv, K, D) with
    K | H (GQA).  Returns (B, S, H, D).

    Without `qpos`/`kpos` it runs the flash-attention kernel: the
    reference masks on absolute positions, and on the prefill path both
    are arange(S) in every row unless the batch gives positions, so
    `kpos >= 0` always holds and its causal/window mask is exactly the
    kernel's with q_offset = 0 (right-padding of a bucketed prefill
    cannot leak into real positions under the causal mask).  The
    reference's chunking (chunk_q/chunk_kv) is the kernel's tiling here.

    With `qpos` (B, Sq) and `kpos` (B, Skv), the token indices of
    positions the batch gave (an M-RoPE image grid, say), the mask is the
    reference's on those positions, which the kernel's index mask cannot
    express; that is the plain `attention_masked`, as the reference
    computes this function with XLA outside any Pallas kernel.  The
    model decides by the presence of the batch's "positions" key, never
    by reading positions back to the host."""
    if qpos is not None:
        return attention_masked(q, k, v, qpos, kpos, causal=causal,
                                window=window)
    out = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=causal,
                              window=window, policy=policy)
    return out.transpose(1, 2)


def attention_masked(q, k, v, qpos, kpos, *, causal=True,
                     window: Optional[int] = None,
                     chunk_q: int = 512) -> torch.Tensor:
    """The reference's `attention_chunked` on absolute positions, plain
    torch: q (B, Sq, H, D), k/v (B, Skv, K, D), qpos (B, Sq), kpos (B,
    Skv) (< 0 = invalid).  fp32 scores and softmax over each chunk of
    `chunk_q` queries against every key; probabilities cast to v's dtype
    before the P·V product, as the reference's; a row that sees no key
    gives 0."""
    B, Sq, H, D = q.shape
    K = k.shape[2]
    G = H // K
    scale = 1.0 / math.sqrt(D)
    kf, vf = k.float(), v.float()
    outs = []
    for c0 in range(0, Sq, chunk_q):
        qc = q[:, c0:c0 + chunk_q].float()
        cq = qc.shape[1]
        s = torch.einsum("bqkgd,bskd->bkgqs", qc.reshape(B, cq, K, G, D),
                         kf) * scale
        msk = _mask(qpos[:, c0:c0 + chunk_q], kpos, causal,
                    window)[:, None, None]                 # (B,1,1,cq,Skv)
        s = torch.where(msk, s, torch.full_like(s, MASK_VALUE))
        p = torch.exp(s - s.amax(-1, keepdim=True))
        p = torch.where(msk, p, torch.zeros_like(p))
        acc = torch.einsum("bkgqs,bskd->bkgqd", p.to(v.dtype).float(), vf)
        out = acc / torch.clamp(p.sum(-1), min=1e-30)[..., None]
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(B, cq, H, D))
    return torch.cat(outs, dim=1).to(q.dtype)


def attention_decode(q, k_cache, v_cache, qpos, kpos, *,
                     window: Optional[int] = None,
                     k_new=None, v_new=None) -> torch.Tensor:
    """Single-token attention against a cache (plain torch).

    q: (B, 1, H, D); caches: (B, Sc, K, D); qpos: (B,) int;
    kpos: (Sc,) absolute positions of cache slots (-1 = empty), or
    (B, Sc) when each batch row tracks its own positions (per-slot
    serving cache with staggered admission).

    If k_new/v_new (B, 1, K, D) are given, the current token is attended
    as a separate logit column (two-part softmax), so the caller writes
    the new KV into the cache once, after the layer loop.  Scores are
    fp32 products of the cache's dtype (as the reference's
    `preferred_element_type=f32` dots)."""
    B, _, H, D = q.shape
    Sc, K = k_cache.shape[1], k_cache.shape[2]
    G = H // K
    scale = 1.0 / math.sqrt(D)
    qg = q.reshape(B, K, G, D)
    s = torch.einsum("bkgd,bskd->bkgs", qg.float(), k_cache.float()) * scale
    kp = kpos if kpos.dim() == 2 else kpos[None, :]          # (B|1, Sc)
    valid = (kp >= 0) & (kp <= qpos[:, None])
    if window is not None:
        valid = valid & ((qpos[:, None] - kp) < window)
    s = torch.where(valid[:, None, None, :], s,
                    torch.full_like(s, MASK_VALUE))
    if k_new is not None:
        s_self = torch.einsum("bkgd,bkd->bkg", qg.float(),
                              k_new[:, 0].float()) * scale
        m = torch.maximum(s.amax(-1), s_self)
        p = torch.exp(s - m[..., None])
        p_self = torch.exp(s_self - m)
        denom = p.sum(-1) + p_self
        out = (torch.einsum("bkgs,bskd->bkgd",
                            p.to(v_cache.dtype).float(), v_cache.float())
               + p_self[..., None] * v_new[:, 0].float()[:, :, None])
        out = out / denom[..., None]
    else:
        p = torch.softmax(s, dim=-1)
        out = torch.einsum("bkgs,bskd->bkgd", p.to(v_cache.dtype).float(),
                           v_cache.float())
    return out.reshape(B, 1, H, D).to(q.dtype)


def attention_decode_sharded(q, k_cache, v_cache, qpos, kpos, *,
                             window: Optional[int] = None, k_new=None,
                             v_new=None, sharder=None,
                             axis=None) -> torch.Tensor:
    """Flash-decoding over a sequence-sharded cache, as the reference's
    `attention_decode_sharded`: this rank's `k_cache`/`v_cache` (B, Sc_l,
    K, D) and `kpos` (Sc_l,) are its block of the sequence over `axis`
    (default: the sharder's 'model' axis).  Each rank computes a masked
    partial softmax over its slice, then the ranks combine: the MAX of
    the row maxima m, then the SUM of l·w and acc·w with w = exp(m -
    max m) (one all-reduce of both); the current token's (k_new, v_new)
    joins after as its own logit column, and the output is acc / max(l,
    1e-30).  O(B·H·D) on the wire instead of gathering the cache.  q:
    (B, 1, H, D); qpos: (B,).  Scores and softmax in fp32."""
    ax = sharder.model_axis if axis is None else axis
    B, _, H, D = q.shape
    K = k_cache.shape[2]
    G = H // K
    scale = 1.0 / math.sqrt(D)
    qg = q.reshape(B, K, G, D).float()
    s = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.float()) * scale
    valid = (kpos[None, :] >= 0) & (kpos[None, :] <= qpos[:, None])
    if window is not None:
        valid = valid & ((qpos[:, None] - kpos[None, :]) < window)
    vmask = valid[:, None, None, :]
    s = torch.where(vmask, s, torch.full_like(s, MASK_VALUE))
    m_loc = s.amax(-1)                                       # (B, K, G)
    p = torch.exp(s - m_loc[..., None])
    p = torch.where(vmask, p, torch.zeros_like(p))
    l_loc = p.sum(-1)
    acc_loc = torch.einsum("bkgs,bskd->bkgd", p.to(v_cache.dtype).float(),
                           v_cache.float())
    m = m_loc.clone()
    ax.all_reduce_max(m)
    w = torch.exp(m_loc - m)
    both = torch.cat([(l_loc * w)[..., None], acc_loc * w[..., None]], -1)
    ax.all_reduce(both)
    l, acc = both[..., 0], both[..., 1:]
    if k_new is not None:
        s_self = torch.einsum("bkgd,bkd->bkg", qg,
                              k_new[:, 0].float()) * scale
        m2 = torch.maximum(m, s_self)
        w = torch.exp(m - m2)
        p_self = torch.exp(s_self - m2)
        l = l * w + p_self
        acc = (acc * w[..., None]
               + p_self[..., None] * v_new[:, 0].float()[:, :, None])
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(B, 1, H, D).to(q.dtype)


# ---------------------------------------------------------------------------
# tensor-parallel linears (a rank's blocks on the 'model' axis)
# ---------------------------------------------------------------------------
def out_features(p: dict) -> int:
    """Output columns of a linear's weight as this rank holds it."""
    return (p["wq"] if "wq" in p else p["w"]).shape[-1]


def in_features(p: dict) -> int:
    """Contraction rows of a linear's weight as this rank holds it."""
    return (p["wq"] if "wq" in p else p["w"]).shape[-2]


def feature_block(y: torch.Tensor, axis) -> torch.Tensor:
    """This rank's block of y's last dimension over `axis` (y replicated;
    the backward all-gathers the blocks' gradients)."""
    return meshlib.split_to(y, axis, y.dim() - 1)


def linear_col(p: dict, x: torch.Tensor, n_out: int, axis) -> torch.Tensor:
    """Column-parallel linear, its whole output on every rank: x (...,
    d_in) whole; a weight split on its output columns (fewer than
    `n_out` here) gives the rank's block, all-gathered over `axis` (in
    the backward, x's gradient is the ranks' partials summed)."""
    if out_features(p) < n_out:
        y = linear(p, meshlib.copy_to(x, axis))
        return meshlib.gather_from(y, axis, y.dim() - 1)
    return linear(p, x)


def linear_row(p: dict, x: torch.Tensor, axis) -> torch.Tensor:
    """Row-parallel linear: x (..., d_in / n) is the rank's block of the
    contraction, the weight its block of rows.  The rank's partial
    product is fp32, the fp32 partials are all-reduced over `axis` and
    rounded once to x's dtype, then the (whole) bias is added."""
    y = torch.matmul(x.float(), weight(p, x.dtype).float())
    y = meshlib.reduce_from(y, axis)
    y = y.to(x.dtype)
    if "b" in p:
        y = y + p["b"]
    return y


# ---------------------------------------------------------------------------
# gated MLP
# ---------------------------------------------------------------------------
def init_mlp(generator: torch.Generator, d: int, f: int,
             dtype=torch.bfloat16, device="cpu") -> dict:
    return {"w_gate": init_linear(generator, d, f, dtype=dtype, device=device),
            "w_up": init_linear(generator, d, f, dtype=dtype, device=device),
            "w_down": init_linear(generator, f, d, dtype=dtype,
                                  device=device)}


def apply_mlp(p: dict, x: torch.Tensor, act: str) -> torch.Tensor:
    return linear(p["w_down"],
                  activation(linear(p["w_gate"], x), act) * linear(p["w_up"], x))


def apply_mlp_sharded(p: dict, x: torch.Tensor, act: str, d_ff: int,
                      axis) -> torch.Tensor:
    """The gated MLP on a rank's blocks: w_gate/w_up column-parallel and
    w_down row-parallel over `axis` when d_ff is split, else whole."""
    if out_features(p["w_gate"]) == d_ff:
        return apply_mlp(p, x, act)
    x = meshlib.copy_to(x, axis)
    h = activation(linear(p["w_gate"], x), act) * linear(p["w_up"], x)
    return linear_row(p["w_down"], h, axis)
