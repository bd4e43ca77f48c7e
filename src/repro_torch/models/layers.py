"""Core NN layers of the LM stack: norms, RoPE, GQA attention, gated MLP.

Port of `repro/models/layers.py` for one device.  Attention has two
paths, as in the reference:

  * `attention_chunked` — prefill: runs through `ops.flash_attention`,
    the hand-written Hopper kernel that is the TPU execution path of the
    reference's function (plain PyTorch on the CPU).
  * `attention_decode` — one query per row against a (ring-buffer) KV
    cache with absolute per-slot positions; plain torch, as the
    reference computes it outside any kernel.

Every rmsnorm goes through `ops.rmsnorm` (the norm kernel).  All softmax
math is fp32 whatever the activation dtype.  Parameters are plain dicts
of tensors with the reference's tree layout, so `params_from_numpy`
carries the reference's own parameters across.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops

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
    dtype.  rmsnorm goes through the norm kernel over (rows, D);
    layernorm stays plain (no text config of the dense family uses it)."""
    if kind == "rmsnorm":
        rows = x.reshape(-1, x.shape[-1])
        return ops.rmsnorm(rows, p["scale"].float(), eps=eps,
                           policy=policy).reshape(x.shape)
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps) * p["scale"].float()
    if "bias" in p:
        y = y + p["bias"].float()
    return y.to(x.dtype)


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


def linear(p: dict, x: torch.Tensor) -> torch.Tensor:
    """x (..., d_in) @ w (d_in, d_out) (+ b).  The int8 serving weights
    (`wq`/`wscale`) come with the int8-LM slice."""
    if "wq" in p:
        raise NotImplementedError(
            "int8 LM serving weights are not ported yet (ROADMAP Queue 1, "
            "item 10: quantize_params_for_serving)")
    y = torch.matmul(x, p["w"])
    if "b" in p:
        y = y + p["b"]
    return y


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


def rope_width(d: int, mode: str) -> int:
    """The width of the head-dim slice that `mode` rotates."""
    return d // 2 if mode == "rope2d" else d


def apply_rope(x: torch.Tensor, positions: torch.Tensor, mode: str,
               theta: float, tables=None) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) int.  `tables`: the
    `rope_tables(positions, rope_width(D, mode), theta)` of these
    positions, if the caller computed them already (same values)."""
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
        raise NotImplementedError(
            "M-RoPE is not ported yet (ROADMAP Queue 1, item 10: the VLM "
            "backbone)")
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


def attention_chunked(q, k, v, *, causal=True, window: Optional[int] = None,
                      policy=None) -> torch.Tensor:
    """Prefill attention through the flash-attention kernel.

    q: (B, S, H, D); k, v: (B, S, K, D) with K | H (GQA).  Returns
    (B, S, H, D).  The reference takes absolute positions qpos/kpos; on
    the prefill path both are arange(S) for every row, so `kpos >= 0`
    always holds and its causal/window mask is exactly the kernel's with
    q_offset = 0 (right-padding of a bucketed prefill cannot leak into
    real positions under the causal mask).  The reference's chunking
    (chunk_q/chunk_kv) is the kernel's tiling here."""
    out = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=causal,
                              window=window, policy=policy)
    return out.transpose(1, 2)


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
