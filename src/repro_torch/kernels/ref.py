"""Plain PyTorch versions of the port's Hopper kernels.

Port of the matching functions of `repro/kernels/ref.py`.  Each is the
semantic ground truth its CUDA kernel is held against on the card, and
what the wrappers run for tensors that lie on the CPU.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30                      # matches core/hypothesis.py
MASK = -1e30                         # attention mask value
# dead candidates key under an out-of-range value: > any 31-bit prefix
# hash.  Torch's uint32 supports few ops, so keys are int64.
HASH_SENTINEL = 0xFFFFFFFF


def int8_matmul(xq, wq, xs, ws):
    """xq: (M, K) i8, wq: (K, N) i8, xs: (M,) f32, ws: (N,) f32 -> (M, N) f32.

    int8 x int8 products summed exactly in int32, then the per-row and
    per-column scales: `(acc.float() * xs) * ws`, in that order.  CUDA
    has no integer matmul, and an fp32 product is not exact once |acc|
    passes 2^24 (it reaches 127^2 * K), so the card takes an fp64
    product, exact for any |acc| < 2^53, and casts it back."""
    if xq.is_cuda:
        acc = (xq.double() @ wq.double()).to(torch.int32)
    else:
        acc = xq.int() @ wq.int()
    return acc.float() * xs[:, None] * ws[None, :]


def quantize_rows(x):
    """Symmetric per-row int8: x (M, K) -> (q i8, scale f32 (M,)).

    `torch.round` rounds half to even like `jnp.round`, and both
    divisions are true divisions (not products with a reciprocal), so q
    and the scales equal the reference's bit for bit on every device.
    The divisor 127 is a tensor: on the card torch divides by a Python
    scalar as a product with its reciprocal, which rounds some rows'
    scales one ulp away from the division."""
    xf = x.float()
    amax = xf.abs().amax(dim=1)
    s = amax / torch.full_like(amax, 127.0)
    q = torch.clamp(torch.round(xf / torch.clamp(s[:, None], min=1e-12)),
                    -127, 127).to(torch.int8)
    return q, s


def int8_matmul_prepared(x, wq, ws):
    """x: (M, K) float; wq (K, N) i8, ws (N,) f32 -> (M, N) f32: the
    per-row activation quantization, then `int8_matmul`."""
    xq, xs = quantize_rows(x)
    return int8_matmul(xq, wq, xs, ws)


def layernorm(x, scale, bias, eps=1e-5):
    """x: (T, D) any float dtype; fp32 statistics (population variance),
    fp64 for fp64 rows (so that autograd's float64 gradcheck sees the
    function at full precision)."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps) * scale + bias).to(x.dtype)


def bias_residual_layernorm(y, scale, bias, *, add_bias=None, res=None,
                            eps=1e-5):
    """`layernorm((y + add_bias) + res)`, each addend optional, the adds in
    fp32 in that order (the TDS FC block's bias, then its residual)."""
    if add_bias is not None:
        y = y + add_bias
    if res is not None:
        y = y + res
    return layernorm(y, scale, bias, eps=eps)


def rmsnorm(x, scale, eps=1e-6):
    """x: (T, D) any float dtype; fp32 statistics, output in x's dtype:
    `(xf * rsqrt(mean(xf^2) + eps)) * scale`, cast last."""
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)


def flash_attention(q, k, v, *, causal=True, window=None, scale=None):
    """q: (B, H, Sq, D); k, v: (B, K, Skv, D) with K | H (K = H is the
    reference's pre-expanded GQA; query head h reads kv head h // (H/K)).
    fp32 scores and softmax, mask value -1e30, q positions right-aligned
    to the end of kv; output in q's dtype."""
    B, H, Sq, D = q.shape
    Skv = k.shape[2]
    if k.shape[1] != H:
        k = k.repeat_interleave(H // k.shape[1], dim=1)
        v = v.repeat_interleave(H // v.shape[1], dim=1)
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    # in place where it can be: at a 6144-token prefill one (B, H, Sq,
    # Skv) fp32 score tensor is 4.8 GB per batch row
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()).mul_(scale)
    qpos = torch.arange(Sq, device=q.device)[:, None] + (Skv - Sq)
    kpos = torch.arange(Skv, device=q.device)[None, :]
    m = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        m &= kpos <= qpos
    if window is not None:
        m &= (qpos - kpos) < window
    p = torch.softmax(s.masked_fill_(~m, MASK), dim=-1)
    del s
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def logmel(power, fb, dct):
    """power: (T, F) f32, fb: (F, M), dct: (M, C) -> (T, C) MFCC tail."""
    mel = power @ fb
    return torch.log(torch.clamp_min(mel, 1e-10)) @ dct


def power_spectrum(signal, cfg, win):
    """signal: (..., S) f32 -> (..., n_frames, n_fft//2+1) f32, the MFCC's
    front end: pre-emphasis (restarting at each row's first sample),
    framing, the Hamming window `win`, |rfft|^2.  `cfg`: a FeatureConfig;
    at least one whole frame in S."""
    n = 1 + (signal.shape[-1] - cfg.frame_len) // cfg.frame_shift
    dev = signal.device
    sig = torch.cat(
        [signal[..., :1], signal[..., 1:] - cfg.preemphasis * signal[..., :-1]],
        dim=-1)
    idx = (torch.arange(n, device=dev)[:, None] * cfg.frame_shift
           + torch.arange(cfg.frame_len, device=dev)[None, :])
    frames = sig[..., idx] * win                      # (..., n, frame_len)
    spec = torch.fft.rfft(frames, n=cfg.n_fft, dim=-1)
    return spec.abs().square().to(torch.float32)


def mfcc(signal, cfg, tables):
    """signal: (..., S) f32 -> (..., n_frames, n_mfcc) f32, the whole
    MFCC: `power_spectrum`, then `logmel` on the power rows.  `tables`:
    `features._tables` (window, fb, dct)."""
    power = power_spectrum(signal, cfg, tables.win)
    rows = power.reshape(-1, power.shape[-1])
    out = logmel(rows, tables.fb, tables.dct)
    return out.reshape(power.shape[:-1] + (out.shape[-1],))


def beam_prune(scores, beam, mask_value=MASK):
    """scores: (N,) f32 -> scores with entries < max - beam set to
    `mask_value`.  The threshold is `best - beam` in fp32 (a Python
    float does not promote the tensor, as the reference's weak-typed
    float does not); `amax` propagates NaN, and a NaN threshold masks
    every entry."""
    best = scores.amax()
    return torch.where(scores >= best - beam, scores, mask_value)


# ---------------------------------------------------------------------------
# fused hypothesis unit: hash-merge + beam threshold + top-k
# ---------------------------------------------------------------------------
def _seg_lse(v, ids, num_segments):
    """Per-segment logsumexp of flat `v`, broadcast back per position:
    out[j] = logsumexp(v over j's whole segment).  An all-dead channel
    stays exactly NEG_INF.  On the CPU the segment sum accumulates in
    index order; on the card `scatter_add` is unordered (the CUDA kernel
    sums each segment in a fixed order instead)."""
    m = torch.full((num_segments,), float("-inf"), dtype=v.dtype,
                   device=v.device)
    m = m.scatter_reduce(0, ids, v, "amax", include_self=False)
    s = torch.zeros((num_segments,), dtype=v.dtype, device=v.device)
    s = s.scatter_add(0, ids, torch.exp(v - m[ids]))
    out = (m + torch.log(s))[ids]
    return torch.where(out > NEG_INF / 2, out, torch.full_like(out, NEG_INF))


def hypothesis_unit(hashes, pb, pnb, *, k: int, beam: float):
    """Batched fused hypothesis unit, sort-free.

    hashes: (B, N) int 31-bit prefix hashes; pb/pnb: (B, N) f32.  Returns
    a dict of (B, k) tensors: `idx` (int32 index of the selected
    candidate in the ORIGINAL row — the first occurrence of its hash; 0
    for pruned slots), merged `pb`/`pnb` (NEG_INF where pruned) and bool
    `valid`.  Top-k breaks ties to the lowest original index, as
    `lax.top_k` does: a stable descending sort, not `torch.topk`, whose
    tie order is unspecified."""
    B, n = hashes.shape
    dev = hashes.device
    valid_in = torch.logaddexp(pb, pnb) > NEG_INF / 2
    key = torch.where(valid_in, hashes.long(),
                      torch.full_like(hashes, HASH_SENTINEL, dtype=torch.long))
    key_sorted, _ = torch.sort(key, dim=-1)
    ids = torch.searchsorted(key_sorted, key, side="left")
    gids = (ids + torch.arange(B, device=dev)[:, None] * n).reshape(-1)
    iota = torch.arange(n, device=dev).expand(B, n)

    pb_m = _seg_lse(pb.reshape(-1), gids, B * n).reshape(B, n)
    pnb_m = _seg_lse(pnb.reshape(-1), gids, B * n).reshape(B, n)
    first = torch.full((B * n,), n, dtype=torch.long, device=dev)
    first = first.scatter_reduce(0, gids, iota.reshape(-1), "amin",
                                 include_self=False)
    rep = (iota == first[gids].reshape(B, n)) & (key != HASH_SENTINEL)
    tot = torch.where(rep, torch.logaddexp(pb_m, pnb_m),
                      torch.full_like(pb_m, NEG_INF))
    best = tot.max(dim=-1, keepdim=True).values
    top, pos = torch.sort(tot, dim=-1, descending=True, stable=True)
    top, pos = top[:, :k], pos[:, :k]
    valid = (top > NEG_INF / 2) & (top >= best - beam)
    neg = torch.full_like(top, NEG_INF)
    idx = torch.where(valid, pos, torch.zeros_like(pos)).to(torch.int32)
    opb = torch.where(valid, torch.gather(pb_m, 1, pos), neg)
    opnb = torch.where(valid, torch.gather(pnb_m, 1, pos), neg)
    return {"idx": idx, "pb": opb, "pnb": opnb, "valid": valid}


def merge_select_sorted(key_s, pb_s, pnb_s, *, k: int, beam: float):
    """One hypothesis-unit row over a candidate set pre-sorted by key.

    key_s: (N,) int keys in ascending order — the prefix hash for live
    candidates, HASH_SENTINEL for dead ones (they sort to the tail and
    never merge with a live hash).  pb_s / pnb_s: (N,) f32 CTC channels
    in the same order.  Returns (pos, pb, pnb, valid), each (k,): `pos`
    (int32) indexes the sorted row, pb/pnb are the merged channels of
    the selected segment heads (NEG_INF where pruned), `valid` (int32
    0/1) applies the beam threshold.  Top-k is one stable descending
    sort: ties go to the lowest index, as both of the reference's
    `iterative_topk` settings give."""
    n = key_s.shape[0]
    head = torch.ones((n,), dtype=torch.bool, device=key_s.device)
    head[1:] = key_s[1:] != key_s[:-1]                   # segment starts
    ids = torch.cumsum(head, 0) - 1                      # segment ids
    live = key_s != HASH_SENTINEL

    pb_m = _seg_lse(pb_s, ids, n)
    pnb_m = _seg_lse(pnb_s, ids, n)

    rep = head & live                       # one representative per live hash
    tot = torch.where(rep, torch.logaddexp(pb_m, pnb_m),
                      torch.full_like(pb_m, NEG_INF))
    best = tot.max()
    top, pos = torch.sort(tot, descending=True, stable=True)
    top, pos = top[:k], pos[:k]
    valid = (top > NEG_INF / 2) & (top >= best - beam)
    neg = torch.full_like(top, NEG_INF)
    return (pos.to(torch.int32), torch.where(valid, pb_m[pos], neg),
            torch.where(valid, pnb_m[pos], neg), valid.to(torch.int32))


def tds_conv(x, w, b, stride=1):
    """Causal strided time conv, unfused.  x: (T_pad, W, Cin) already
    left-padded by k-1; w: (k, Cin, Cout); b: (Cout,).  Returns
    (T_in // stride, W, Cout) with T_in = T_pad - (k - 1): the window
    gather and one einsum, the reference's semantic spec of the conv."""
    k = w.shape[0]
    t_out = (x.shape[0] - (k - 1)) // stride
    off = (torch.arange(t_out, device=x.device)[:, None] * stride
           + torch.arange(k, device=x.device)[None, :])
    win = x[off]                                    # (t_out, k, W, Cin)
    return torch.einsum("tkwc,kcd->twd", win, w) + b


def tds_conv_fused(x, w, b, *, stride=1, relu=False, res=None):
    """Slot-batched causal conv with the conv epilogue fused in.

    x: (B, k-1+T, W, Cin); w: (k, Cin, Cout); b: (Cout,); optional
    res: (B, T//stride, W, Cout) residual added AFTER the ReLU (the TDS
    block order).  Returns (B, T//stride, W, Cout): a k-tap loop of
    (B*t_out*W, Cin) x (Cin, Cout) matmuls, in fp32 (fp64 for fp64
    inputs)."""
    B, Tp, W, Cin = x.shape
    k, _, Cout = w.shape
    t_out = (Tp - (k - 1)) // stride
    dt = torch.promote_types(x.dtype, torch.float32)
    acc = torch.zeros((B * t_out * W, Cout), dtype=dt, device=x.device)
    for j in range(k):
        # tap j of output t reads x[:, stride*t + j]
        xj = x[:, j:j + stride * (t_out - 1) + 1:stride]
        acc = acc + xj.reshape(B * t_out * W, Cin).to(dt) @ w[j].to(dt)
    y = acc.reshape(B, t_out, W, Cout) + b
    if relu:
        y = torch.clamp_min(y, 0.0)
    if res is not None:
        y = y + res
    return y


def tds_conv_ln(x, w, b, ln_scale, ln_bias, *, stride=1, relu=False,
                res=None, eps=1e-5):
    """`tds_conv_fused`, then `layernorm` over each (b, t) row of
    W*Cout values: the TDS conv with the LayerNorm that follows it.
    Returns (B, T//stride, W, Cout)."""
    y = tds_conv_fused(x, w, b, stride=stride, relu=relu, res=res)
    B, t_out = y.shape[:2]
    return layernorm(y.reshape(B * t_out, -1), ln_scale, ln_bias,
                     eps=eps).reshape(y.shape)
