"""Forward flash attention: causal and sliding-window masks, GQA.

Replaces the TPU kernel `flash_attention_pallas`
(src/repro/kernels/flash_attention.py), the TPU execution path of the
LM prefill's `layers.attention_chunked`.  CUDA source:
`csrc/flash_attention.cu`.

q (B, H, Sq, D); k, v (B, K, Skv, D) with K | H -> (B, H, Sq, D) in q's
dtype (bf16 or fp32).  Query head h reads kv head h // (H // K), so
grouped-query attention needs no expanded copy of k and v (K = H is the
reference's pre-expanded layout).  q positions are right-aligned to the
end of kv.  Scores, softmax statistics and the accumulator are fp32;
the mask value is -1e30 and fully masked kv tiles are skipped.

What bounds it on the H100: operations (4·D flops per unmasked (q, k)
pair and head, far above the card's bytes-to-flops balance).  bf16, the
LM's type, runs both products on the tensor cores: `wgmma` m64n128k16
for S = Q·Kᵀ from shared memory, and m64nDk16 for O += P·V with P
rounded to bf16 and packed from the S accumulators into registers (the
one departure from the fp32 reference, as in SDPA's flash backend:
at most 2^-9 relative per probability).  One block per (b, h, 128-row
q tile): two consumer warpgroups and a producer warp that streams K/V
tiles of 128 rows into a three-stage ring with `cp.async` and mbarriers,
in an unswizzled core-matrix layout (a D = 80 row of 160 bytes fills no
128-byte swizzle atom; the depth is zero-padded to a multiple of 16).
Only tiles on the causal diagonal, the window's lower edge or the end
of kv evaluate the mask.  fp32 keeps the CUDA-core kernel (fp32 FMAs,
one block per (b, h, 64-row q tile)): the tensor cores take fp32 only
as TF32, which the port's fp32 contract excludes.  See the source.

The kernel takes contiguous (B, H, S, D) operands; `ops.flash_attention`
makes them contiguous (the model's (B, S, H, D) activations are
transposed there, a copy of O(S·H·D) bytes against O(S²·H·D) flops).
D must be a multiple of 8 and at most 128: any other head width raises.

On a CPU tensor the wrapper runs the plain version (`ref.flash_attention`).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

launches = 0        # kernel launches made by this wrapper

MAX_D = 128


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window=None) -> torch.Tensor:
    """q: (B, H, Sq, D); k, v: (B, K, Skv, D), K | H; bf16 or fp32."""
    global launches
    if not q.is_cuda:
        return ref.flash_attention(q, k, v, causal=causal, window=window)
    _build.refuse_grad("flash_attention", q, k, v)
    dev, dt = q.device, q.dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"flash_attention: expected float32 or bfloat16, "
                         f"got {dt}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _build.require(t, name, dt, 4, dev)
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} is not 16-byte "
                             f"aligned")
    B, H, Sq, D = q.shape
    _, K, Skv, _ = k.shape
    if (k.shape[0] != B or k.shape[3] != D or v.shape != k.shape
            or K < 1 or H % K):
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} (need k, v "
                         f"(B, K, Skv, D) with K dividing H)")
    if D % 8 or D > MAX_D:
        raise ValueError(f"flash_attention: head width D={D} is not "
                         f"supported (multiples of 8 up to {MAX_D})")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window must be >= 1, got "
                         f"{window}")
    out = torch.empty_like(q)
    err = _build.lib().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H, K,
        Sq, Skv, D, int(causal), 0 if window is None else int(window),
        int(dt == torch.bfloat16), 1.0 / (D ** 0.5), _build.stream(dev))
    _build.check(err, "flash_attention")
    launches += 1
    return out
