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
the mask value is -1e30, masked probabilities are 0, a row that sees no
key outputs 0, fully masked kv tiles are skipped, and the output is
acc / max(l, 1e-30) rounded once.

What bounds it on the H100: operations (4·D flops per unmasked (q, k)
pair and head, far above the card's bytes-to-flops balance), and beside
them one exp2 a pair on the CUDA cores, which at D = 64 costs about as
much as the products.  bf16, the LM's type, runs both products on the
tensor cores (`wgmma`; P rounded to bf16 from the score registers
before P·V, as in SDPA's flash backend: at most 2^-9 relative per
probability, the one departure from the fp32 reference), in one of two
designs (`design(D, dtype)`, the C library's own choice):

* "bf16 tma", at D = 64, 80 and 128 (every attention architecture of
  the port: h2o-danube-1.8b's D = 80, the others' 64 and 128):
  FlashAttention-3's shape.  One persistent block an SM walks q tiles of
  128 rows heaviest first; a producer warpgroup that gave its registers
  to the two consumer warpgroups (`setmaxnreg`) streams Q and each K/V
  tile with TMA into 128-byte-swizzled rings (at D = 80 with a tail of
  the last 16 columns in the 32-byte swizzle, through a second tensor
  map an operand); each consumer issues S(it) = Q·K(it)ᵀ and
  P(it-1)·V(it-1) together and runs the softmax of tile it while P·V
  still runs, and the two consumers take turns at issuing.  The tensor
  maps are encoded on the host each call; a call that cannot encode
  them raises, and nothing falls back to another design.
* "bf16 cp.async", at the widths no configuration uses (16-48, 72 and
  88-120): the earlier design, a producer warp copying with `cp.async`
  into an unswizzled layout.

fp32 ("fp32") keeps the CUDA-core kernel (fp32 FMAs, one block per
(b, h, 64-row q tile)): the tensor cores take fp32 only as TF32, which
the port's fp32 contract excludes.  See the source.

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
DESIGNS = ("fp32", "bf16 cp.async", "bf16 tma")   # by the C library's code
# launches by the design of the kernel launched, as the C library records
# it at the launch (`flash_attention_ran`)
launches_by_design = dict.fromkeys(DESIGNS, 0)

MAX_D = 128
_designs: dict = {}


def design(D: int, dtype) -> str:
    """The kernel design a CUDA launch at head width D and `dtype` runs
    (`flash_attention_design` of the C library, which its dispatch uses)."""
    key = (D, dtype == torch.bfloat16)
    if key not in _designs:
        _designs[key] = DESIGNS[_build.lib().flash_attention_design(*key)]
    return _designs[key]


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
    ran = _build.lib().flash_attention_ran()
    if ran >= 0:
        launches_by_design[DESIGNS[ran]] += 1
    return out
