"""Mixture-of-Experts with capacity-based sorted dispatch, port of the
single-device path of `repro/models/moe.py`.

Tokens are gathered into an (E, C, D) expert buffer (O(T·D) data
movement, no one-hot dispatch einsum), the experts run as grouped
products over that buffer, and each token's top-K outputs are gathered
back and mixed by its renormalised router probabilities.  The router
runs in fp32; the load-balancing aux value is returned beside the
output.

Semantics kept from the reference, bit for bit where the reference is
deterministic:
  * top-K with ties going to the lowest expert index (as `lax.top_k`):
    a stable descending sort, not `torch.topk`;
  * candidates ranked per expert by a stable argsort of their expert
    ids (token order within an expert), and a candidate whose rank
    reaches the capacity C is dropped;
  * C depends on the token count T of the whole call (`capacity`), so
    which tokens are dropped depends on every token in the batch,
    bucket padding included.

The expert-parallel path (`apply_moe_ep`, `_local_dispatch_combine`:
shard_map and all-to-all over a 'model' mesh axis) is not ported: it
belongs to ROADMAP Queue 1, item 11 (multi-device).
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import MoESpec
from repro_torch.models import layers


def init_moe(generator: torch.Generator, d: int, spec: MoESpec,
             dtype=torch.bfloat16, device="cpu") -> dict:
    """Random parameters with the reference's tree, shapes and std, drawn
    in fp32 from `generator` on its own device, then cast."""
    E, F = spec.n_experts, spec.expert_d_ff
    std = 1.0 / math.sqrt(d)

    def normal(shape, scale, dt):
        w = layers.randn(generator, shape)
        return (w * scale).to(device=device, dtype=dt)

    p = {"router": {"w": normal((d, E), std, torch.float32)},
         "w_gate": normal((E, d, F), std, dtype),
         "w_up": normal((E, d, F), std, dtype),
         "w_down": normal((E, F, d), 1.0 / math.sqrt(F), dtype)}
    if spec.shared_d_ff:
        p["shared"] = layers.init_mlp(generator, d, spec.shared_d_ff, dtype,
                                      device)
    return p


def capacity(n_tokens: int, spec: MoESpec) -> int:
    """Slots per expert: a multiple of 256 once T >= 256, else >= 8."""
    c = int(n_tokens * spec.top_k * spec.capacity_factor / spec.n_experts)
    return max(256, -(-c // 256) * 256) if n_tokens >= 256 else max(8, c)


def route(logits: torch.Tensor, k: int):
    """Softmax router probabilities and their top-k: (probs, top_p, top_e).

    Ties go to the lowest expert index, as `jax.lax.top_k` breaks them
    (a stable descending sort); top_p is renormalised over the k."""
    probs = torch.softmax(logits.float(), dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[:, :k], top_e[:, :k]
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    return probs, top_p, top_e


def dispatch(flat_e: torch.Tensor, n_experts: int, cap: int):
    """Sorted dispatch of the T*K candidates (candidate i = token i // K,
    choice i % K) whose experts are `flat_e`: (order, counts, starts,
    pos, keep).  `order` lists the candidates by expert, token order
    within an expert (a stable argsort); `pos` is each candidate's place
    within its expert and `keep` = pos < cap (the rest are dropped)."""
    order = torch.argsort(flat_e, stable=True)
    rank = torch.empty_like(order)       # rank of candidate i in expert order
    rank[order] = torch.arange(order.shape[0], device=flat_e.device)
    counts = torch.bincount(flat_e, minlength=n_experts)
    starts = torch.cumsum(counts, 0) - counts
    pos = rank - starts[flat_e]
    return order, counts, starts, pos, pos < cap


def apply_moe(p: dict, x: torch.Tensor, spec: MoESpec, act: str,
              sharder=None):
    """x: (B, S, D) -> (y (B, S, D), aux_loss () fp32).

    `sharder` stands for the reference's expert-parallel layouts, which
    are not ported: any sharder raises."""
    if sharder is not None:
        raise NotImplementedError(
            "expert-parallel MoE (apply_moe_ep) is not ported yet (ROADMAP "
            "Queue 1, item 11: multi-device)")
    B, S, D = x.shape
    T = B * S
    E, K = spec.n_experts, spec.top_k
    C = capacity(T, spec)
    dev = x.device
    xt = x.reshape(T, D)

    logits = torch.matmul(xt.float(), p["router"]["w"].float())  # (T,E) fp32
    probs, top_p, top_e = route(logits, K)

    flat_e = top_e.reshape(-1)                                  # (T*K,)
    order, counts, starts, pos, keep = dispatch(flat_e, E, C)

    # expert buffer (E, C, D) filled by gather: slot (e, c) takes the
    # candidate ranked starts[e] + c, zeroed when c >= counts[e]
    slots = torch.arange(C, device=dev)
    slot_rank = starts[:, None] + slots[None, :]                # (E, C)
    slot_valid = slots[None, :] < counts[:, None]
    cand_of_slot = order[torch.clamp(slot_rank, max=T * K - 1)]
    tok_of_slot = cand_of_slot // K                             # (E, C)
    buf = xt[tok_of_slot.reshape(-1)].reshape(E, C, D)
    buf = torch.where(slot_valid[..., None], buf, torch.zeros_like(buf))

    h = (layers.activation(torch.bmm(buf, p["w_gate"]), act)
         * torch.bmm(buf, p["w_up"]))
    out = torch.bmm(h, p["w_down"]).reshape(E * C, D)

    # combine: candidate (t, k)'s slot is flat_e*C + pos (gathered back)
    slot = torch.clamp(flat_e * C + torch.clamp(pos, max=C - 1),
                       max=E * C - 1)
    gathered = out[slot]
    gathered = torch.where(keep[:, None], gathered,
                           torch.zeros_like(gathered))
    y = (gathered.reshape(T, K, D)
         * top_p[..., None].to(x.dtype)).sum(dim=1)

    if "shared" in p:
        y = y + layers.apply_mlp(p["shared"], xt, act)

    # load-balance aux loss (Switch-style)
    me = probs.mean(dim=0)                                      # (E,)
    ce = counts.float() / (T * K)
    aux = E * torch.sum(me * ce)
    return y.reshape(B, S, D), aux
