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

On a mesh (`sharder`: a rank's view, `parallel/sharding.Sharder`), as
the reference (the collectives are `launch/mesh.py`'s differentiable
ones, so both paths train as they serve):
  * expert-parallel prefill (`apply_moe_ep`, `_local_dispatch_combine`)
    when the experts split over 'model', not under REPRO_BASELINE=1,
    S > 1 and the batch and sequence divide: each rank routes its own
    tokens (its batch rows, its sequence block) with a LOCAL capacity
    Cl, two all-to-alls over 'model' carry the expert buffers there and
    back, the shared expert runs on the local tokens, aux is averaged
    over 'model' and the batch axes;
  * otherwise (decode, S = 1; the baseline; axes that do not divide)
    the reference's GSPMD path, whose semantics are the unsharded
    function's: every rank routes all tokens with the global capacity
    C, computes its experts (expert-parallel) or its block of every
    expert's d_ff (tensor-parallel), and the partial outputs are
    combined with one fp32 all-reduce over 'model'.
"""
from __future__ import annotations

import collections
import math

import torch

from repro_torch.configs.base import MoESpec
from repro_torch.core.treeutil import leaves_with_paths, tree_map
from repro_torch.launch import mesh as meshlib
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
    # bincount's length is read back from the device; every id is
    # < n_experts, so a scatter of ones counts the same with no read
    counts = torch.zeros(n_experts, dtype=torch.long,
                         device=flat_e.device).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, 0) - counts
    pos = rank - starts[flat_e]
    return order, counts, starts, pos, pos < cap


def apply_moe(p: dict, x: torch.Tensor, spec: MoESpec, act: str,
              sharder=None, *, batch_local: bool = True):
    """x: (B, S, D) -> (y (B, S, D), aux_loss () fp32).

    With a `sharder`, `p` holds this rank's blocks (FSDP blocks already
    gathered) and x its rows: the rank's block of the batch over the
    batch axes when `batch_local`, else the whole batch (a batch that
    does not divide them); y has x's rows."""
    if sharder is None or sharder.mesh is None:
        return _moe(p, x, spec, act)
    nm = sharder.nm
    ep = spec.n_experts % nm == 0
    divisible = (batch_local or sharder.nb == 1) and x.shape[1] % nm == 0
    if ep and not sharder.baseline and x.shape[1] > 1 and divisible:
        return apply_moe_ep(p, x, spec, act, sharder)
    # the GSPMD path routes the global batch: gather the rows over the
    # batch axes where they are split, and keep this rank's after.  In
    # the backward each batch rank carries its own rows' share, as the
    # rest of the model does: the gather's gradient is summed over the
    # batch axes, and aux, which every batch rank computes whole, enters
    # each rank's share once divided by their count
    bax = sharder.batch_axis if batch_local else None
    xa = x if bax is None else meshlib.gather_sum(x, bax, 0)
    y, aux = _moe(p, xa, spec, act, sharder.model_axis)
    if bax is not None and bax.size > 1:
        n = x.shape[0]
        y = y[bax.index * n:(bax.index + 1) * n]
        aux = _ScaleGrad.apply(aux, 1.0 / bax.size)
    return y, aux


class _ScaleGrad(torch.autograd.Function):
    """The identity, its gradient scaled by `s`."""
    @staticmethod
    def forward(ctx, t, s):
        ctx.s = s
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.s, None


def _building_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def _moe(p: dict, x: torch.Tensor, spec: MoESpec, act: str, axis=None):
    """The capacity-C sorted dispatch over all of x's tokens.  With a
    mesh `axis` ('model'), `p` may hold the rank's experts (fewer than
    n_experts: expert-parallel) or the rank's block of every expert's
    d_ff (tensor-parallel); the rank's partial y, and the shared
    expert's, are summed in fp32 over the axis and rounded once."""
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

    # this rank's experts [lo, lo + El) (all of them unless expert-
    # parallel) and whether its expert products are partial sums over
    # a block of d_ff (tensor-parallel within each expert)
    El = p["w_gate"].shape[0]
    lo = 0 if El == E else axis.index * El
    partial = axis is not None and p["w_gate"].shape[2] < spec.expert_d_ff
    # the rank's experts (or blocks of them) consume the tokens and their
    # router weights: their gradients are summed over the axis (f)
    per_rank = axis is not None and (El < E or partial)
    xs = meshlib.copy_to(xt, axis) if per_rank else xt

    # expert buffer (El, C, D) filled by gather: slot (e, c) takes the
    # candidate ranked starts[e] + c, zeroed when c >= counts[e]
    slots = torch.arange(C, device=dev)
    slot_rank = starts[lo:lo + El, None] + slots[None, :]       # (El, C)
    slot_valid = slots[None, :] < counts[lo:lo + El, None]
    cand_of_slot = order[torch.clamp(slot_rank, max=T * K - 1)]
    tok_of_slot = cand_of_slot // K                             # (El, C)
    buf = xs[tok_of_slot.reshape(-1)].reshape(El, C, D)
    buf = torch.where(slot_valid[..., None], buf, torch.zeros_like(buf))

    h = (layers.activation(torch.bmm(buf, p["w_gate"]), act)
         * torch.bmm(buf, p["w_up"]))
    if partial:
        out = torch.bmm(h.float(), p["w_down"].float())
    else:
        out = torch.bmm(h, p["w_down"])
    out = out.reshape(El * C, D)

    # combine: candidate (t, k)'s slot is flat_e*C + pos (gathered back);
    # under expert parallelism only the rank's experts' candidates
    mine = keep
    if El < E:
        mine = keep & (flat_e >= lo) & (flat_e < lo + El)
    slot = torch.clamp((flat_e - lo) * C + torch.clamp(pos, max=C - 1),
                       min=0, max=El * C - 1)
    gathered = out[slot]
    gathered = torch.where(mine[:, None], gathered,
                           torch.zeros_like(gathered))
    if not per_rank:
        y = (gathered.reshape(T, K, D)
             * top_p[..., None].to(x.dtype)).sum(dim=1)
        if "shared" in p:
            y = y + layers.apply_mlp(p["shared"], xt, act)
    else:
        # fp32 partial sums of the rank's candidates, one all-reduce
        tp = meshlib.copy_to(top_p, axis)
        y = (gathered.reshape(T, K, D).float()
             * tp[..., None].to(x.dtype).float()).sum(dim=1)
        if "shared" in p:
            sh = p["shared"]
            if layers.out_features(sh["w_gate"]) < spec.shared_d_ff:
                hs = (layers.activation(layers.linear(sh["w_gate"], xs), act)
                      * layers.linear(sh["w_up"], xs))
                y = y + torch.matmul(
                    hs.float(), layers.weight(sh["w_down"], x.dtype).float())
            elif axis.index == 0 or _building_grad(
                    xt, *(w for _, w in leaves_with_paths(sh))):
                # a whole shared expert, added once: by the rank at index
                # 0.  Building a gradient, every rank computes it (and
                # adds 0 x it) so that every rank's backward runs the
                # same collectives; only rank 0's weight gradients are
                # nonzero, so they are summed over the axis (f)
                s = layers.apply_mlp(tree_map(
                    lambda w: meshlib.copy_to(w, axis), sh), xs, act).float()
                y = y + (s if axis.index == 0 else 0.0 * s)
        y = meshlib.reduce_from(y, axis)
        y = y.to(x.dtype)

    # load-balance aux loss (Switch-style)
    me = probs.mean(dim=0)                                      # (E,)
    ce = counts.float() / (T * K)
    aux = E * torch.sum(me * ce)
    return y.reshape(B, S, D), aux


# ---------------------------------------------------------------------------
# explicit expert-parallel MoE (all-to-all over 'model')
# ---------------------------------------------------------------------------
def local_capacity(n_tokens: int, spec: MoESpec) -> int:
    """Slots per expert on one rank's tokens (GShard local groups): the
    multiple of 8 at or above int(T·k·cf / E), at least 8."""
    return max(8, -(-int(n_tokens * spec.top_k * spec.capacity_factor
                         / spec.n_experts) // 8) * 8)


def _local_dispatch_combine(p, xl, spec: MoESpec, act: str, axis):
    """One rank's MoE body: route its tokens xl (Tl, D) with the local
    capacity Cl, gather them into an (E, Cl, D) buffer, send each
    rank's experts their rows (all-to-all over `axis`), run the rank's
    E / n experts on the rows of every rank, send the outputs back (a
    second all-to-all) and combine.  Returns (y (Tl, D), the rank's aux
    value, the candidates dropped at Cl)."""
    Tl, D = xl.shape
    E, K = spec.n_experts, spec.top_k
    nm = axis.size
    E_loc = E // nm
    Cl = local_capacity(Tl, spec)
    dev = xl.device

    # the router weights, replicated, meet this rank's tokens only (f)
    logits = torch.matmul(xl.float(),
                          meshlib.copy_to(p["router"]["w"], axis).float())
    probs, top_p, top_e = route(logits, K)
    flat_e = top_e.reshape(-1)
    order, counts, starts, pos, keep = dispatch(flat_e, E, Cl)

    slots = torch.arange(Cl, device=dev)
    slot_rank = starts[:, None] + slots[None, :]
    slot_valid = slots[None, :] < counts[:, None]
    cand = order[torch.clamp(slot_rank, max=Tl * K - 1)]
    buf = xl[(cand // K).reshape(-1)].reshape(E, Cl, D)
    buf = torch.where(slot_valid[..., None], buf, torch.zeros_like(buf))

    # dispatch: (nm, E_loc, Cl, D) -> the rows of every rank for ours
    buf = meshlib.all_to_all(buf.reshape(nm, E_loc, Cl, D), axis)
    buf = buf.transpose(0, 1).reshape(E_loc, nm * Cl, D)

    h = (layers.activation(torch.bmm(buf, p["w_gate"]), act)
         * torch.bmm(buf, p["w_up"]))
    out = torch.bmm(h, p["w_down"])                     # (E_loc, nm*Cl, D)

    # return trip
    out = out.reshape(E_loc, nm, Cl, D).transpose(0, 1)
    out = meshlib.all_to_all(out, axis).reshape(E * Cl, D)

    slot = torch.clamp(flat_e * Cl + torch.clamp(pos, max=Cl - 1),
                       max=E * Cl - 1)
    gathered = out[slot]
    gathered = torch.where(keep[:, None], gathered,
                           torch.zeros_like(gathered))
    y = (gathered.reshape(Tl, K, D) * top_p[..., None].to(xl.dtype)).sum(1)

    me = probs.mean(dim=0)
    ce = counts.float() / (Tl * K)
    aux = E * torch.sum(me * ce)
    return y, aux, (~keep).sum()


# the candidates dropped at Cl by the latest apply_moe_ep calls, one 0-d
# tensor a call (no host sync), the oldest falling out
drops = collections.deque(maxlen=4096)


def apply_moe_ep(p: dict, x: torch.Tensor, spec: MoESpec, act: str,
                 sharder):
    """Expert parallelism with explicit all-to-alls: x (B, S, D) holds
    this rank's batch rows; the rank routes its block of the sequence
    over 'model' (`_local_dispatch_combine`), adds the shared expert on
    those tokens (its weights gathered whole), and the blocks are
    all-gathered back to (B, S, D).  `p` holds the rank's E / n experts.
    aux is averaged over 'model' and the batch axes.  Local-capacity
    drop semantics: a token the unsharded function keeps may be dropped
    here; each call appends its dropped candidates to `drops`."""
    ax = sharder.model_axis
    B, S, D = x.shape
    Sl = S // ax.size
    xl = meshlib.split_to(x, ax, 1).reshape(B * Sl, D)
    y, aux, dropped = _local_dispatch_combine(p, xl, spec, act, ax)
    drops.append(dropped)
    if "shared" in p:
        y = y + layers.apply_mlp(_whole_mlp(p["shared"], spec.shared_d_ff,
                                            ax), xl, act)
    aux = meshlib.reduce_from(aux.reshape(1).clone(), ax) / ax.size
    bax = sharder.batch_axis
    aux = meshlib.reduce_from(aux, bax)[0] / bax.size
    y = meshlib.gather_from(y.reshape(B, Sl, D), ax, 1)
    return y, aux


def _whole_mlp(p: dict, d_ff: int, axis) -> dict:
    """A gated MLP's weights whole on every rank: the column blocks of
    w_gate/w_up (and their scales) and the row blocks of w_down
    all-gathered over `axis` where they are split.  Each rank applies
    them to its own tokens, so their gradients are summed over the axis
    and each rank keeps its block's (`gather_sum`); whole weights'
    gradients are summed over the axis (`copy_to`)."""
    if layers.out_features(p["w_gate"]) == d_ff:
        return tree_map(lambda w: meshlib.copy_to(w, axis), p)
    out = {}
    for name in ("w_gate", "w_up"):
        out[name] = {k: meshlib.gather_sum(v, axis, v.dim() - 1)
                     for k, v in p[name].items()}
    out["w_down"] = {k: meshlib.gather_sum(v, axis, 0) if k in ("w", "wq")
                     else v for k, v in p["w_down"].items()}
    return out
