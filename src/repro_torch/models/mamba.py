"""Mamba-2 (SSD, state-space duality) block, port of `repro/models/mamba.py`.

The chunked SSD algorithm of arXiv:2405.21060 §6 as plain torch: products
over (chunk x chunk) decay matrices plus an inter-chunk state carry.
Decode is the exact linear recurrence h <- h*exp(dt*A) + dt * B x ;
y = C.h + D*x.  The SSD products and the depthwise conv stay plain torch,
as the reference computes them outside any kernel; the gated RMSNorm
goes through the norm kernel (`ops.rmsnorm`, per `policy`).

On a mesh (`sharder`), as the reference: d_inner and the heads split
over 'model' (w_z, w_x, w_dt, the conv and their caches are the rank's
blocks; the depthwise conv and the per-head SSD never mix heads), w_B
and w_C, whose column blocks would split the state dimension every
head needs whole, are all-gathered, the gated RMSNorm, which runs over
the whole d_inner, gets its rows all-gathered before the norm kernel
(the rank's block of its output goes on), and out_proj is
row-parallel: its fp32 partials are all-reduced.  Where the heads do
not divide the axis every rank computes the whole block.  The
collectives are `launch/mesh.py`'s differentiable ones, so the block
trains on a mesh as it serves.  `ssd_chunked` carries the state through
a Python loop over chunks without the reference's checkpointing (the
LM's layer loop recomputes each layer in the backward): one (B, H, L,
L) decay matrix is live at a time, as in its `lax.scan`.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import SSMSpec
from repro_torch.launch import mesh as meshlib
from repro_torch.models import layers


def init_mamba(generator: torch.Generator, d_model: int, spec: SSMSpec,
               dtype=torch.bfloat16, device="cpu") -> dict:
    """Random parameters with the reference's tree, shapes and std, drawn
    from `generator` (see `layers.init_linear`)."""
    di = spec.d_inner(d_model)
    nh = spec.n_heads(d_model)
    gn = spec.ngroups * spec.d_state

    def lin(d_in, d_out):
        return layers.init_linear(generator, d_in, d_out, dtype=dtype,
                                  device=device)

    p = {"w_z": lin(d_model, di), "w_x": lin(d_model, di),
         "w_B": lin(d_model, gn), "w_C": lin(d_model, gn),
         "w_dt": lin(d_model, nh)}
    w = layers.randn(generator, (spec.conv_kernel, di))
    f32 = dict(dtype=torch.float32, device=device)
    p.update({
        "conv_x": {"w": (w * 0.1).to(device=device, dtype=dtype),
                   "b": torch.zeros((di,), dtype=dtype, device=device)},
        "A_log": torch.zeros((nh,), **f32),          # A = -exp(A_log) = -1
        "D": torch.ones((nh,), **f32),
        "dt_bias": torch.zeros((nh,), **f32),
        "norm_gate": {"scale": torch.ones((di,), **f32)},
        "out_proj": lin(di, d_model),
    })
    return p


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: torch.Tensor | None = None,
                 lengths: torch.Tensor | None = None):
    """Depthwise causal conv over time. x: (B, S, C), w: (ck, C).

    Returns (y, new_state) with new_state = the last ck-1 inputs.  ck
    shifted adds, summed in the reference's order in fp32 with the bias
    and SiLU, rounded once to x's dtype.  With `lengths` (B,),
    row b's trailing x[b, lengths[b]:] is right-padding: new_state is
    the last ck-1 inputs before the padding (a row shorter than ck-1
    keeps the initial state's rows ahead of its inputs)."""
    ck = w.shape[0]
    B, S, C = x.shape
    if state is None:
        state = torch.zeros((B, ck - 1, C), dtype=x.dtype, device=x.device)
    xp = torch.cat([state.to(x.dtype), x], dim=1)            # (B, S+ck-1, C)
    xf, wf = xp.float(), w.float()
    y = xf[:, 0:S, :] * wf[0][None, None, :]
    for i in range(1, ck):
        y = y + xf[:, i:i + S, :] * wf[i][None, None, :]
    y = F.silu(y + b.float()[None, None, :]).to(x.dtype)
    if lengths is not None:
        # xp row j holds input position j - (ck-1); the state after
        # position len-1 is xp rows len .. len+ck-2
        rows = (lengths.to(device=x.device, dtype=torch.int64)[:, None]
                + torch.arange(ck - 1, device=x.device)[None, :])  # (B, ck-1)
        new_state = torch.gather(xp, 1, rows[:, :, None].expand(-1, -1, C))
    else:
        new_state = xp[:, S:, :]
    return y, new_state


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a: (..., L). Returns (..., L, L) with out[i,j] = sum_{j<k<=i} a_k
    (i >= j), -inf above the diagonal."""
    c = torch.cumsum(a, dim=-1)
    out = c[..., :, None] - c[..., None, :]
    L = a.shape[-1]
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=a.device))
    return torch.where(mask, out, torch.full_like(out, -torch.inf))


def ssd_chunked(x, dt, A, Bm, Cm, chunk: int, h0=None):
    """Chunked SSD scan.

    x: (B, S, H, P)  dt: (B, S, H) (post-softplus)  A: (H,) (negative)
    Bm, Cm: (B, S, G, N) with G | H.  h0: optional (B, H, P, N) initial
    state.  Returns y: (B, S, H, P) fp32, h_final: (B, H, P, N) fp32."""
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    L = min(chunk, S)
    if S % L:
        raise ValueError(f"ssd_chunked: S={S} is no multiple of the chunk {L}")
    h = (torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    A = A.float()
    # head-major (B, H, S, .) / group-major (B, G, S, N) fp32 copies, so
    # every product below is one batched matmul over contiguous blocks
    xs = x.float().permute(0, 2, 1, 3).contiguous()             # (B,H,S,P)
    dts = dt.float().permute(0, 2, 1).contiguous()               # (B,H,S)
    bs = Bm.float().permute(0, 2, 1, 3).contiguous()            # (B,G,S,N)
    cs = Cm.float().permute(0, 2, 1, 3).contiguous()
    ys = []
    for c in range(S // L):
        sl = slice(c * L, (c + 1) * L)
        xc, dtc = xs[:, :, sl], dts[:, :, sl]          # (B,H,L,P), (B,H,L)
        bc, cc = bs[:, :, sl], cs[:, :, sl]            # (B,G,L,N)
        dA = dtc * A[None, :, None]                            # (B,H,L) <= 0
        dAc = torch.cumsum(dA, dim=-1)
        Lmat = torch.exp(_segsum(dA))                          # (B,H,L,L)
        # C·Bᵀ once per group, shared by its `rep` heads
        CB = torch.matmul(cc, bc.transpose(-1, -2))            # (B,G,L,L)
        CB = CB.repeat_interleave(rep, dim=1)                  # (B,H,L,L)
        y = torch.matmul(CB * Lmat * dtc[:, :, None, :], xc)   # (B,H,L,P)
        # contribution of the carried state, then the new carried state
        ch = torch.matmul(cc.repeat_interleave(rep, dim=1),
                          h.transpose(-1, -2))                 # (B,H,L,P)
        y = y + ch * torch.exp(dAc)[..., None]
        w = torch.exp(dAc[..., -1:] - dAc) * dtc               # (B,H,L)
        states = torch.matmul((xc * w[..., None]).transpose(-1, -2),
                              bc.repeat_interleave(rep, dim=1))  # (B,H,P,N)
        h = h * torch.exp(dAc[..., -1])[:, :, None, None] + states
        ys.append(y)
    return torch.cat(ys, dim=2).permute(0, 2, 1, 3), h


def init_cache(batch: int, d_model: int, spec: SSMSpec,
               dtype=torch.bfloat16, device="cpu") -> dict:
    """conv (B, ck-1, d_inner) in the model dtype; ssm (B, nh, P, N) fp32."""
    di = spec.d_inner(d_model)
    nh = spec.n_heads(d_model)
    return {
        "conv": torch.zeros((batch, spec.conv_kernel - 1, di), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((batch, nh, spec.head_dim, spec.d_state),
                           dtype=torch.float32, device=device),
    }


def _softplus(v: torch.Tensor) -> torch.Tensor:
    """jax.nn.softplus: logaddexp(v, 0) = max(v, 0) + log1p(exp(-|v|))."""
    return torch.clamp(v, min=0) + torch.log1p(torch.exp(-v.abs()))


def apply_mamba(p: dict, x: torch.Tensor, spec: SSMSpec, cache=None,
                lengths=None, policy=None, sharder=None):
    """x: (B, S, D). cache: optional {'conv', 'ssm'} for decode/streaming.

    Returns (y, new_cache).  S == 1 with a cache uses the exact step
    recurrence.  `lengths` (B,) marks x[b, lengths[b]:] as right-padding
    (bucketed prefill): dt is zeroed there, so the SSD recurrence carries
    the state through pad positions untouched (decay exp(0) = 1, update
    0), and the conv state is taken before the padding.  `policy`
    selects the kernel or the plain path of the gated RMSNorm.

    With a `sharder`, `p` and `cache` hold this rank's blocks (see the
    module docstring) and so does the returned cache."""
    B, S, D = x.shape
    nh = spec.n_heads(D)
    P, N, G = spec.head_dim, spec.d_state, spec.ngroups
    ax = (None if sharder is None or sharder.mesh is None
          else sharder.model_axis)
    if ax is not None and nh % ax.size:
        # heads that do not divide 'model': every rank computes it all
        return _whole_mamba(p, x, spec, cache, lengths, policy, ax)
    heads = slice(0, nh) if ax is None else slice(
        ax.index * (nh // ax.size), (ax.index + 1) * (nh // ax.size))
    nh_l = heads.stop - heads.start

    def mine(v):
        """The rank's heads of a replicated per-head vector."""
        return v if ax is None else meshlib.split_to(v, ax, 0)
    # x feeds the rank's column blocks of w_z, w_x and w_dt (Megatron's f)
    xm = x if ax is None else meshlib.copy_to(x, ax)
    A = -torch.exp(mine(p["A_log"]).float())
    z = layers.linear(p["w_z"], xm)                           # (B,S,di_l)
    xi = layers.linear(p["w_x"], xm)
    dt = _softplus(layers.linear(p["w_dt"], xm).float()
                   + mine(p["dt_bias"]).float())              # (B,S,nh_l)
    if lengths is not None:
        lengths = lengths.to(device=x.device, dtype=torch.int64)
        pad = (torch.arange(S, device=x.device)[None, :]
               >= lengths[:, None])                           # (B,S)
        dt = torch.where(pad[:, :, None], torch.zeros_like(dt), dt)

    conv_state = cache["conv"] if cache is not None else None
    xi, new_conv = _causal_conv(xi, p["conv_x"]["w"], p["conv_x"]["b"],
                                conv_state, lengths=lengths)
    if ax is None:
        Bm = layers.linear(p["w_B"], x).reshape(B, S, G, N)
        Cm = layers.linear(p["w_C"], x).reshape(B, S, G, N)
    else:
        # the whole state dimension, then each local head's group (the
        # rank's heads consume them)
        Bm, Cm = (meshlib.copy_to(layers.linear_col(
            p[k], x, G * N, ax).reshape(B, S, G, N), ax)
            for k in ("w_B", "w_C"))
        if G > 1:
            Bm, Cm = (t.repeat_interleave(nh // G, dim=2)[:, :, heads]
                      for t in (Bm, Cm))
    xh = xi.reshape(B, S, nh_l, P)
    Dh = mine(p["D"]).float()
    Gl = Bm.shape[2]

    if S == 1 and cache is not None:
        # exact single-step recurrence
        h = cache["ssm"].float()                              # (B,nh,P,N)
        dt1 = dt[:, 0]                                        # (B,nh)
        dec = torch.exp(dt1 * A[None, :])                     # (B,nh)
        Bf = Bm[:, 0].repeat_interleave(nh_l // Gl, dim=1).float()
        Cf = Cm[:, 0].repeat_interleave(nh_l // Gl, dim=1).float()
        xf = xh[:, 0].float()                                 # (B,nh,P)
        h_new = (h * dec[:, :, None, None]
                 + torch.einsum("bh,bhp,bhn->bhpn", dt1, xf, Bf))
        y = torch.einsum("bhpn,bhn->bhp", h_new, Cf)
        y = y + Dh[None, :, None] * xf
        y = y.reshape(B, 1, nh_l * P).to(x.dtype)
        new_cache = {"conv": new_conv, "ssm": h_new}
    else:
        h0 = cache["ssm"] if cache is not None else None
        y, hT = ssd_chunked(xh, dt, A, Bm, Cm, spec.chunk_size, h0)
        y = y + Dh[None, None, :, None] * xh.float()
        y = y.reshape(B, S, nh_l * P).to(x.dtype)
        new_cache = {"conv": new_conv, "ssm": hT}

    # gated RMSNorm (mamba2's RMSNormGated), then the output projection;
    # the gate's product in fp32, rounded once
    y = (y.float() * F.silu(z.float())).to(x.dtype)
    if ax is None:
        y = layers.apply_norm(p["norm_gate"], y, "rmsnorm", policy=policy)
        return layers.linear(p["out_proj"], y), new_cache
    # the norm runs over the whole d_inner: gather the rows first
    y = meshlib.gather_from(y, ax, 2)
    y = layers.apply_norm(p["norm_gate"], y, "rmsnorm", policy=policy)
    return layers.linear_row(p["out_proj"], layers.feature_block(y, ax),
                             ax), new_cache


def _whole_mamba(p, x, spec, cache, lengths, policy, ax):
    """apply_mamba on every rank alike, for heads that do not divide the
    mesh axis `ax`: the weights and the conv state gathered whole
    wherever d_inner split them, the rank's block of the new conv
    state returned where the cache splits it.  Every rank computes the
    same thing on the gathered weights, so each weight gradient is the
    rank's slice of the whole one (`gather_from`)."""
    di = spec.d_inner(x.shape[-1])

    def whole(lin, n_out, rows=False):
        if rows:
            if layers.in_features(lin) == n_out:
                return lin
            return {k: meshlib.gather_from(v, ax, 0) if k in ("w", "wq") else v
                    for k, v in lin.items()}
        if layers.out_features(lin) == n_out:
            return lin
        return {k: meshlib.gather_from(v, ax, v.dim() - 1)
                for k, v in lin.items()}
    q = dict(p)
    for k, n in (("w_z", di), ("w_x", di), ("w_B", spec.ngroups
                                              * spec.d_state),
                 ("w_C", spec.ngroups * spec.d_state),
                 ("w_dt", spec.n_heads(x.shape[-1]))):
        q[k] = whole(p[k], n)
    q["conv_x"] = whole(p["conv_x"], di)
    q["out_proj"] = whole(p["out_proj"], di, rows=True)
    split_conv = cache is not None and cache["conv"].shape[-1] < di
    if split_conv:
        cache = dict(cache, conv=ax.all_gather(cache["conv"], 2))
    y, new_cache = apply_mamba(q, x, spec, cache, lengths, policy)
    if p["conv_x"]["w"].shape[-1] < di:
        new_cache["conv"] = layers.feature_block(new_cache["conv"], ax)
    return y, new_cache
