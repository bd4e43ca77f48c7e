"""TDS acoustic model as an explicit kernel sequence, port of
`repro/models/tds.py` (fp32 and int8 programs, single device).

The network is a list of 79 kernels: 18 CONV, 29 FC, 32 LayerNorm.
Activations are (T, w, c) maps; convs are time-only (kernel k x 1) with
full c x c channel mixing; FC blocks operate on the flattened (w*c)
vector.  All convs are causal, so streaming decoding steps produce the
same outputs as offline decoding.

Convs and LayerNorms dispatch through `kernels/ops` (Hopper kernels on
the card, plain torch on the CPU).  FC/head products are `torch.matmul`
in the fp32 program, as the reference leaves them to XLA outside any
kernel, and go through the int8 kernel (`ops.int8_matmul_prepared`) in
the int8 program.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional

import torch

from repro_torch.configs.tds_asr import TDSConfig
from repro_torch.core import treeutil
from repro_torch.core.treeutil import params_from_numpy  # noqa: F401
from repro_torch.device import fp32_numerics


@dataclass(frozen=True)
class KernelSpec:
    """One ASRPU kernel: name, kind, and the setup-thread metadata."""
    name: str
    kind: str              # conv | fc | layernorm | head
    n_in: int              # inputs per output neuron (MACs) — 0 for LN
    n_out: int             # neurons == kernel threads per output frame
    kernel: int = 1        # time-kernel width (convs)
    stride: int = 1
    weight_bytes: int = 0  # int8 weight footprint (model-memory residency)
    residual: bool = False
    activation: str = "none"   # relu | none

    @property
    def n_subkernels(self) -> int:
        """FC layers are partitioned into <=1MB sub-kernels."""
        limit = 1 << 20
        return max(1, -(-self.weight_bytes // limit))


def build_kernel_specs(cfg: TDSConfig) -> List[KernelSpec]:
    specs: List[KernelSpec] = []
    w = cfg.stages[0].feat
    c_prev = 1
    c0 = cfg.stages[0].channels
    # front conv (stride 1)
    specs.append(KernelSpec("front_conv", "conv", n_in=cfg.stages[0].kernel * c_prev,
                            n_out=w * c0, kernel=cfg.stages[0].kernel,
                            weight_bytes=cfg.stages[0].kernel * c_prev * c0,
                            activation="relu"))
    c_prev = c0
    for si, st in enumerate(cfg.stages):
        # stage-entry subsampling conv + LN
        specs.append(KernelSpec(
            f"s{si}_subsample", "conv", n_in=cfg.sub_kernel * c_prev,
            n_out=w * st.channels, kernel=cfg.sub_kernel, stride=st.subsample,
            weight_bytes=cfg.sub_kernel * c_prev * st.channels,
            activation="relu"))
        specs.append(KernelSpec(f"s{si}_sub_ln", "layernorm", 0,
                                w * st.channels))
        width = w * st.channels
        for b in range(st.n_blocks):
            specs.append(KernelSpec(
                f"s{si}b{b}_conv", "conv", n_in=st.kernel * st.channels,
                n_out=width, kernel=st.kernel,
                weight_bytes=st.kernel * st.channels * st.channels,
                residual=True, activation="relu"))
            specs.append(KernelSpec(f"s{si}b{b}_ln1", "layernorm", 0, width))
            specs.append(KernelSpec(
                f"s{si}b{b}_fc1", "fc", n_in=width, n_out=width,
                weight_bytes=width * width, activation="relu"))
            specs.append(KernelSpec(
                f"s{si}b{b}_fc2", "fc", n_in=width, n_out=width,
                weight_bytes=width * width, residual=True))
            specs.append(KernelSpec(f"s{si}b{b}_ln2", "layernorm", 0, width))
        c_prev = st.channels
    width = w * cfg.stages[-1].channels
    specs.append(KernelSpec("final_ln", "layernorm", 0, width))
    specs.append(KernelSpec("head", "fc", n_in=width, n_out=cfg.vocab_size,
                            weight_bytes=width * cfg.vocab_size))
    return specs


def kernel_census(cfg: TDSConfig) -> dict:
    specs = build_kernel_specs(cfg)
    return {
        "conv": sum(s.kind == "conv" for s in specs),
        "fc": sum(s.kind in ("fc", "head") for s in specs),
        "layernorm": sum(s.kind == "layernorm" for s in specs),
    }


# ---------------------------------------------------------------------------
# parameters + forward
# ---------------------------------------------------------------------------
def init_tds(generator: torch.Generator, cfg: TDSConfig, device="cpu",
             dtype=torch.float32) -> dict:
    """Random parameters with the reference's shapes and std (normal
    weights scaled by 1/sqrt(n_in), zero biases, unit LN scales).
    Drawn on the CPU from `generator`, then moved, so a seed gives the
    same weights on every device.  (Torch cannot reproduce JAX's
    random streams: parity tests carry the reference's own parameters
    across with `params_from_numpy`.)"""
    params = {}

    def normal(shape, std):
        w = torch.randn(shape, generator=generator, dtype=torch.float32)
        return (w * std).to(device=device, dtype=dtype)

    for spec in build_kernel_specs(cfg):
        if spec.kind == "layernorm":
            params[spec.name] = {
                "scale": torch.ones((spec.n_out,), device=device),
                "bias": torch.zeros((spec.n_out,), device=device)}
        elif spec.kind == "conv":
            c_out = spec.n_out // cfg.stages[0].feat
            c_in = spec.n_in // spec.kernel
            params[spec.name] = {
                "w": normal((spec.kernel, c_in, c_out),
                            1.0 / math.sqrt(spec.n_in)),
                "b": torch.zeros((c_out,), device=device, dtype=dtype)}
        else:
            params[spec.name] = {
                "w": normal((spec.n_in, spec.n_out),
                            1.0 / math.sqrt(spec.n_in)),
                "b": torch.zeros((spec.n_out,), device=device, dtype=dtype)}
    return params


def init_stream_state(cfg: TDSConfig, device="cpu") -> dict:
    """Left-context ring buffers: (k-1, w, c_in) per conv."""
    state = {}
    w = cfg.stages[0].feat
    for spec in build_kernel_specs(cfg):
        if spec.kind == "conv":
            c_in = spec.n_in // spec.kernel
            state[spec.name] = torch.zeros((spec.kernel - 1, w, c_in),
                                           dtype=torch.float32, device=device)
    return state


def init_batched_stream_state(cfg: TDSConfig, batch: int,
                              device="cpu") -> dict:
    """Stream state for `batch` concurrent utterances: (B, k-1, w, c_in)
    per conv — the per-slot left context of a multi-stream slot pool."""
    return treeutil.batch_tree(init_stream_state(cfg, device), batch)


def reset_stream_slot(state: dict, slot, cfg: TDSConfig) -> dict:
    """A copy of `state` with one slot's left context zeroed."""
    dev = next(iter(state.values())).device
    return treeutil.set_slot(state, slot, init_stream_state(cfg, dev))


def state_bytes(cfg: TDSConfig, bytes_per_el: int = 1) -> int:
    """Bytes of one stream's left context at `bytes_per_el` per value."""
    return sum(a.numel() * bytes_per_el
               for a in init_stream_state(cfg).values())


def quantize_params(params, cfg: TDSConfig) -> dict:
    """Pre-quantize every FC/head weight matrix once (int8 + per-output
    scales, on the weights' device): {kernel name: {"wq", "ws"}}.  The
    serving engine builds this when it is constructed, so the decode
    hot path only quantizes activations (`ops.int8_matmul_prepared`)."""
    from repro_torch.kernels import ops
    prepared = {}
    for spec in build_kernel_specs(cfg):
        if spec.kind in ("fc", "head"):
            wq, ws = ops.prepare_int8_weights(params[spec.name]["w"])
            prepared[spec.name] = {"wq": wq, "ws": ws}
    return prepared


def forward_batched(params, cfg: TDSConfig, feats: torch.Tensor, state: dict,
                    use_int8: bool = False, kernels=None,
                    prepared: Optional[dict] = None):
    """Slot-native TDS forward.  feats: (B, T, n_mfcc); state: the
    batched stream state ((B, k-1, w, c_in) per conv).  Returns
    (log_probs (B, T', V), new_state).

    The slot axis folds into the row dimension of every product —
    (B*T, w*c) rows for FC/head/LayerNorm, (B*T*w, c_in) rows for each
    conv tap.  Convs, LayerNorms and the int8 FC/head products dispatch
    through `kernels` (a KernelPolicy).  `use_int8` routes the FC/head
    products through the int8 path; `prepared` (from `quantize_params`)
    supplies its pre-quantized weights, without which they are quantized
    on every call.  Returns new tensors; `state` is not modified."""
    from repro_torch.kernels import ops

    def matmul(xm, name, p):
        if not use_int8:
            return xm @ p["w"] + p["b"]
        if prepared is not None and name in prepared:
            pq = prepared[name]
            return ops.int8_matmul_prepared(xm, pq["wq"], pq["ws"],
                                            policy=kernels) + p["b"]
        return ops.int8_matmul(xm, p["w"], policy=kernels) + p["b"]

    fp32_numerics()
    specs = build_kernel_specs(cfg)
    new_state = dict(state)
    w = cfg.stages[0].feat
    B = feats.shape[0]
    x = feats[:, :, :, None]                         # (B, T, w, 1)
    fc_res = None
    for spec in specs:
        p = params[spec.name]
        if spec.kind == "conv":
            k, s = spec.kernel, spec.stride
            m = x.shape[1]
            if m % s:
                raise ValueError(f"{spec.name}: {m} frames, stride {s}")
            xp = torch.cat([state[spec.name], x], dim=1)
            res = x if (spec.residual and s == 1
                        and x.shape[-1] == spec.n_out // w) else None
            x = ops.tds_conv(xp, p["w"], p["b"], stride=s,
                             relu=spec.activation == "relu", res=res,
                             policy=kernels)
            new_state[spec.name] = xp[:, -(k - 1):] if k > 1 \
                else state[spec.name]
        elif spec.kind == "layernorm":
            t = x.shape[1]
            xm = ops.layernorm(x.reshape(B * t, -1), p["scale"], p["bias"],
                               policy=kernels)
            x = xm.reshape(x.shape)
        else:  # fc / head
            t = x.shape[1]
            xm = x.reshape(B * t, -1)
            if spec.activation == "relu":      # fc1: start of the FC block
                fc_res = xm
            y = matmul(xm, spec.name, p)
            if spec.activation == "relu":
                y = torch.relu(y)
            if spec.residual and fc_res is not None \
                    and y.shape == fc_res.shape:
                y = y + fc_res                 # TDS residual: whole FC block
            if spec.name == "head":
                logp = torch.log_softmax(y, dim=-1)
                return logp.reshape(B, t, -1), new_state
            c = spec.n_out // w
            x = y.reshape(B, t, w, c)
    raise AssertionError("head kernel missing")


def forward(params, cfg: TDSConfig, feats: torch.Tensor,
            state: Optional[dict] = None, use_int8: bool = False,
            kernels=None, prepared: Optional[dict] = None):
    """feats: (T, n_mfcc). Returns (log_probs (T', V), new_state).

    state=None => offline (zero left context).  use_int8 routes the
    FC/head products through the int8 path (ASRPU's 8-bit MAC;
    `prepared` from `quantize_params` skips the per-call weight
    quantization).  The B=1 slice of `forward_batched`: single-stream
    and slot-pooled decoding share one code path."""
    st_in = state if state is not None \
        else init_stream_state(cfg, feats.device)
    bst = {k: v[None] for k, v in st_in.items()}
    logp, ns = forward_batched(params, cfg, feats[None], bst,
                               use_int8=use_int8, kernels=kernels,
                               prepared=prepared)
    return logp[0], {k: v[0] for k, v in ns.items()}
