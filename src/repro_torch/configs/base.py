"""Config system: model configs, shape specs, and the assigned-arch registry.

Every assigned architecture is a `ModelConfig`; every workload cell is a
(`ModelConfig`, `ShapeSpec`) pair. Configs are pure data.

A copy of `repro/configs/base.py` (no framework import), kept in the port
so that it imports nothing of the JAX package.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Sequence


@dataclass(frozen=True)
class MoESpec:
    """Mixture-of-experts block spec (capacity-based sorted dispatch)."""
    n_experts: int
    top_k: int
    expert_d_ff: int
    n_shared: int = 0          # number of "shared expert" units (qwen2-moe: 4)
    shared_d_ff: int = 0       # d_ff of the fused shared expert (0 = none)
    moe_every: int = 1         # MoE layer every N layers (llama4/jamba: 2)
    capacity_factor: float = 1.25
    router_dtype: str = "float32"


@dataclass(frozen=True)
class SSMSpec:
    """Mamba-2 (SSD) block spec."""
    d_state: int = 128
    expand: int = 2
    head_dim: int = 64
    conv_kernel: int = 4
    chunk_size: int = 256
    ngroups: int = 1

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class ShapeSpec:
    """One workload cell shape."""
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


TRAIN_4K = ShapeSpec("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeSpec("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeSpec("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeSpec("long_500k", 524288, 1, "decode")
LM_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)


@dataclass(frozen=True)
class ModelConfig:
    """Generic LM-family model configuration.

    `layer_pattern` is a per-period string over {'a': attention, 'm': mamba};
    n_layers must be a multiple of its length.  MoE placement is controlled by
    `moe.moe_every` (layer i is MoE iff i % moe_every == moe_offset).
    """
    name: str
    family: str                # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0          # 0 => d_model // n_heads
    layer_pattern: str = "a"
    moe: Optional[MoESpec] = None
    moe_offset: int = 1
    ssm: Optional[SSMSpec] = None
    rope: str = "rope"         # rope | rope2d | mrope | none
    rope_theta: float = 10000.0
    qkv_bias: bool = False
    attn_window: Optional[int] = None   # sliding-window attention
    norm: str = "rmsnorm"      # rmsnorm | layernorm
    act: str = "silu"          # silu | gelu
    embed_inputs: bool = True  # False => modality frontend stub feeds embeddings
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    # attention internals
    attn_chunk_q: int = 512
    attn_chunk_kv: int = 1024
    # sub-quadratic? (controls long_500k applicability)
    source: str = ""

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        assert self.n_layers % len(self.layer_pattern) == 0, (
            self.name, self.n_layers, self.layer_pattern)

    # ---- derived -------------------------------------------------------
    @property
    def period(self) -> int:
        return len(self.layer_pattern)

    @property
    def n_repeats(self) -> int:
        return self.n_layers // self.period

    def layer_kind(self, pos_in_period: int) -> str:
        return {"a": "attn", "m": "mamba"}[self.layer_pattern[pos_in_period]]

    def is_moe_layer(self, layer_idx: int) -> bool:
        if self.moe is None:
            return False
        return layer_idx % self.moe.moe_every == (self.moe_offset % self.moe.moe_every)

    @property
    def sub_quadratic(self) -> bool:
        """True if the arch supports long_500k (SSM/hybrid/SWA)."""
        return ("m" in self.layer_pattern) or (self.attn_window is not None)

    @property
    def has_attention(self) -> bool:
        return "a" in self.layer_pattern

    def shapes(self) -> Sequence[ShapeSpec]:
        """The shape cells this arch runs (long_500k only if sub-quadratic)."""
        out = [TRAIN_4K, PREFILL_32K, DECODE_32K]
        if self.sub_quadratic:
            out.append(LONG_500K)
        return tuple(out)

    def skipped_shapes(self) -> Sequence[ShapeSpec]:
        return () if self.sub_quadratic else (LONG_500K,)

    # ---- parameter counting (for roofline MODEL_FLOPS) ------------------
    def param_counts(self) -> dict:
        """Analytic parameter counts: total and active-per-token."""
        d, hd = self.d_model, self.head_dim
        attn = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) \
            + (self.n_heads * hd) * d
        if self.qkv_bias:
            attn += (self.n_heads + 2 * self.n_kv_heads) * hd
        dense_mlp = 3 * d * self.d_ff if self.d_ff else 0
        total = 0
        active = 0
        for i in range(self.n_layers):
            kind = self.layer_kind(i % self.period)
            if kind == "attn":
                total += attn
                active += attn
            else:
                s = self.ssm
                di = s.d_inner(d)
                nh = s.n_heads(d)
                m = d * (2 * di + 2 * s.ngroups * s.d_state + nh) \
                    + s.conv_kernel * (di + 2 * s.ngroups * s.d_state) \
                    + di * d + 2 * nh  # A, D
                total += m
                active += m
            if self.is_moe_layer(i):
                e = self.moe
                per_expert = 3 * d * e.expert_d_ff
                total += e.n_experts * per_expert + d * e.n_experts  # + router
                active += e.top_k * per_expert
                if e.shared_d_ff:
                    total += 3 * d * e.shared_d_ff
                    active += 3 * d * e.shared_d_ff
            elif kind == "attn" or (kind == "mamba" and False):
                total += dense_mlp
                active += dense_mlp
            elif kind == "mamba" and self.d_ff:
                # hybrid: mamba layers are followed by MLP/MoE too (jamba)
                total += dense_mlp
                active += dense_mlp
            total += 2 * d  # norms
            active += 2 * d
        emb = self.vocab_size * d
        total += emb + d  # embed + final norm
        active += emb + d
        if not self.tie_embeddings:
            total += emb
            active += emb
        return {"total": total, "active": active}

    # ---- reduced config for CPU smoke tests -----------------------------
    def tiny(self) -> "ModelConfig":
        """Structurally identical, laptop-sized config for smoke tests."""
        kw = dict(
            n_layers=self.period * min(2, self.n_repeats),
            d_model=64,
            n_heads=4,
            n_kv_heads=max(1, min(self.n_kv_heads, 2)),
            head_dim=16,
            d_ff=128 if self.d_ff else 0,
            vocab_size=256,
            attn_chunk_q=32,
            attn_chunk_kv=32,
        )
        if self.attn_window is not None:
            kw["attn_window"] = 64
        if self.moe is not None:
            # capacity_factor 8: tiny token counts route unevenly, and the
            # consistency tests (decode == prefill) need drop-free routing
            kw["moe"] = replace(
                self.moe, n_experts=min(self.moe.n_experts, 4),
                top_k=min(self.moe.top_k, 2), expert_d_ff=64,
                shared_d_ff=64 if self.moe.shared_d_ff else 0,
                capacity_factor=8.0)
        if self.ssm is not None:
            kw["ssm"] = replace(self.ssm, d_state=16, head_dim=16, chunk_size=32)
        return replace(self, **kw)


# ----------------------------------------------------------------------------
# registry
# ----------------------------------------------------------------------------
_REGISTRY: dict = {}


def register(cfg: ModelConfig) -> ModelConfig:
    assert cfg.name not in _REGISTRY, cfg.name
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    _ensure_loaded()
    return _REGISTRY[name]


def list_configs() -> list:
    _ensure_loaded()
    return sorted(_REGISTRY)


ASSIGNED_ARCHS = (
    "musicgen-medium",
    "llama4-maverick-400b-a17b",
    "qwen2-moe-a2.7b",
    "qwen2-72b",
    "h2o-danube-1.8b",
    "chatglm3-6b",
    "qwen2-vl-7b",
    "jamba-v0.1-52b",
    "mamba2-1.3b",
)


def _ensure_loaded():
    if _REGISTRY:
        return
    from repro_torch.configs import archs  # noqa: F401  (registers everything)
