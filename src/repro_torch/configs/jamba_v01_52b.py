"""jamba-v0.1-52b — hybrid Mamba+attention (1:7) with MoE every other layer.

[arXiv:2403.19887; hf]
32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536, MoE 16e top-2.
Period-8 pattern with one attention layer per 8 (position 3), MoE on odd
layers. Hybrid => sub-quadratic => runs long_500k.
"""
from repro_torch.configs.base import ModelConfig, MoESpec, SSMSpec, register

CONFIG = register(ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    layer_pattern="mmmammmm",
    moe=MoESpec(n_experts=16, top_k=2, expert_d_ff=14336, moe_every=2),
    moe_offset=1,
    ssm=SSMSpec(d_state=16, expand=2, head_dim=64, conv_kernel=4),
    rope="none",           # jamba uses no positional encoding
    source="arXiv:2403.19887; hf",
))
