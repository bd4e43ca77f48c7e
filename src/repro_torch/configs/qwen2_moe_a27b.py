"""qwen2-moe-a2.7b — 4 shared + 60 routed top-4 MoE.

[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]
24L d_model=2048 16H (GQA kv=16) d_ff=1408 vocab=151936, MoE 60e top-4.
60 % 16 != 0 => TP-within-expert sharding (expert_d_ff=1408 divisible by 16).
Shared expert fused d_ff = 4*1408 = 5632.
"""
from repro_torch.configs.base import ModelConfig, MoESpec, register

CONFIG = register(ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=151936,
    moe=MoESpec(n_experts=60, top_k=4, expert_d_ff=1408,
                n_shared=4, shared_d_ff=5632, moe_every=1),
    moe_offset=0,
    qkv_bias=True,
    source="hf:Qwen/Qwen1.5-MoE-A2.7B; hf",
))
