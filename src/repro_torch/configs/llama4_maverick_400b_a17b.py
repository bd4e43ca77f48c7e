"""llama4-maverick-400b-a17b — MoE decoder, early fusion (text backbone here).

[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]
48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 128e top-1.
Maverick interleaves MoE every other layer with 1 shared expert (matches the
~400B-total / 17B-active name). 128 % 16 == 0 => expert-parallel over 'model'.
"""
from repro_torch.configs.base import ModelConfig, MoESpec, register

CONFIG = register(ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    moe=MoESpec(n_experts=128, top_k=1, expert_d_ff=8192,
                n_shared=1, shared_d_ff=8192, moe_every=2),
    moe_offset=1,
    rope="rope",
    rope_theta=500000.0,
    source="hf:meta-llama/Llama-4; unverified",
))
