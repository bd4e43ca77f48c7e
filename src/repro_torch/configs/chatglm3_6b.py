"""chatglm3-6b — GLM block with 2d-RoPE (rotary applied to half the head dim).

[arXiv:2406.12793; hf]  28L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=65024.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="chatglm3-6b",
    family="dense",
    n_layers=28,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_ff=13696,
    vocab_size=65024,
    rope="rope2d",
    qkv_bias=True,
    source="arXiv:2406.12793; hf",
))
