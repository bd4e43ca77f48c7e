"""qwen2-vl-7b — VLM text backbone with M-RoPE (3 position sections).

[arXiv:2409.12191; hf]  28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064.
Vision frontend (dynamic-resolution ViT) is a STUB per brief: `input_specs()`
feeds precomputed patch embeddings + 3-component M-RoPE position ids.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen2-vl-7b",
    family="vlm",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    d_ff=18944,
    vocab_size=152064,
    rope="mrope",
    qkv_bias=True,
    rope_theta=1000000.0,
    embed_inputs=False,    # frontend stub provides patch embeddings
    source="arXiv:2409.12191; hf",
))
