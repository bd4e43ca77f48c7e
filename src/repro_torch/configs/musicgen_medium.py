"""musicgen-medium — decoder-only transformer over EnCodec tokens.

[arXiv:2306.05284; hf]  48L d_model=1536 24H (GQA kv=24) d_ff=6144 vocab=2048.
Audio frontend (EnCodec) is a STUB per brief: `input_specs()` feeds precomputed
frame embeddings; the backbone is what we model. MusicGen uses LayerNorm + GELU.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="musicgen-medium",
    family="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    d_ff=6144,
    vocab_size=2048,
    rope="none",            # musicgen uses learned/sinusoidal pos; stubbed frontend
    norm="layernorm",
    act="gelu",
    embed_inputs=False,     # frontend stub provides frame embeddings
    source="arXiv:2306.05284; hf",
))
