"""h2o-danube-1.8b — llama+mistral mix with sliding-window attention.

[arXiv:2401.16818; hf]  24L d_model=2560 32H (GQA kv=8) d_ff=6912 vocab=32000.
SWA (window 4096) => sub-quadratic => runs long_500k.
head_dim = 2560/32 = 80.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="h2o-danube-1.8b",
    family="dense",
    n_layers=24,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    d_ff=6912,
    vocab_size=32000,
    attn_window=4096,
    source="arXiv:2401.16818; hf",
))
