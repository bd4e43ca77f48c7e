"""mamba2-1.3b — attention-free SSD (state-space duality) stack.

[arXiv:2405.21060; unverified]
48L d_model=2048 (attn-free) d_ff=0 vocab=50280, ssm_state=128.
d_inner = 2*2048 = 4096, 64 SSD heads of dim 64. Sub-quadratic => long_500k.
ASRPU arch-applicability: the hypothesis unit + streaming decode steps apply
unchanged (SSM state is the inter-step scratchpad); attention sharding paths
are inapplicable and unused (see DESIGN.md §Arch-applicability).
"""
from repro_torch.configs.base import ModelConfig, SSMSpec, register

CONFIG = register(ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=1,            # unused (attention-free)
    n_kv_heads=1,
    head_dim=64,
    d_ff=0,               # no MLP: mamba2 blocks only
    vocab_size=50280,
    layer_pattern="m",
    ssm=SSMSpec(d_state=128, expand=2, head_dim=64, conv_kernel=4),
    rope="none",
    tie_embeddings=True,
    source="arXiv:2405.21060; unverified",
))
