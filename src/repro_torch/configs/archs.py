"""Imports every per-arch config module so the registry is populated."""
from repro_torch.configs import (  # noqa: F401
    musicgen_medium,
    llama4_maverick_400b_a17b,
    qwen2_moe_a27b,
    qwen2_72b,
    h2o_danube_18b,
    chatglm3_6b,
    qwen2_vl_7b,
    jamba_v01_52b,
    mamba2_13b,
)
