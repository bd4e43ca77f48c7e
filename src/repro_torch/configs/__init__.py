"""Configurations of the ported system (copies of `repro.configs` modules).

`base.py` and the nine per-arch modules are the JAX package's own,
framework-free; `get_config(name)` loads the registry on first use."""
from repro_torch.configs.base import (  # noqa: F401
    ASSIGNED_ARCHS,
    LM_SHAPES,
    DECODE_32K,
    LONG_500K,
    PREFILL_32K,
    TRAIN_4K,
    ModelConfig,
    MoESpec,
    SSMSpec,
    ShapeSpec,
    get_config,
    list_configs,
    register,
)
