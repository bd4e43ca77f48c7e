"""Kernel dispatch policy: plain PyTorch or hand-written Hopper kernel.

Port of `repro/kernels/policy.py`.  Every public wrapper in
`kernels/ops.py` takes an optional `KernelPolicy` (threaded from
`EngineConfig.kernels` by the serving engine) and resolves it, per call,
against the device of the tensor it was given:

  * ``ref``    — the plain PyTorch version in `kernels/ref.py`; runs on
                 the CPU or the card.
  * ``kernel`` — the CUDA kernel built from `kernels/csrc/`; CUDA tensors
                 only.  Asking for it on a CPU tensor raises: there is no
                 interpreter to fall back to.
  * ``auto``   — ``kernel`` for CUDA tensors, ``ref`` for CPU tensors
                 (the default).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

MODES = ("auto", "ref", "kernel")


@dataclass(frozen=True)
class KernelPolicy:
    """Frozen kernel-dispatch spec carried by `EngineConfig`."""
    mode: str = "auto"

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {self.mode!r}")

    def resolve(self, t: torch.Tensor) -> str:
        """Concrete mode (``ref`` or ``kernel``) for one op on tensor `t`."""
        if self.mode == "auto":
            return "kernel" if t.is_cuda else "ref"
        if self.mode == "kernel" and not t.is_cuda:
            raise ValueError(
                f"KernelPolicy('kernel') needs CUDA tensors, got a tensor on "
                f"{t.device}; use 'ref' or 'auto' on the CPU")
        return self.mode


DEFAULT_POLICY = KernelPolicy()


def resolve(policy: KernelPolicy | None, t: torch.Tensor) -> str:
    return (policy if policy is not None else DEFAULT_POLICY).resolve(t)


# The kernel contract (repro-lint RPL002 / RPL007).  A pure dict literal:
# the linter reads it with ast.literal_eval and never imports it.  One
# entry per CUDA source, keyed by its stem (`kernels/csrc/<key>.cu`):
#   replaces      the TPU kernel it ports (file:line of the function that
#                 reaches pl.pallas_call in the reference)
#   entry_points  its C entry points, each a key of `_build.SIGNATURES`
#   wrapper       its wrapper module, `kernels/<wrapper>.py`, whose
#                 launching functions call `_build.refuse_grad` and
#                 `_build.require` before the launch and count it in
#   counters      the module counters (`ops.launch_counts`' sources)
#   entry         the wrapper's public functions, each covering the
#                 signature of a plain twin in `ref`
#   ref           its plain twins in `kernels/ref.py`
#   cost          its `kernels/cost.py` formulas: the `cost.fused` names
#                 of the `kernels/ops.py` functions that launch it
#   test          the CPU parity test(s) against the reference
#   cuda_test     the `cuda`-marked kernel-vs-plain test
KERNEL_REGISTRY = {
    "logmel": {
        "replaces": "src/repro/kernels/logmel.py:24",
        "entry_points": ["logmel_launch", "mfcc_launch"],
        "wrapper": "logmel",
        "counters": ["launches"],
        "entry": ["logmel", "mfcc"],
        "ref": ["logmel", "mfcc"],
        "cost": ["logmel"],
        "test": ["tests/test_torch_kernels.py"],
        "cuda_test": "tests/test_torch_cuda_kernels.py",
    },
    "tds_conv": {
        "replaces": "src/repro/kernels/tds_conv.py:52",
        "entry_points": ["tds_conv_launch"],
        "wrapper": "tds_conv",
        "counters": ["launches"],
        "entry": ["tds_conv", "tds_conv_ln"],
        "ref": ["tds_conv_fused", "tds_conv_ln"],
        "cost": ["tds_conv"],
        "test": ["tests/test_torch_kernels.py"],
        "cuda_test": "tests/test_torch_cuda_kernels.py",
    },
    "layernorm": {
        "replaces": "src/repro/kernels/layernorm.py:32",
        "entry_points": ["layernorm_launch", "rmsnorm_launch"],
        "wrapper": "layernorm",
        "counters": ["launches", "rmsnorm_launches"],
        "entry": ["layernorm", "bias_residual_layernorm", "rmsnorm"],
        "ref": ["layernorm", "bias_residual_layernorm", "rmsnorm"],
        "cost": ["layernorm", "rmsnorm"],
        "test": ["tests/test_torch_kernels.py",
                 "tests/test_torch_lm_kernels.py"],
        "cuda_test": "tests/test_torch_cuda_kernels.py",
    },
    "hypothesis_unit": {
        "replaces": "src/repro/kernels/hypothesis_unit.py:45",
        "entry_points": ["hypothesis_unit_launch"],
        "wrapper": "hypothesis_unit",
        "counters": ["launches"],
        "entry": ["hypothesis_unit"],
        "ref": ["hypothesis_unit"],
        "cost": ["hypothesis_unit"],
        "test": ["tests/test_torch_kernels.py"],
        "cuda_test": "tests/test_torch_cuda_kernels.py",
    },
    "int8_matmul": {
        "replaces": "src/repro/kernels/int8_matmul.py:42",
        "entry_points": ["int8_matmul_launch"],
        "wrapper": "int8_matmul",
        "counters": ["launches"],
        "entry": ["int8_matmul", "int8_matmul_fused"],
        "ref": ["int8_matmul", "int8_matmul_prepared"],
        "cost": ["int8_matmul"],
        "test": ["tests/test_torch_kernels.py"],
        "cuda_test": "tests/test_torch_cuda_kernels.py",
    },
    "flash_attention": {
        "replaces": "src/repro/kernels/flash_attention.py:80",
        "entry_points": ["flash_attention_launch", "flash_attention_design",
                         "flash_attention_ran"],
        "wrapper": "flash_attention",
        "counters": ["launches"],
        "entry": ["flash_attention"],
        "ref": ["flash_attention"],
        "cost": ["flash_attention"],
        "test": ["tests/test_torch_lm_kernels.py"],
        "cuda_test": "tests/test_torch_cuda_kernels.py",
    },
    "beam_prune": {
        "replaces": "src/repro/kernels/beam_prune.py:44",
        "entry_points": ["beam_prune_launch", "beam_prune_capacity"],
        "wrapper": "beam_prune",
        "counters": ["launches"],
        "entry": ["beam_prune"],
        "ref": ["beam_prune"],
        "cost": ["beam_prune"],
        "test": ["tests/test_torch_kernels.py"],
        "cuda_test": "tests/test_torch_cuda_kernels.py",
    },
}
