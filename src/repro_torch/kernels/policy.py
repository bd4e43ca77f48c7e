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
