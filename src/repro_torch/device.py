"""Device selection and fp32 numerics for the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller
    names another device (the tests pass ``"cpu"``).  Without a card and
    without an explicit device this raises; it never falls back to the
    CPU on its own."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available: the port runs on the GPU by "
                "default; pass device='cpu' to run it on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def fp32_numerics() -> None:
    """Full fp32 matmuls and convolutions on the card (no TF32), so that
    the fp32 program computes what the reference computes."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
