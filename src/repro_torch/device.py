"""Device selection and fp32 numerics for the port's entry points."""
from __future__ import annotations

import os

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller
    names another device (the tests pass ``"cpu"``).  Without a card and
    without an explicit device this raises; it never falls back to the
    CPU on its own.  A card is named with its index (the calling
    thread's current device when none is given): PyTorch's current
    device is per thread, and an engine built on one thread is driven
    from another (`serving.server.EngineWorker` binds its thread to it)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available: the port runs on the GPU by "
                "default; pass device='cpu' to run it on the CPU")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def rank_device(device=None) -> torch.device:
    """The device of this process's rank of a mesh, with the calling
    thread bound to it: ``cuda:(LOCAL_RANK % device_count)`` unless the
    caller names a device (ranks on one host share its cards round
    robin; on a one-card host every rank gets ``cuda:0``).  Without a
    card and without an explicit device this raises, as
    `resolve_device` does."""
    if device is None or (torch.device(device).type == "cuda"
                          and torch.device(device).index is None):
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available: the port runs on the GPU by "
                "default; pass device='cpu' to run it on the CPU")
        local = int(os.environ.get("LOCAL_RANK", "0"))
        device = torch.device("cuda", local % torch.cuda.device_count())
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return device


def fp32_numerics() -> None:
    """Full fp32 matmuls and convolutions on the card (no TF32), so that
    the fp32 program computes what the reference computes."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
