"""LR schedules (pure functions of step), port of `repro/optim/schedules.py`."""
from __future__ import annotations

import torch


def cosine_with_warmup(step, *, base_lr=1.0, warmup=200, total=10000,
                       min_frac=0.1):
    """Linear warmup to `base_lr`, then a cosine decay to `min_frac` of it
    at `total`.  `step`: an int or a tensor; returns an fp32 tensor."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(warmup, 1), max=1.0)
    t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(torch.pi * t))
    return base_lr * warm * cos
