"""LR schedules: linear warmup + cosine decay (the production default)."""
from __future__ import annotations

import math

import torch


def warmup_cosine(step, *, warmup: int, total: int, min_ratio: float = 0.1):
    """Multiplier in [min_ratio, 1] as a function of the step: a float32
    scalar tensor for a tensor step (on its device), a float for a Python
    number.  Both compute in float32, as the reference does."""
    on_tensor = isinstance(step, torch.Tensor)
    s = (step if on_tensor else torch.tensor(step)).to(torch.float32)
    warm = s / max(warmup, 1)
    prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
    out = torch.where(s < warmup, warm, cos)
    return out if on_tensor else float(out)
