"""LR schedule: linear warmup + cosine decay — port of
``repro/optim/schedule.py``, in f32 tensors, step by step as the
reference computes it."""
from __future__ import annotations

import math

import torch

__all__ = ["warmup_cosine"]


def warmup_cosine(step, *, warmup: int = 100, total: int = 10_000, floor: float = 0.1) -> torch.Tensor:
    """The LR multiplier at ``step`` (an int, or a tensor on any device) as
    an f32 tensor: ``step / warmup`` during warmup, then a cosine from 1 down
    to ``floor`` at ``total``, and ``floor`` after."""
    step = torch.as_tensor(step, dtype=torch.float32)
    warm = step / max(warmup, 1)
    frac = (step - warmup) / max(total - warmup, 1)
    cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * torch.clamp(frac, 0, 1)))
    return torch.where(step < warmup, warm, cos)
