"""LR schedules (warmup + cosine, the MaxText-style default)."""
from __future__ import annotations

import math

import torch

__all__ = ["warmup_cosine"]


def warmup_cosine(step, *, peak_lr: float, warmup_steps: int, total_steps: int,
                  min_ratio: float = 0.1) -> torch.Tensor:
    """The learning rate at ``step`` (a number or a tensor, taken as f32): linear
    warmup to ``peak_lr``, then a cosine down to ``min_ratio * peak_lr`` at
    ``total_steps``.  f32 arithmetic in the reference's order."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = peak_lr * step / max(warmup_steps, 1)
    frac = ((step - warmup_steps) / max(total_steps - warmup_steps, 1)).clamp(0.0, 1.0)
    cos = peak_lr * (min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * frac)))
    return torch.where(step < warmup_steps, warm, cos)
