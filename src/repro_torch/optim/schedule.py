"""Learning-rate schedules, per lane."""
from __future__ import annotations

import math

import torch


def warmup_cosine(step, *, peak_lr, warmup_steps, total_steps, final_frac: float = 0.1):
    """Linear warmup, then cosine decay to ``final_frac * peak_lr``.  Every
    argument may be a per-lane tensor (K,); ``step`` is read before the
    optimizer increments it."""
    s = step.float()
    warm = peak_lr * s / torch.clamp(warmup_steps, min=1)
    prog = torch.clamp((s - warmup_steps) / torch.clamp(total_steps - warmup_steps, min=1),
                       0.0, 1.0)
    cos = peak_lr * (final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * prog)))
    return torch.where(s < warmup_steps, warm, cos)


def constant(step, *, peak_lr, **_):
    """``peak_lr`` at every step, fp32 and shaped like ``step``; ``peak_lr``
    may be a per-lane tensor (K,)."""
    return torch.zeros_like(step, dtype=torch.float32) + peak_lr
