"""Learning-rate schedules, the port of ``repro.optim.schedule``."""

from __future__ import annotations

import math

import torch


def cosine_schedule(step, base_lr: float, warmup: int, total: int,
                    min_frac: float = 0.1) -> torch.Tensor:
    """Linear warm-up over ``warmup`` steps, then a cosine from ``base_lr``
    down to ``min_frac * base_lr`` at ``total``; float32, as the
    reference."""
    step = torch.as_tensor(step, dtype=torch.float32)
    warm = base_lr * torch.clamp(step / max(warmup, 1), max=1.0)
    t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = base_lr * (min_frac + (1 - min_frac) * 0.5 *
                     (1 + torch.cos(math.pi * t)))
    return torch.where(step < warmup, warm, cos)
