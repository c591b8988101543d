"""LR schedules, in f32. Counterpart of ``repro/optim/schedule.py``."""
from __future__ import annotations

import math

import torch


def constant(lr: float):
    return lambda step: torch.tensor(lr, dtype=torch.float32,
                                     device=step.device)


def warmup_cosine(peak: float, warmup_steps: int, total_steps: int,
                  floor: float = 0.0):
    def f(step: torch.Tensor) -> torch.Tensor:
        step = step.float()
        warm = peak * step / max(warmup_steps, 1)
        prog = torch.clamp((step - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = floor + (peak - floor) * 0.5 * (1.0 + torch.cos(math.pi * prog))
        return torch.where(step < warmup_steps, warm, cos)
    return f
