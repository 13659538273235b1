"""Learning-rate schedules (``repro.optim.schedule``): functions of the
0-d step tensor, computed on its device."""

from __future__ import annotations

import math

import torch

Tensor = torch.Tensor


def constant(value: float):
    return lambda step: torch.full((), value, dtype=torch.float32,
                                   device=step.device)


def cosine_decay(base: float, total_steps: int, floor: float = 0.0):
    def fn(step: Tensor) -> Tensor:
        frac = torch.clamp(step.to(torch.float32) / max(total_steps, 1),
                           0.0, 1.0)
        return floor + 0.5 * (base - floor) * (1 + torch.cos(math.pi * frac))
    return fn


def linear_warmup_cosine(base: float, warmup: int, total_steps: int,
                         floor: float = 0.0):
    cos = cosine_decay(base, max(total_steps - warmup, 1), floor)

    def fn(step: Tensor) -> Tensor:
        step_f = step.to(torch.float32)
        warm = base * step_f / max(warmup, 1)
        return torch.where(step_f < warmup, warm, cos(step_f - warmup))
    return fn
