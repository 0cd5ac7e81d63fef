"""Learning-rate schedules.

The port of ``repro.optim.schedules``: each takes the step as a tensor or an
int and returns an f32 tensor (on the step's device when it is a tensor).
"""
from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    if isinstance(step, torch.Tensor):
        return step.float()
    return torch.tensor(float(step), dtype=torch.float32)


def constant_lr(base: float):
    return lambda step: torch.full((), base, dtype=torch.float32,
                                   device=step.device if isinstance(step, torch.Tensor) else None)


def cosine_lr(base: float, total_steps: int, final_frac: float = 0.1):
    def fn(step):
        t = torch.clamp(_f32(step) / total_steps, 0.0, 1.0)
        cos = 0.5 * (1.0 + torch.cos(math.pi * t))
        return base * (final_frac + (1 - final_frac) * cos)

    return fn


def warmup_cosine(base: float, warmup: int, total_steps: int, final_frac: float = 0.1):
    cos = cosine_lr(base, max(total_steps - warmup, 1), final_frac)

    def fn(step):
        step = _f32(step)
        warm = base * torch.clamp(step / max(warmup, 1), max=1.0)
        return torch.where(step < warmup, warm, cos(step - warmup))

    return fn
