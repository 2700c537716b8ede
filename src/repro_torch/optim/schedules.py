"""Learning-rate schedules (step -> lr), pure functions of a step tensor.

Counterpart of `repro/optim/schedules.py`. Each takes the optimizer's
0-dim int32 step and computes in float32 on its device, as the reference
computes on a jnp step: a float64 Python computation would give an lr
that differs in the last bits.
"""
from __future__ import annotations

import math

import torch

__all__ = ["constant", "cosine_decay", "linear_warmup", "warmup_cosine"]


def constant(value: float):
    return lambda step: torch.tensor(value, dtype=torch.float32, device=step.device)


def linear_warmup(peak: float, warmup_steps: int):
    def fn(step):
        s = step.to(torch.float32)
        return peak * torch.clamp(s / max(warmup_steps, 1), max=1.0)

    return fn


def cosine_decay(init: float, decay_steps: int, alpha: float = 0.0):
    def fn(step):
        s = torch.clamp(step.to(torch.float32), max=decay_steps)
        frac = 0.5 * (1.0 + torch.cos(math.pi * s / max(decay_steps, 1)))
        return init * ((1 - alpha) * frac + alpha)

    return fn


def warmup_cosine(peak: float, warmup_steps: int, total_steps: int, floor: float = 0.0):
    def fn(step):
        s = step.to(torch.float32)
        warm = peak * torch.clamp(s / max(warmup_steps, 1), max=1.0)
        t = torch.clamp((s - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = floor + (peak - floor) * 0.5 * (1.0 + torch.cos(math.pi * t))
        return torch.where(s < warmup_steps, warm, cos)

    return fn
