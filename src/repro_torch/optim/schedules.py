"""Learning-rate schedules: functions of the optimizer's step (an int32
tensor or an int) returning the rate as a 0-d float32 tensor, computed in
float32 as the reference's `jnp` versions are."""
from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def constant(value: float):
    return lambda step: torch.tensor(value, dtype=torch.float32)


def linear_warmup_cosine(peak: float, warmup_steps: int, total_steps: int,
                         final_frac: float = 0.1):
    def fn(step):
        step = _f32(step)
        warm = peak * step / max(warmup_steps, 1)
        prog = torch.clamp((step - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = peak * (final_frac + (1 - final_frac) * 0.5 *
                      (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup_steps, warm, cos)
    return fn


def inverse_sqrt(peak: float, warmup_steps: int):
    def fn(step):
        step = torch.clamp(_f32(step), min=1.0)
        return peak * torch.minimum(step / max(warmup_steps, 1),
                                    torch.sqrt(warmup_steps / step))
    return fn
