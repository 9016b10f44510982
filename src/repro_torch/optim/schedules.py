"""LR schedules as pure step -> scale functions (port of
``repro/optim/schedules.py``): the step may be an int or a 0-d tensor; the
scale is an fp32 0-d tensor that multiplies the peak LR."""
from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def constant():
    return lambda step: torch.ones((), dtype=torch.float32)


def warmup_cosine(warmup_steps: int, total_steps: int, final_frac: float = 0.1):
    def fn(step):
        s = _f32(step)
        w = max(warmup_steps, 1)
        warm = s / w
        prog = torch.clamp((s - warmup_steps) / max(total_steps - warmup_steps, 1),
                           0.0, 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
        return torch.where(s < warmup_steps, warm, cos)
    return fn


def warmup_linear(warmup_steps: int, total_steps: int):
    def fn(step):
        s = _f32(step)
        warm = s / max(warmup_steps, 1)
        decay = torch.clamp(1.0 - (s - warmup_steps) /
                            max(total_steps - warmup_steps, 1), 0.0, 1.0)
        return torch.where(s < warmup_steps, warm, decay)
    return fn
