"""LR schedules (port of ``repro.optim.schedule``): pure functions of the
step counter, in f32 as the JAX package computes them."""
from __future__ import annotations

import math

import torch


def _step_f32(step) -> torch.Tensor:
    if torch.is_tensor(step):
        return step.to(torch.float32)
    return torch.tensor(float(step), dtype=torch.float32)


def warmup_cosine(step, *, warmup: int = 100, total: int = 10000,
                  floor: float = 0.1) -> torch.Tensor:
    s = _step_f32(step)
    warm = torch.clamp(s / max(1, warmup), max=1.0)
    prog = torch.clamp((s - warmup) / max(1, total - warmup), 0.0, 1.0)
    cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog))
    return warm * cos


def constant(step, **_) -> torch.Tensor:
    return torch.ones_like(_step_f32(step))


SCHEDULES = {"warmup_cosine": warmup_cosine, "constant": constant}
