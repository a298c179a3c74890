"""Learning-rate schedules, step → lr (port of
``repro/optim/schedule.py``). ``step`` is an integer tensor; the result
is a float32 tensor on its device, computed as JAX computes it."""

from __future__ import annotations

import math

import torch


def constant(lr: float):
    return lambda step: torch.tensor(lr, dtype=torch.float32,
                                     device=step.device)


def linear_warmup(lr: float, warmup: int):
    def fn(step):
        s = step.to(torch.float32)
        return lr * torch.clamp(s / max(warmup, 1), max=1.0)
    return fn


def cosine_warmup(lr: float, warmup: int, total: int,
                  final_frac: float = 0.1):
    def fn(step):
        s = step.to(torch.float32)
        warm = torch.clamp(s / max(warmup, 1), max=1.0)
        prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (
            1 + torch.cos(math.pi * prog))
        return lr * warm * cos
    return fn
