"""Learning-rate schedules (``repro.optim.schedules``), as plain
functions of the step: a Python int or a tensor in, an fp32 tensor out,
with the reference's fp32 arithmetic."""
from __future__ import annotations

import math

import torch


def _step(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def constant(lr: float):
    return lambda step: torch.tensor(lr, dtype=torch.float32)


def polynomial_warmup(base_lr: float, warmup_steps: int, total_steps: int,
                      power: float = 2.0, end_lr: float = 1e-4):
    """LARS-style schedule (MLPerf ResNet reference): linear warmup over
    ``warmup_steps``, then polynomial decay of ``power`` to ``end_lr`` at
    ``total_steps``. On a step tensor on the card the value stays there."""

    def f(step):
        step = _step(step)
        warm = base_lr * (step + 1) / max(1, warmup_steps)
        frac = torch.clamp(
            (step - warmup_steps) / max(1, total_steps - warmup_steps), 0, 1)
        decay = (base_lr - end_lr) * (1 - frac) ** power + end_lr
        return torch.where(step < warmup_steps, warm, decay)

    return f


def cosine_warmup(base_lr: float, warmup_steps: int, total_steps: int,
                  min_lr: float = 0.0):
    """Linear warmup over ``warmup_steps``, then cosine decay to
    ``min_lr`` at ``total_steps``."""

    def f(step):
        step = _step(step)
        warm = base_lr * (step + 1) / max(1, warmup_steps)
        frac = torch.clamp(
            (step - warmup_steps) / max(1, total_steps - warmup_steps), 0, 1)
        decay = min_lr + 0.5 * (base_lr - min_lr) * (
            1 + torch.cos(math.pi * frac))
        return torch.where(step < warmup_steps, warm, decay)

    return f
