"""Learning-rate schedules (pure functions of the step); port of
repro.optim.schedules.

Each returns a function of the step (an int or a 0-d tensor) that gives
an f32 0-d tensor on the step's device.  AdamW evaluates it at its
incremented ``count``, so the first step uses ``lr(1)``.
"""

from __future__ import annotations

import math

import torch


def _step(step) -> torch.Tensor:
    if isinstance(step, torch.Tensor):
        return step.to(torch.float32)
    return torch.tensor(step, dtype=torch.float32)


def constant(lr: float):
    def fn(step):
        dev = step.device if isinstance(step, torch.Tensor) else None
        return torch.tensor(lr, dtype=torch.float32, device=dev)

    return fn


def _progress(step, warmup_steps: int, total_steps: int):
    return torch.clamp((step - warmup_steps)
                       / max(total_steps - warmup_steps, 1), 0.0, 1.0)


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1):
    """Linear warmup to ``peak_lr`` over ``warmup_steps``, then a cosine
    decay to ``final_frac * peak_lr`` at ``total_steps``."""
    def fn(step):
        step = _step(step)
        warm = peak_lr * step / max(warmup_steps, 1)
        prog = _progress(step, warmup_steps, total_steps)
        cos = peak_lr * (final_frac + (1 - final_frac)
                         * 0.5 * (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup_steps, warm, cos)

    return fn


def warmup_linear(peak_lr: float, warmup_steps: int, total_steps: int):
    """Linear warmup to ``peak_lr``, then a linear decay to 0."""
    def fn(step):
        step = _step(step)
        warm = peak_lr * step / max(warmup_steps, 1)
        prog = _progress(step, warmup_steps, total_steps)
        return torch.where(step < warmup_steps, warm, peak_lr * (1 - prog))

    return fn
