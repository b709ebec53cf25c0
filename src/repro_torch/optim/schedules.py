"""LR schedules (scale factors applied on top of AdamWConfig.lr).

Port of `repro/optim/schedules.py`. `step` is a Python int or a 0-d
tensor; the result is a float32 0-d tensor on the step's device (the CPU
for an int), as the reference's is a 0-d jnp array.
"""
from __future__ import annotations

import math

import torch


def _step(step):
    if isinstance(step, torch.Tensor):
        return step.to(torch.float32)
    return torch.tensor(float(step), dtype=torch.float32)


def linear_warmup(step, warmup_steps: int):
    s = _step(step)
    return torch.clamp((s + 1) / max(warmup_steps, 1), max=1.0)


def cosine_warmup(step, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1):
    s = _step(step)
    warm = torch.clamp((s + 1) / max(warmup_steps, 1), max=1.0)
    t = torch.clamp((s - warmup_steps) / max(total_steps - warmup_steps, 1),
                    0.0, 1.0)
    cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * t))
    return warm * cos
