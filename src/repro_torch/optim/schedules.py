"""Learning-rate schedules (pure functions of the step counter), computed
in float32 tensors as ``repro.optim.schedules`` computes them."""
from __future__ import annotations

import math

import torch


def cosine_schedule(base_lr: float, warmup: int = 100,
                    total: int = 10_000, min_frac: float = 0.1):
    def lr(step):
        step = torch.as_tensor(step).to(torch.float32)
        f32 = lambda v: torch.tensor(v, dtype=torch.float32,
                                     device=step.device)
        warm = f32(base_lr) * torch.minimum(step / max(warmup, 1), f32(1.0))
        t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = min_frac + (1 - min_frac) * 0.5 * (
            1 + torch.cos(f32(math.pi) * t))
        return torch.where(step < warmup, warm, f32(base_lr) * cos)
    return lr
