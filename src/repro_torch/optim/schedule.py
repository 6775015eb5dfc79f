"""Learning-rate schedules (the reference's ``optim/schedule.py``), as f32
0-dim tensors on the step's device."""
from __future__ import annotations

import math

import torch

from repro_torch.core.job import exact_div


def warmup_cosine(step, *, base_lr: float, warmup_steps: int,
                  total_steps: int, final_frac: float = 0.1):
    step = torch.as_tensor(step).float()
    warm = base_lr * torch.clamp(exact_div(step + 1, max(warmup_steps, 1)),
                                 max=1.0)
    t = torch.clamp(exact_div(step - warmup_steps,
                              max(total_steps - warmup_steps, 1)), 0.0, 1.0)
    cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * t))
    return torch.where(step < warmup_steps, warm, base_lr * cos)


def constant(step, *, base_lr: float):
    return torch.tensor(base_lr, dtype=torch.float32,
                        device=torch.as_tensor(step).device)
