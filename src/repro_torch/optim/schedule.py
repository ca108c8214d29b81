"""Learning-rate schedules (port of ``repro/optim/schedule.py``): pure
functions of the step."""
from __future__ import annotations

import math

import torch


def cosine_schedule(step, *, peak_lr: float, warmup_steps: int,
                    total_steps: int, min_ratio: float = 0.1
                    ) -> torch.Tensor:
    """Linear warm-up to ``peak_lr`` (positive at step 0), then a cosine
    decay to ``min_ratio * peak_lr`` at ``total_steps``; ``step`` is an
    int or a tensor, the result an f32 tensor."""
    s = torch.as_tensor(step).float()
    warm = peak_lr * (s + 1.0) / max(1, warmup_steps)
    t = torch.clamp((s - warmup_steps) / max(1, total_steps - warmup_steps),
                    0.0, 1.0)
    cos = peak_lr * (min_ratio + (1 - min_ratio)
                     * 0.5 * (1 + torch.cos(math.pi * t)))
    return torch.where(s < warmup_steps, warm, cos)
