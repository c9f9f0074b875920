"""LR schedules (warmup + cosine, the production default), as
``repro.optim.schedules``."""
from __future__ import annotations

import math

import torch


def warmup_cosine(step, *, warmup_steps: int, total_steps: int,
                  min_ratio: float = 0.1) -> torch.Tensor:
    """float32 0-d: ``step / warmup_steps`` during warmup, then a cosine
    from 1 down to ``min_ratio`` at ``total_steps``; ``step`` may be a
    tensor on the card (no host sync)."""
    step = torch.as_tensor(step, dtype=torch.float32)
    warm = step / max(warmup_steps, 1)
    prog = torch.clamp((step - warmup_steps)
                       / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
    return torch.where(step < warmup_steps, warm, cos)
