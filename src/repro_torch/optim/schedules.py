"""Learning-rate schedules (``repro.optim.schedules``): step -> scale multiplier.

The reference computes in float32: an integer step is converted to float32 and
Python constants enter as float32, so this port does the same on 0-dim tensors.
torch's float32 ``cos`` differs from XLA-CPU's in the last bit at some
arguments (ROADMAP queue 3, item 18).
"""

from __future__ import annotations

import math

import torch


def linear_warmup_cosine(step, warmup_steps: int, total_steps: int,
                         min_ratio: float = 0.1):
    """Linear warm-up over ``warmup_steps``, then a cosine from 1 down to
    ``min_ratio`` at ``total_steps``; a float32 0-dim tensor on the step's
    device (a Python step gives one on the CPU)."""
    s = step.float() if torch.is_tensor(step) else torch.tensor(float(step))
    warm = torch.clamp(s / max(warmup_steps, 1), max=1.0)
    prog = torch.clamp((s - warmup_steps) / max(total_steps - warmup_steps, 1), 0, 1)
    cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
    return warm * cos


def constant(step):
    return 1.0
