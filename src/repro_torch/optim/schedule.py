"""Learning-rate schedules (warmup + cosine decay, constant), the port of
``repro.optim.schedule``: float32 arithmetic, as the reference's ``jnp``.

``step`` may be a Python int or a 0-d tensor (the optimizer's step count
on the device); the result is a 0-d float32 tensor on the step's device.
"""

from __future__ import annotations

import math

import torch


def _step(step) -> torch.Tensor:
    if isinstance(step, torch.Tensor):
        return step.to(torch.float32)
    return torch.tensor(step, dtype=torch.float32)


def warmup_cosine(step, *, peak_lr, warmup_steps, total_steps,
                  final_frac=0.1):
    """Linear warmup then cosine decay to final_frac·peak. Step 0 of a
    warmup reads 0, so the first update leaves the weights unchanged."""
    step = _step(step)
    warm = peak_lr * torch.clamp(step / max(warmup_steps, 1), max=1.0)
    t = torch.clamp((step - warmup_steps)
                    / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * t))
    return torch.where(step < warmup_steps, warm, peak_lr * cos)


def constant(step, *, peak_lr, **_):
    return torch.full((), peak_lr, dtype=torch.float32,
                      device=_step(step).device)
