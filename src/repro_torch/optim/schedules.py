"""Learning-rate and penalty schedules (mirrors ``repro/optim/schedules.py``).

A learning-rate schedule maps the optimizer's int32 step (a 0-d tensor)
to a 0-d fp32 tensor.
"""

from __future__ import annotations

import math

import torch


def constant(value: float):
    return lambda step: torch.tensor(value, dtype=torch.float32)


def cosine_decay(peak: float, total_steps: int, final_frac: float = 0.1):
    def sched(step):
        t = torch.clamp(step.to(torch.float32) / total_steps, 0.0, 1.0)
        cos = 0.5 * (1 + torch.cos(math.pi * t))
        return peak * (final_frac + (1 - final_frac) * cos)

    return sched


def warmup_cosine(peak: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1):
    def sched(step):
        s = step.to(torch.float32)
        warm = peak * s / max(warmup_steps, 1)
        t = torch.clamp((s - warmup_steps)
                        / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = peak * (final_frac
                      + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * t)))
        return torch.where(s < warmup_steps, warm, cos)

    return sched


def paper_rho_schedule(rho_init: float = 1e-4, rho_max: float = 1e-1,
                       mult: float = 10.0, every_iters: int = 110):
    """Paper section V-A: rho starts at 1e-4, x10 every 11 epochs (110
    iterations), capped at 1e-1."""

    def sched(it: int) -> float:
        steps = it // every_iters
        # guard the exponent: mult**steps overflows a float for a huge it
        if steps * math.log(max(mult, 1 + 1e-12)) > math.log(rho_max
                                                             / rho_init):
            return float(rho_max)
        return float(min(rho_init * mult ** steps, rho_max))

    return sched
