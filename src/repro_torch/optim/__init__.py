"""Optimizers and schedules over the port's parameter trees (mirrors
``repro/optim``; the distributed-only gradient compression is not
ported)."""

from repro_torch.optim.masked import masked
from repro_torch.optim.optimizers import (
    Optimizer,
    adamw,
    clip_scale,
    momentum,
    sgd,
)
from repro_torch.optim.schedules import (
    constant,
    cosine_decay,
    paper_rho_schedule,
    warmup_cosine,
)

__all__ = ["Optimizer", "adamw", "clip_scale", "constant", "cosine_decay", "masked",
           "momentum", "paper_rho_schedule", "sgd", "warmup_cosine"]
