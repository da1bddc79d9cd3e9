"""Optimizers, schedules and int8 gradient compression over the port's
parameter trees (mirrors ``repro/optim``)."""

from repro_torch.optim.grad_compression import (
    ErrorFeedbackState,
    compress_int8,
    decompress_int8,
    error_feedback_compress,
    error_feedback_init,
)
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

__all__ = ["ErrorFeedbackState", "Optimizer", "adamw", "clip_scale",
           "compress_int8", "constant", "cosine_decay", "decompress_int8",
           "error_feedback_compress", "error_feedback_init", "masked",
           "momentum", "paper_rho_schedule", "sgd", "warmup_cosine"]
