"""Fused epilogue vocabulary shared by the packed kernels and dense path.

    y = activation(acc_f32 + bias)          # bias/activation each optional

Mirrors ``repro/kernels/epilogue.py``. ``jax.nn.gelu`` defaults to the
tanh approximation, so ``gelu`` here is ``F.gelu(approximate="tanh")``;
the CUDA kernels compute the same formula on their fp32 accumulators
(``ACT_CODES`` is the integer code they take).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

ACTIVATIONS = {
    "relu": torch.relu,
    "silu": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
}

# activation name -> the integer the CUDA kernels switch on
ACT_CODES = {None: 0, "relu": 1, "silu": 2, "gelu": 3}


def check_activation(activation: Optional[str]) -> None:
    if activation is not None and activation not in ACTIVATIONS:
        raise ValueError(
            f"unknown epilogue activation {activation!r}; "
            f"expected one of {sorted(ACTIVATIONS)} or None")


def apply_epilogue(acc: torch.Tensor, bias: Optional[torch.Tensor],
                   activation: Optional[str]) -> torch.Tensor:
    """Epilogue on the fp32 accumulator; the caller casts back after."""
    if bias is not None:
        acc = acc + bias.to(torch.float32)
    if activation is not None:
        acc = ACTIVATIONS[activation](acc)
    return acc
