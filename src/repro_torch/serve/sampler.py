"""Token samplers (mirrors ``repro/serve/sampler.py``; greedy only so far).

Temperature sampling is not ported yet.
"""

from __future__ import annotations

import torch


def greedy_sample(logits: torch.Tensor) -> torch.Tensor:
    """logits (B, 1, V) -> (B, 1) int64; ties go to the first index, as
    ``jnp.argmax``."""
    return torch.argmax(logits, dim=-1)
