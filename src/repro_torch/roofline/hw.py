"""NVIDIA H100 SXM hardware constants (the port's target card) + roofline
terms (the counterpart of ``repro/roofline/hw.py``).

    compute term    = FLOPs / (cards × peak FLOP/s)
    memory term     = bytes / (cards × HBM bw)
    collective term = collective bytes / (cards × NVLink bw per direction)

All terms are SECONDS for one step; the dominant term is the
roofline-predicted step time, and useful-FLOPs / dominant term / peak is
the roofline fraction ("MFU-bound").

The constants are the H100 SXM5 data sheet's (80 GB HBM3): dense bf16
tensor-core FLOP/s, fp32 FLOP/s on the CUDA cores (non-tensor: the
kernels' fp32 routes run there), HBM3 bytes/s, and NVLink 4's 900 GB/s
split per direction. A card set below its 700 W maximum runs slower under
load, so a measurement names the card and its power limit beside it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

PEAK_FLOPS_BF16 = 989e12      # per card, dense tensor cores
PEAK_FLOPS_FP32 = 67e12       # per card, CUDA cores (non-tensor)
HBM_BW = 3.35e12              # bytes/s per card
NVLINK_BW = 450e9             # bytes/s per card per direction


@dataclasses.dataclass(frozen=True)
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def step_s(self) -> float:
        """Roofline-predicted step time = the dominant term (perfect overlap)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    def as_dict(self) -> Dict[str, float]:
        return {
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "step_s": self.step_s,
        }


def roofline_terms(
    flops: float,
    bytes_accessed: float,
    collective_bytes: float,
    *,
    per_device: bool = True,
    chips: int = 1,
    peak_flops: float = PEAK_FLOPS_BF16,
) -> RooflineTerms:
    """Three roofline terms in seconds.

    ``per_device=True`` (per-card counts): the per-card denominators apply
    directly and ``chips`` is ignored. ``peak_flops`` is the rate of the
    work's type (``PEAK_FLOPS_FP32`` for fp32 on the CUDA cores).
    """
    div = 1 if per_device else max(chips, 1)
    return RooflineTerms(
        compute_s=flops / (div * peak_flops),
        memory_s=bytes_accessed / (div * HBM_BW),
        collective_s=collective_bytes / (div * NVLINK_BW),
    )


def model_flops_train(n_params: int, n_tokens: int) -> float:
    """6·N·D — the standard useful-FLOPs estimate for one training step."""
    return 6.0 * n_params * n_tokens


def model_flops_infer(n_params: int, n_tokens: int) -> float:
    """2·N·D — forward-only useful FLOPs."""
    return 2.0 * n_params * n_tokens
