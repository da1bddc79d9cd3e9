"""Flop / byte / collective-byte accumulator of the roofline model (copied
from ``repro/roofline/hlo_costs.py``; the HLO parser there has no
counterpart in the port)."""

from __future__ import annotations

import dataclasses
from typing import Dict

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")


@dataclasses.dataclass
class Costs:
    flops: float = 0.0
    bytes: float = 0.0
    collective_bytes: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {k: 0.0 for k in COLLECTIVES}
    )

    def scaled(self, f: float) -> "Costs":
        return Costs(
            flops=self.flops * f,
            bytes=self.bytes * f,
            collective_bytes={k: v * f for k, v in
                              self.collective_bytes.items()},
        )

    def add(self, other: "Costs"):
        self.flops += other.flops
        self.bytes += other.bytes
        for k in COLLECTIVES:
            self.collective_bytes[k] += other.collective_bytes[k]

    @property
    def collective_total(self) -> float:
        return sum(self.collective_bytes.values())
