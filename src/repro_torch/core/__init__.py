"""Data-free pruning for the port: magnitude projection, per-layer specs,
and the one-shot ``greedy_prune`` (mirrors parts of ``repro/core``)."""

from repro_torch.core.greedy import greedy_prune
from repro_torch.core.schemes import (
    DEFAULT_EXCLUDE,
    LayerSpec,
    PruneConfig,
    build_specs,
    project_tree,
)

__all__ = ["DEFAULT_EXCLUDE", "LayerSpec", "PruneConfig", "build_specs",
           "greedy_prune", "project_tree"]
