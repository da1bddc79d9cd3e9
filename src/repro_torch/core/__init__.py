"""Data-free pruning for the port: magnitude projection, per-layer specs,
the one-shot ``greedy_prune`` and the retraining masks (mirrors parts of
``repro/core``)."""

from repro_torch.core.greedy import greedy_prune
from repro_torch.core.masks import (
    apply_mask,
    compression_rate,
    mask_from_params,
    mask_gradients,
    sparsity,
)
from repro_torch.core.schemes import (
    DEFAULT_EXCLUDE,
    LayerSpec,
    PruneConfig,
    build_specs,
    project_tree,
)

__all__ = ["DEFAULT_EXCLUDE", "LayerSpec", "PruneConfig", "apply_mask",
           "build_specs", "compression_rate", "greedy_prune",
           "mask_from_params", "mask_gradients", "project_tree", "sparsity"]
