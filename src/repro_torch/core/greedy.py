"""One-shot magnitude pruning (mirrors ``repro/core/greedy.py``)."""

from __future__ import annotations

from typing import TYPE_CHECKING, Any

import torch

from repro_torch.core.masks import masks_from_specs
from repro_torch.core.schemes import PruneConfig, build_specs, project_tree
from repro_torch.device import DeviceLike, resolve_device, same_device
from repro_torch.utils.tree import tree_items

if TYPE_CHECKING:
    from repro_torch.sparse.artifact import PrunedArtifact


@torch.no_grad()
def greedy_prune(params: Any, config: PruneConfig, *,
                 device: DeviceLike = None) -> PrunedArtifact:
    """Project every prunable tensor onto its set, data-free, on ``device``.

    Returns the artifact directly (the reference returns a ``PruneResult``
    whose ``to_artifact()`` builds it), masks for retraining included.
    """
    # imported here: sparse -> kernels.pattern_conv -> core.projections
    # would otherwise come back round to this module while it loads
    from repro_torch.sparse.artifact import PrunedArtifact

    dev = resolve_device(device)
    for path, leaf in tree_items(params):
        if not same_device(leaf.device, dev):
            raise ValueError(f"param {path} is on {leaf.device}, not {dev}")
    specs = build_specs(params, config)
    pruned = project_tree(params, specs)
    return PrunedArtifact(params=pruned, masks=masks_from_specs(pruned, specs),
                          specs=specs,
                          meta={"privacy": {"data": "none",
                                            "method": "greedy_magnitude"}})
