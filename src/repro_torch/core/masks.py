"""Mask functions (mirrors ``repro/core/masks.py``; paper §III-B).

Pruning hands the client a pruned model AND a mask function for
retraining: it zeroes the gradients (and weights) of pruned positions so
the found architecture survives training on the confidential data. Masks
are trees of {0, 1} tensors congruent with the params, with ``None`` at
params that are not pruned.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.utils.tree import tree_items, tree_map_with_path


def mask_from_params(params: Any, dtype: torch.dtype = torch.bfloat16) -> Any:
    """1 where a weight is nonzero, else 0, for every leaf."""
    return tree_map_with_path(lambda _, w: (w != 0).to(dtype), params)


def masks_from_specs(pruned: Any, specs: Any) -> Any:
    """The pruner's masks: bf16 {0, 1} at pruned leaves (spec set), None
    at free params (the reference's ``PrivacyPreservingPruner._masks``)."""
    return tree_map_with_path(
        lambda _, w, spec: None if spec is None else (w != 0).to(
            torch.bfloat16), pruned, specs)


def apply_mask(params: Any, masks: Optional[Any]) -> Any:
    """Zero pruned positions. ``masks`` None is a no-op; None leaves leave
    their params as they are."""
    if masks is None:
        return params
    from repro_torch.parallel.sharding import local_elementwise

    return tree_map_with_path(
        lambda _, w, m: w if m is None else local_elementwise(
            lambda w, m: w * m.to(w.dtype), w, m), params, masks)


def mask_gradients(grads: Any, masks: Optional[Any]) -> Any:
    """The paper's mask function: gradients of pruned weights set to 0."""
    return apply_mask(grads, masks)


def sparsity(masks: Any) -> float:
    """Fraction of masked weights pruned (0 = dense)."""
    leaves = [m for _, m in tree_items(masks) if m is not None]
    total = sum(m.numel() for m in leaves)
    kept = sum(int((m != 0).sum()) for m in leaves)
    return 1.0 - kept / max(total, 1)


def compression_rate(masks: Any) -> float:
    """Total weights / remaining weights (the paper's 'CONV Comp. Rate')."""
    return 1.0 / max(1.0 - sparsity(masks), 1e-12)
