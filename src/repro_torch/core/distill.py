"""Distillation objectives: problem (2) whole-model and problem (3)
layer-wise (mirrors ``repro/core/distill.py``).

Both compare SOFT outputs of the pruned student and the pre-trained
teacher on the same synthetic inputs with the squared Frobenius norm,
averaged over the batch (leading) dimension, in fp32.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.utils.tree import tree_leaves, tree_map


def _leaf_dist(s: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    d = s.to(torch.float32) - t.to(torch.float32)
    return d.square().sum() / d.shape[0]


def frobenius_distance(student_out: Any, teacher_out: Any) -> torch.Tensor:
    """||F(X) - F'(X)||_F^2 per sample. Trees (a ResNet layer's
    ``{"x", "res"}`` state) sum their leaves' distances; ``None`` leaves
    are skipped."""
    if isinstance(student_out, torch.Tensor):
        return _leaf_dist(student_out, teacher_out)
    dists = tree_leaves(tree_map(
        lambda s, t: None if s is None else _leaf_dist(s, t),
        student_out, teacher_out))
    if not dists:
        return torch.zeros((), dtype=torch.float32)
    return sum(dists[1:], dists[0])


def whole_model_loss(apply_fn: Callable[[Any, Any], torch.Tensor],
                     params: Any, batch: Any,
                     teacher_out: torch.Tensor) -> torch.Tensor:
    """Problem (2): distance between the final soft outputs."""
    return frobenius_distance(apply_fn(params, batch), teacher_out)


def layerwise_loss(apply_layer: Callable[[Any, Any], Any], layer_params: Any,
                   student_in: Any, teacher_out: Any) -> torch.Tensor:
    """Problem (3) for one layer: the layer applied to the (partially
    pruned) student's previous output, against the teacher's output of
    the same layer."""
    return frobenius_distance(apply_layer(layer_params, student_in),
                              teacher_out)
