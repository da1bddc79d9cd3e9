"""Int8 gradient compression with error feedback (mirrors
``repro/optim/grad_compression.py``).

Symmetric per-tensor int8 quantization with the residual carried to the
next step (error feedback), the standard trick for convergence-neutral
4x gradient traffic reduction across a slow data-parallel link. Usage in
a train step (``launch/train.py``): compress -> (all-reduce the int8
payload across replicas) -> decompress -> optimizer. On one card there is
no all-reduce; the quantization dynamics are the reference's: codes
round half to even, as ``jnp.round`` does, and a tree is scaled per
reference leaf: the layers of an LM's ``blocks`` list share one scale, as
the reference's leaf stacked over them has one.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch.parallel.sharding import local_elementwise
from repro_torch.utils.tree import (
    reference_path,
    tree_items,
    tree_map,
    tree_map_with_path,
)


def _scale_of(absmax: torch.Tensor) -> torch.Tensor:
    return torch.clamp(absmax, min=1e-12) / 127.0


def _quantize(g32: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)


def compress_int8(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization. Returns (q, scale)."""
    g32 = g.to(torch.float32)
    scale = _scale_of(g32.abs().max())
    return _quantize(g32, scale), scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


class ErrorFeedbackState(NamedTuple):
    residual: Any  # tree of fp32 residuals, congruent with the params


def error_feedback_init(params: Any) -> ErrorFeedbackState:
    return ErrorFeedbackState(residual=tree_map(
        lambda p: torch.zeros_like(p, dtype=torch.float32), params))


def error_feedback_compress(grads: Any, ef: ErrorFeedbackState
                            ) -> Tuple[Any, Any, ErrorFeedbackState]:
    """Quantize (grads + residual); carry the quantization error forward.

    Returns (q_tree, scale_tree, new_state). A data-parallel caller
    all-reduces q (and averages scales) across replicas, then calls
    ``decompress_int8``.
    """
    corrected = tree_map(lambda g, r: local_elementwise(
        lambda g, r: g.to(torch.float32) + r, g, r), grads, ef.residual)
    absmax: Dict[str, torch.Tensor] = {}
    for path, c in tree_items(corrected):
        key, m = reference_path(path), c.abs().max()
        absmax[key] = m if key not in absmax else torch.maximum(
            absmax[key], m)
    scales = {k: _scale_of(m) for k, m in absmax.items()}
    s_tree = tree_map_with_path(lambda path, _: scales[reference_path(path)],
                                corrected)
    q_tree = tree_map(lambda c, s: local_elementwise(_quantize, c, s),
                      corrected, s_tree)
    new_resid = tree_map(lambda c, q, s: local_elementwise(
        lambda c, q, s: c - decompress_int8(q, s), c, q, s),
        corrected, q_tree, s_tree)
    return q_tree, s_tree, ErrorFeedbackState(residual=new_resid)
