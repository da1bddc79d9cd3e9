"""Scheme -> kernel registry: pack, packed matmul, exact dense form.

Mirrors ``repro/sparse/registry.py`` for the ``dense`` and
``tile_pattern`` schemes. Every packed GEMM of the model goes through
``dispatch_matmul``, which for ``tile_pattern`` calls the
``pattern_gemm`` kernel at every M: prefill (M = B*S) and decode
(M = batch) alike. The reference's plan cache, tuner, small-M gather plan
and dispatch statistics are not carried over, and any ``plan:*`` or
``plan_mode`` entry in a ``PackedTensor.meta`` is ignored: those plans were
tuned for a CPU or a TPU.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch.kernels.epilogue import check_activation
from repro_torch.kernels.pattern_gemm import (
    pack_tile_pattern_blocked,
    pattern_gemm,
)
from repro_torch.sparse.packed import PackedTensor


@dataclasses.dataclass(frozen=True)
class SchemeHandler:
    """One scheme's deployment triple."""

    name: str
    # pack(w (I, O), spec) -> PackedTensor | None (None: stays dense)
    pack: Callable[[torch.Tensor, Any], Optional[PackedTensor]]
    # matmul(x (M, I), pt, bias, activation) -> (M, O)
    matmul: Optional[Callable[..., torch.Tensor]]
    # to_dense(pt) -> the exact dense (pruned) weight the buffers encode
    to_dense: Callable[[PackedTensor], torch.Tensor]


def _dense_pack(w: torch.Tensor, spec: Any) -> Optional[PackedTensor]:
    # no compressed form for unstructured sparsity: the leaf stays dense
    return None


def _tile_pack(w: torch.Tensor, spec: Any) -> Optional[PackedTensor]:
    """Pack a tile-pattern-pruned (I, O) leaf into the blocked layout."""
    block_p, group_q, keep = spec.tile_block_p, spec.tile_group_q, spec.tile_keep
    I, O = w.shape
    if I % group_q or O % block_p or keep >= group_q:
        return None
    wpb, lane_idx = pack_tile_pattern_blocked(w, block_p=block_p,
                                              group_q=group_q, keep=keep)
    meta = (("block_p", block_p), ("group_q", group_q), ("keep", keep),
            ("w_ndim", 3))
    return PackedTensor("tile_pattern", (I, O), ("w_packed", "lane_idx"),
                        (wpb, lane_idx), meta)


def _tile_wpb(pt: PackedTensor) -> torch.Tensor:
    """Blocked (nb, Kp, bp) panels; converts the legacy flat (Kp, P)."""
    wp = pt.buf("w_packed")
    if pt.canonical_w_ndim == 3:
        return wp
    nb = pt.buf("lane_idx").shape[0]
    Kp, P = wp.shape
    return wp.reshape(Kp, nb, P // nb).permute(1, 0, 2).contiguous()


def _tile_matmul(x, pt, bias=None, activation=None):
    return pattern_gemm(x, _tile_wpb(pt), pt.buf("lane_idx"), bias,
                        activation=activation)


def _tile_to_dense(pt: PackedTensor) -> torch.Tensor:
    """Exact dense reconstruction: scatter each panel's rows back."""
    wpb, li = _tile_wpb(pt), pt.buf("lane_idx").long()
    nb, Kp, bp = wpb.shape
    Q = pt.shape[-2]
    dense = torch.zeros((nb, Q, bp), dtype=wpb.dtype, device=wpb.device)
    dense.scatter_(1, li[:, :, None].expand(nb, Kp, bp), wpb)
    return dense.permute(1, 0, 2).reshape(Q, nb * bp)


SCHEMES = {
    "dense": SchemeHandler("dense", _dense_pack, None, lambda pt: pt.buf(
        "w_packed")),
    "tile_pattern": SchemeHandler("tile_pattern", _tile_pack, _tile_matmul,
                                  _tile_to_dense),
}


def handler_for(scheme: str) -> SchemeHandler:
    """Resolve a scheme; schemes without a packed path resolve to dense."""
    return SCHEMES.get(scheme, SCHEMES["dense"])


def dispatch_matmul(x: torch.Tensor, pt: PackedTensor, *,
                    bias: Optional[torch.Tensor] = None,
                    activation: Optional[str] = None) -> torch.Tensor:
    """y = act(x @ dense(pt) + bias) through the scheme's packed kernel."""
    check_activation(activation)
    handler = SCHEMES.get(pt.scheme)
    if handler is None or handler.matmul is None:
        raise TypeError(f"scheme {pt.scheme!r} has no packed matmul")
    return handler.matmul(x.contiguous(), pt, bias, activation)
