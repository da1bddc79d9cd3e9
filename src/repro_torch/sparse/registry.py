"""Scheme -> kernel registry: pack, packed matmul or conv, exact dense form.

Mirrors ``repro/sparse/registry.py`` for the ``dense``, ``tile_pattern``,
``column``, ``pattern`` and ``pattern_shared`` schemes. Every packed GEMM
of a model goes through ``dispatch_matmul`` and every packed conv through
``dispatch_conv``; each calls its scheme's kernel at every M: prefill
(M = B*S) and decode (M = batch) alike, and every conv batch. The
reference's plan cache, tuner, small-M gather plans and dispatch
statistics are not carried over, and any ``plan:*`` or ``plan_mode`` entry
in a ``PackedTensor.meta`` is ignored: those plans were tuned for a CPU or
a TPU.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch.kernels.column_gemm import column_gemm, pack_columns
from repro_torch.kernels.epilogue import check_activation
from repro_torch.kernels.pattern_conv import pattern_conv
from repro_torch.kernels.pattern_gemm import (
    pack_tile_pattern_blocked,
    pattern_gemm,
)
from repro_torch.sparse.packed import PackedTensor


@dataclasses.dataclass(frozen=True)
class SchemeHandler:
    """One scheme's deployment triple, plus its conv for conv schemes."""

    name: str
    # pack(w, spec) -> PackedTensor | None (None: stays dense)
    pack: Callable[[torch.Tensor, Any], Optional[PackedTensor]]
    # matmul(x (M, I), pt, bias, activation) -> (M, O)
    matmul: Optional[Callable[..., torch.Tensor]]
    # to_dense(pt) -> the exact dense (pruned) weight the buffers encode
    to_dense: Callable[[PackedTensor], torch.Tensor]
    # conv(x (B, H, W, C), pt, bias, activation) -> (B, H, W, A)
    conv: Optional[Callable[..., torch.Tensor]] = None


def _dense_pack(w: torch.Tensor, spec: Any) -> Optional[PackedTensor]:
    # no compressed form for unstructured sparsity: the leaf stays dense
    return None


# --------------------------------------------------------------- tile_pattern

def _tile_pack(w: torch.Tensor, spec: Any) -> Optional[PackedTensor]:
    """Pack a tile-pattern-pruned (I, O) leaf into the blocked layout."""
    block_p, group_q, keep = spec.tile_block_p, spec.tile_group_q, spec.tile_keep
    if w.ndim != 2:
        return None
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


# --------------------------------------------------------------------- column

def _column_pack(w: torch.Tensor, spec: Any) -> Optional[PackedTensor]:
    """Pack a column-pruned (I, O) leaf: keep the surviving contraction
    rows. Nothing pruned, or a leaf that is not 2-D: stays dense."""
    if w.ndim != 2:
        return None
    group = spec.column_group
    wp, kept = pack_columns(w, group=group)
    if kept.shape[0] >= w.shape[0]:
        return None
    return PackedTensor("column", tuple(w.shape), ("w_packed", "kept_idx"),
                        (wp, kept), (("group", group),))


def _column_matmul(x, pt, bias=None, activation=None):
    return column_gemm(x, pt.buf("w_packed"), pt.buf("kept_idx"), bias,
                       activation=activation)


def _column_to_dense(pt: PackedTensor) -> torch.Tensor:
    """Exact dense reconstruction. Rows that a stacked reference artifact
    padded (index 0, zero weight) add zeros, so the sum stays exact."""
    wp = pt.buf("w_packed")
    dense = torch.zeros((pt.shape[-2], wp.shape[1]), dtype=wp.dtype,
                        device=wp.device)
    return dense.index_put_((pt.buf("kept_idx").long(),), wp,
                            accumulate=True)


# -------------------------------------------------------------------- pattern

def _pattern_pack(w4: torch.Tensor, spec: Any) -> Optional[PackedTensor]:
    """Pack a pattern-pruned conv (A, C, 3, 3) with channel-shared taps.

    Each channel's taps are the union of its nonzero taps over all
    filters; the leaf packs only when that fits ``pattern_keep`` taps
    (else None: it stays dense). Unused slots of a channel (connectivity
    pruned some of its taps, or all) hold tap 0 with zero weight.
    """
    if w4.ndim != 4 or tuple(w4.shape[-2:]) != (3, 3):
        return None
    keep = spec.pattern_keep
    A, C = w4.shape[0], w4.shape[1]
    nz = (w4 != 0).any(dim=0).reshape(C, 9)
    count = nz.sum(dim=1)
    if bool((count > keep).any()):
        return None
    # each channel's nonzero taps in ascending order, then the others
    order = torch.argsort((~nz).to(torch.int32), dim=1, stable=True)[:, :keep]
    used = torch.arange(keep, device=w4.device)[None, :] < count[:, None]
    taps = torch.where(used, order, torch.zeros_like(order))
    wk = torch.gather(w4.reshape(A, C, 9), 2, taps[None].expand(A, C, keep))
    wk = torch.where(used[None], wk, torch.zeros((), dtype=w4.dtype,
                                                 device=w4.device))
    w_packed = wk.permute(1, 2, 0).reshape(C * keep, A).contiguous()
    return PackedTensor("pattern", tuple(w4.shape), ("w_packed", "taps"),
                        (w_packed, taps.to(torch.int32).contiguous()),
                        (("keep", keep),))


def _pattern_conv(x, pt, bias=None, activation=None):
    """Stride-1 SAME 3x3 pattern conv: x (B, H, W, C) -> (B, H, W, A)."""
    return pattern_conv(x, pt.buf("w_packed"), pt.buf("taps"), bias,
                        activation=activation)


def _pattern_matmul(x, pt, bias=None, activation=None):
    raise TypeError("scheme 'pattern' packs a conv tensor; use conv "
                    "dispatch (models.cnn.conv_apply), not a GEMM matmul")


def _pattern_to_dense(pt: PackedTensor) -> torch.Tensor:
    """Exact dense reconstruction; zero-weight pad slots add zeros."""
    wp, taps = pt.buf("w_packed"), pt.buf("taps").long()
    A, C = pt.shape[0], pt.shape[1]
    keep = taps.shape[1]
    dense = torch.zeros((C, 9, A), dtype=wp.dtype, device=wp.device)
    rows = torch.arange(C, device=wp.device)[:, None].expand(C, keep)
    dense.index_put_((rows, taps), wp.reshape(C, keep, A), accumulate=True)
    return dense.permute(2, 0, 1).reshape(A, C, 3, 3)


_PATTERN = dict(pack=_pattern_pack, matmul=_pattern_matmul,
                to_dense=_pattern_to_dense, conv=_pattern_conv)

SCHEMES = {
    "dense": SchemeHandler("dense", _dense_pack, None, lambda pt: pt.buf(
        "w_packed")),
    "tile_pattern": SchemeHandler("tile_pattern", _tile_pack, _tile_matmul,
                                  _tile_to_dense),
    "column": SchemeHandler("column", _column_pack, _column_matmul,
                            _column_to_dense),
    # `pattern` (per-kernel top-4) packs only where the taps happen to be
    # channel-shared; `pattern_shared` always packs, its projection makes
    # them so. Both pack into a "pattern" leaf.
    "pattern": SchemeHandler("pattern", **_PATTERN),
    "pattern_shared": SchemeHandler("pattern_shared", **_PATTERN),
}


def handler_for(scheme: str) -> SchemeHandler:
    """Resolve a scheme; schemes without a packed path resolve to dense."""
    return SCHEMES.get(scheme, SCHEMES["dense"])


def _handler_of(pt: PackedTensor) -> SchemeHandler:
    # no fallback: a leaf tagged with an unknown scheme must fail loudly,
    # not have its buffers misread
    handler = SCHEMES.get(pt.scheme)
    if handler is None:
        raise KeyError(f"unknown packed scheme {pt.scheme!r}")
    return handler


def dispatch_matmul(x: torch.Tensor, pt: PackedTensor, *,
                    bias: Optional[torch.Tensor] = None,
                    activation: Optional[str] = None) -> torch.Tensor:
    """y = act(x @ dense(pt) + bias) through the scheme's packed kernel."""
    check_activation(activation)
    handler = _handler_of(pt)
    if handler.matmul is None:
        raise TypeError(f"scheme {pt.scheme!r} has no packed matmul")
    return handler.matmul(x.contiguous(), pt, bias, activation)


def dispatch_conv(x: torch.Tensor, pt: PackedTensor, *,
                  bias: Optional[torch.Tensor] = None,
                  activation: Optional[str] = None) -> torch.Tensor:
    """act(conv(x, dense(pt)) + bias) through the scheme's packed conv
    kernel (stride 1, SAME; conv-shaped schemes only)."""
    check_activation(activation)
    handler = _handler_of(pt)
    if handler.conv is None:
        raise TypeError(f"scheme {pt.scheme!r} has no conv dispatch")
    return handler.conv(x.contiguous(), pt, bias, activation)
