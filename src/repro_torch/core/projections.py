"""Euclidean projections onto the sparsity sets (``repro/core/projections.py``).

Every projection takes the paper's GEMM view ``W (P = out, Q = in)``, or
the 4-D conv tensor ``(A, B, C, D)`` for the kernel-level schemes, and
keeps the entries its set allows. Keep counts are static (from shapes and
the remaining-weight ratio ``alpha``), and the top-k selections keep every
score tied with the k-th (``>= kth``), as the reference does, so pruned
weights are bit-equal to the reference's. ``project_tile_pattern`` is the
one deliberate departure: it keeps exactly ``keep`` lanes (see its
docstring).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

KERNEL_SCHEMES = ("pattern", "pattern_shared", "kernel_pattern",
                  "connectivity")


def _keep_count(total: int, alpha: float, minimum: int = 1) -> int:
    """floor(alpha * total) clamped to [minimum, total]."""
    k = int(math.floor(alpha * total))
    return max(minimum, min(k, total))


def _topk_mask_flat(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Keep the k largest entries of a 1-D score vector; every entry tied
    with the k-th is kept too (``scores >= kth``)."""
    kth = torch.topk(scores, k).values[-1]
    return scores >= kth


def _zero_outside(w: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return torch.where(mask, w, torch.zeros((), dtype=w.dtype,
                                            device=w.device))


def project_irregular(w: torch.Tensor, *, alpha: float) -> torch.Tensor:
    """Keep the floor(alpha * numel) largest-magnitude entries of ``w``."""
    flat = w.reshape(-1).abs()
    mask = _topk_mask_flat(flat, _keep_count(flat.shape[0], alpha))
    return _zero_outside(w, mask.reshape(w.shape))


def project_filter(w: torch.Tensor, *, alpha: float) -> torch.Tensor:
    """Keep the floor(alpha * P) rows (filters) of largest squared norm."""
    if w.ndim != 2:
        return project_filter(w.reshape(w.shape[0], -1),
                              alpha=alpha).reshape(w.shape)
    scores = w.to(torch.float32).square().sum(dim=1)
    mask = _topk_mask_flat(scores, _keep_count(w.shape[0], alpha))
    return _zero_outside(w, mask[:, None])


def project_column(w: torch.Tensor, *, alpha: float,
                   group: int = 1) -> torch.Tensor:
    """Keep the floor(alpha * Q / group) column groups of largest squared
    norm; ``group > 1`` prunes aligned blocks of columns together."""
    if w.ndim != 2:
        return project_column(w.reshape(w.shape[0], -1), alpha=alpha,
                              group=group).reshape(w.shape)
    P, Q = w.shape
    if Q % group:
        raise ValueError(f"Q={Q} not divisible by group={group}")
    g = Q // group
    scores = w.to(torch.float32).square().reshape(P, g, group).sum(
        dim=(0, 2))
    mask = _topk_mask_flat(scores, _keep_count(g, alpha))
    return _zero_outside(w, mask.repeat_interleave(group)[None, :])


def project_kernel_pattern(w4: torch.Tensor, *, keep: int = 4
                           ) -> torch.Tensor:
    """Keep the ``keep`` largest-magnitude entries of each C x D kernel
    (ties with the keep-th kept)."""
    A, B, C, D = w4.shape
    flat = w4.to(torch.float32).abs().reshape(A, B, C * D)
    kth = torch.topk(flat, keep, dim=-1).values[..., -1]
    return _zero_outside(w4, (flat >= kth[..., None]).reshape(w4.shape))


def canonical_patterns_3x3(num: int = 8) -> torch.Tensor:
    """The fixed library of 4-entry 3x3 patterns, (num, 9) bool.

    Flat tap layout ``0 1 2 / 3 4 5 / 6 7 8``; the centre (4) is always
    kept. The port's own copy of the reference's list, in its order.
    """
    candidates = (
        (0, 1, 3, 4), (1, 2, 4, 5), (3, 4, 6, 7), (4, 5, 7, 8),
        (1, 3, 4, 5), (1, 4, 5, 7), (3, 4, 5, 7), (1, 3, 4, 7),
        (0, 2, 4, 6), (2, 4, 6, 8), (0, 4, 6, 8), (0, 2, 4, 8),
    )
    pats = torch.zeros((len(candidates), 9), dtype=torch.bool)
    for i, idx in enumerate(candidates):
        pats[i, list(idx)] = True
    return pats[:num]


def pattern_library(patterns: Optional[torch.Tensor], device
                    ) -> torch.Tensor:
    """``patterns`` (default: ``canonical_patterns_3x3()``) as a bool
    tensor on ``device``."""
    if patterns is None:
        patterns = canonical_patterns_3x3()
    return torch.as_tensor(patterns, dtype=torch.bool, device=device)


def project_kernel_pattern_library(
        w4: torch.Tensor, patterns: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Project each 3x3 kernel onto its best library pattern (most energy
    kept; ties to the first pattern). Returns ``(projected, pattern_ids)``."""
    pats = pattern_library(patterns, w4.device)
    A, B, C, D = w4.shape
    sq = w4.to(torch.float32).square().reshape(A, B, C * D)
    energy = torch.einsum("abe,pe->abp", sq, pats.to(torch.float32))
    pat_id = torch.argmax(energy, dim=-1)                    # (A, B)
    mask = pats[pat_id].reshape(w4.shape)
    return _zero_outside(w4, mask), pat_id


def project_channel_pattern(w4: torch.Tensor,
                            patterns: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """Channel-shared library patterns: every filter keeps input channel
    c's taps, the pattern of most energy summed over all filters."""
    pats = pattern_library(patterns, w4.device)
    A, B, C, D = w4.shape
    sq = w4.to(torch.float32).square().reshape(A, B, C * D).sum(dim=0)
    energy = sq @ pats.to(torch.float32).T                   # (B, n_pat)
    pat_id = torch.argmax(energy, dim=-1)                    # (B,)
    mask = pats[pat_id].reshape(1, B, C, D)
    return _zero_outside(w4, mask)


def project_connectivity(w4: torch.Tensor, *, alpha: float,
                         pattern_keep: int = 4) -> torch.Tensor:
    """Keep the floor((C*D / pattern_keep) * alpha * A * B) kernels of
    largest norm: after kernel patterns removed (1 - keep/CD) of the
    weights, this brings the total remaining ratio down to alpha."""
    A, B, C, D = w4.shape
    scores = w4.to(torch.float32).square().reshape(A, B, -1).sum(
        dim=-1).reshape(-1)
    factor = (C * D) / pattern_keep
    k = _keep_count(A * B, min(1.0, factor * alpha))
    mask = _topk_mask_flat(scores, k).reshape(A, B)
    return _zero_outside(w4, mask[:, :, None, None])


def project_tile_pattern(w: torch.Tensor, *, block_p: int = 128,
                         group_q: int = 8, keep: int = 4) -> torch.Tensor:
    """Shared keep-of-``group_q`` lane pattern per (block_p x group_q) tile.

    ``w`` is in the paper's GEMM view (P = out rows, Q = in columns).
    Within each tile the ``keep`` lanes of largest fp32 energy, summed
    over the tile's ``block_p`` rows, survive for every row.

    Exactly ``keep`` lanes survive, an energy tie going to the lower lane:
    the lanes ``pack_tile_pattern`` stores, so the packed form is always
    exactly the pruned weight. The reference keeps every lane tied with
    the keep-th energy (``energy >= kth``) and its packer then drops the
    surplus, so its packed model differs from its dense pruned one where
    lane energies tie exactly; away from ties the two projections agree.
    """
    if w.ndim != 2:
        return project_tile_pattern(w.reshape(w.shape[0], -1),
                                    block_p=block_p, group_q=group_q,
                                    keep=keep).reshape(w.shape)
    P, Q = w.shape
    if P % block_p or Q % group_q:
        raise ValueError(f"(P={P}, Q={Q}) not divisible by "
                         f"(block_p={block_p}, group_q={group_q})")
    nb, ng = P // block_p, Q // group_q
    energy = w.to(torch.float32).square().reshape(
        nb, block_p, ng, group_q).sum(dim=1)              # (nb, ng, gq)
    top = torch.argsort(-energy, dim=-1, stable=True)[..., :keep]
    lane_mask = torch.zeros_like(energy, dtype=torch.bool).scatter_(
        -1, top, True)
    mask = lane_mask[:, None].expand(nb, block_p, ng, group_q).reshape(P, Q)
    return _zero_outside(w, mask)


def project(w: torch.Tensor, scheme: str, *, alpha: float,
            conv_shape: Optional[Tuple[int, int, int, int]] = None,
            **kw) -> torch.Tensor:
    """Project ``w`` onto the set of ``scheme``.

    ``conv_shape`` reinterprets a GEMM matrix as a conv tensor for the
    kernel-level schemes. ``pattern`` is kernel pattern then connectivity,
    in sequence (paper section IV-D-4); ``pattern_shared`` is the
    channel-shared library pattern then connectivity, the composition
    ``sparse.registry`` packs. Kernels of at most ``keep`` taps (1x1
    projections) get connectivity pruning alone, at the full rate.
    """
    if scheme == "irregular":
        return project_irregular(w, alpha=alpha)
    if scheme == "filter":
        return project_filter(w, alpha=alpha)
    if scheme == "column":
        return project_column(w, alpha=alpha, **kw)
    if scheme in KERNEL_SCHEMES:
        w4 = w.reshape(conv_shape) if conv_shape is not None else w
        if w4.ndim != 4:
            raise ValueError(f"scheme '{scheme}' needs a 4-D conv tensor")
        keep = kw.pop("keep", 4)
        taps = w4.shape[2] * w4.shape[3]
        if taps <= keep:
            return project_connectivity(w4, alpha=alpha,
                                        pattern_keep=taps).reshape(w.shape)
        if scheme == "kernel_pattern":
            out = project_kernel_pattern(w4, keep=keep)
        elif scheme == "connectivity":
            out = project_connectivity(w4, alpha=alpha, pattern_keep=keep)
        elif scheme == "pattern_shared":
            out = project_connectivity(project_channel_pattern(w4),
                                       alpha=alpha, pattern_keep=keep)
        else:
            out = project_connectivity(project_kernel_pattern(w4, keep=keep),
                                       alpha=alpha, pattern_keep=keep)
        return out.reshape(w.shape)
    if scheme == "tile_pattern":
        return project_tile_pattern(w, **kw)
    raise ValueError(f"unknown pruning scheme '{scheme}'")


SCHEMES = ("irregular", "filter", "column", "pattern", "pattern_shared",
           "tile_pattern")
