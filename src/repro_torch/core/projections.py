"""Euclidean projections onto the sparsity sets (``repro/core/projections.py``).

Only the tile-pattern projection is ported so far.
"""

from __future__ import annotations

import torch


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
    return torch.where(mask, w, torch.zeros((), dtype=w.dtype,
                                            device=w.device))
