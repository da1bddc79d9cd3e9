"""fp32 oracles for the kernels (mirrors ``repro/kernels/ref.py``)."""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def ref_gemm(x: torch.Tensor, w_dense: torch.Tensor) -> torch.Tensor:
    """y = x @ W with the (pruned, still-dense) weight matrix (Q, P)."""
    return (x.to(torch.float32) @ w_dense.to(torch.float32)).to(x.dtype)


ref_pattern_gemm = ref_gemm
ref_column_gemm = ref_gemm


def ref_conv3x3(x: torch.Tensor, w4_pruned: torch.Tensor) -> torch.Tensor:
    """Dense stride-1 SAME conv in fp32 with the (pruned, still-dense)
    weight: x (B, H, W, C) NHWC, w (A, C, 3, 3) OIHW -> (B, H, W, A)."""
    y = F.conv2d(x.to(torch.float32).permute(0, 3, 1, 2),
                 w4_pruned.to(torch.float32), padding=1)
    return y.permute(0, 2, 3, 1).contiguous().to(x.dtype)


def mask_channel_patterns(w4: torch.Tensor, pat_ids: torch.Tensor,
                          patterns: torch.Tensor) -> torch.Tensor:
    """Zero w4 (A, C, 3, 3) outside each channel's library pattern."""
    pats = torch.as_tensor(patterns, dtype=torch.bool, device=w4.device)
    mask = pats[torch.as_tensor(pat_ids, device=w4.device).long()]
    return torch.where(mask.reshape(1, w4.shape[1], 3, 3), w4,
                       torch.zeros((), dtype=w4.dtype, device=w4.device))


def ref_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: Optional[int] = None,
                  scale: Optional[float] = None) -> torch.Tensor:
    """Dense masked-softmax attention in fp32, GQA-aware.

    q (B, S, H, hd); k, v (B, S, KV, hd); returns (B, S, H, hd) in q.dtype.
    """
    B, S, H, hd = q.shape
    G = H // k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    kf = k.to(torch.float32).repeat_interleave(G, dim=2)
    vf = v.to(torch.float32).repeat_interleave(G, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32), kf) * scale
    pos = torch.arange(S, device=q.device)
    ok = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        ok &= pos[:, None] >= pos[None, :]
    if window is not None:
        ok &= pos[:, None] - pos[None, :] < window
    s = torch.where(ok, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, vf).to(q.dtype)
