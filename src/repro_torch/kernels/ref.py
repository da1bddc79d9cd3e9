"""fp32 oracles for the kernels (mirrors ``repro/kernels/ref.py``)."""

from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def ref_gemm(x: torch.Tensor, w_dense: torch.Tensor) -> torch.Tensor:
    """y = x @ W with the (pruned, still-dense) weight matrix (Q, P)."""
    return (x.to(torch.float32) @ w_dense.to(torch.float32)).to(x.dtype)


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
