"""Flash attention forward: the Hopper kernel's wrapper and its plain
PyTorch version (mirrors ``repro/kernels/flash_attention.py``).

q (B, S, H, hd), k/v (B, S, KV, hd) with H a multiple of KV (query head h
reads KV head h // (H // KV)); causal and/or sliding-window masking; fp32
online softmax. ``flash_attention`` launches ``csrc/flash_attention.cu``
for CUDA tensors and runs ``flash_attention_ref`` for CPU tensors.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import ref_attention

LAUNCHES = 0

HEAD_DIMS = (32, 64, 128)
_DTYPES = (torch.float32, torch.bfloat16)


def flash_attention_ref(q, k, v, *, causal: bool = True,
                        window: Optional[int] = None,
                        softmax_scale: Optional[float] = None):
    """Plain version: dense masked softmax in fp32."""
    return ref_attention(q, k, v, causal=causal, window=window,
                         scale=softmax_scale)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    softmax_scale: Optional[float] = None) -> torch.Tensor:
    """Attention forward over (B, S, H, hd) q and (B, S, KV, hd) k/v."""
    if q.ndim != 4 or k.shape != v.shape or k.ndim != 4:
        raise ValueError(f"bad shapes q {tuple(q.shape)}, k {tuple(k.shape)},"
                         f" v {tuple(v.shape)}")
    B, S, H, hd = q.shape
    KV = k.shape[2]
    if k.shape[0] != B or k.shape[1] != S or k.shape[3] != hd or H % KV:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}")
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   softmax_scale=softmax_scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: operands on different devices")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: dtypes {q.dtype}, {k.dtype}, "
                        f"{v.dtype}; want one of float32/bfloat16")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: operands must be contiguous")
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(hd)
    out = torch.empty_like(q)
    _build.launch(
        "flash_attention", q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), B, S, H, KV, hd, float(scale), int(causal),
        int(window or 0), int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream)
    global LAUNCHES
    LAUNCHES += 1
    return out
