"""Flash attention forward: the Hopper kernel's wrapper and its plain
PyTorch version (mirrors ``repro/kernels/flash_attention.py``).

q (B, S, H, hd), k/v (B, S, KV, hd) with H a multiple of KV (query head h
reads KV head h // (H // KV)); causal and/or sliding-window masking; fp32
online softmax. ``flash_attention`` launches ``csrc/flash_attention.cu``
for CUDA tensors (the route ``flash_variant`` names, its grid from
``flash_plan``) and runs ``flash_attention_ref`` for CPU tensors; it never
falls back from one to the other.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import ref_attention
from repro_torch.kernels.sm90 import VARIANTS

LAUNCHES = 0

HEAD_DIMS = (32, 64, 80, 128)
# hd 80 runs the HD = 128 wgmma instance on 80-column maps (TMA zero-fills
# the rest)
WGMMA_HEAD_DIMS = (64, 80, 128)
FLASH_ROUTES = ("wgmma", "simt")
# launches per route (plain ints)
ROUTE_LAUNCHES = dict.fromkeys(FLASH_ROUTES, 0)
_DTYPES = (torch.float32, torch.bfloat16)


def flash_variant(S: int, hd: int, dtype: torch.dtype,
                  window: Optional[int] = None, causal: bool = True,
                  aligned: bool = True) -> str:
    """The device kernel a CUDA call launches: ``wgmma`` (bf16, hd 64, 80
    or 128, 16-byte ``aligned`` base pointers) or ``simt`` (fp32, whose
    tensor-core form would be TF32 and miss the 2e-5 tolerance, and any
    other head dim). The wgmma kernel takes every S (TMA zero-fills the
    ragged edge), causal or not, with or without a sliding ``window``, so
    neither moves a call off it."""
    if dtype == torch.bfloat16 and hd in WGMMA_HEAD_DIMS and aligned:
        return "wgmma"
    return "simt"


def flash_plan(B: int, S: int, H: int, sm_count: int) -> int:
    """Query rows per block of the wgmma kernel: 128 (two consumer
    warpgroups sharing each K/V tile) when that grid still gives every SM
    a block, else 64 (S = 128 at B 4, H 12: 48 blocks of 128 rows, 96 of
    64)."""
    return 128 if B * H * -(-S // 128) >= sm_count else 64


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
    aligned = all(t.data_ptr() % 16 == 0 for t in (q, k, v))
    return _launch(q, k, v, causal, window, softmax_scale, flash_variant(
        S, hd, q.dtype, window, causal, aligned=aligned))


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            causal: bool, window: Optional[int],
            softmax_scale: Optional[float], variant: str) -> torch.Tensor:
    """Launch the device kernel ``variant`` on checked CUDA operands; the C
    entry point refuses a variant that does not take the call. Callers
    other than ``flash_attention`` only hold one route against another."""
    if variant not in FLASH_ROUTES:
        raise ValueError(f"flash_attention: unknown variant {variant!r}")
    B, S, H, hd = q.shape
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(hd)
    block_q = 0
    if variant == "wgmma":
        block_q = flash_plan(B, S, H, torch.cuda.get_device_properties(
            q.device).multi_processor_count)
    out = torch.empty_like(q)
    _build.launch(
        "flash_attention", q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), B, S, H, k.shape[2], hd, float(scale), int(causal),
        int(window or 0), int(q.dtype == torch.bfloat16), VARIANTS[variant],
        block_q, torch.cuda.current_stream(q.device).cuda_stream)
    global LAUNCHES
    LAUNCHES += 1
    ROUTE_LAUNCHES[variant] += 1
    return out
