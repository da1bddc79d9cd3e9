"""Column-pruned GEMM: the packer, the Hopper kernel's wrapper and its plain
PyTorch version (mirrors ``repro/kernels/column_gemm.py``).

Column pruning removes whole contraction rows of the weight W (Q=in, P=out),
the same rows for every output column. Packed, W is ``w_packed`` (K, P),
the surviving rows in the reference's row-major layout, and ``kept_idx``
(K,) int32, the row of x each packed row reads:

    y = act(x[:, kept_idx] @ w_packed + bias)

``column_gemm`` launches ``csrc/column_gemm.cu`` for CUDA tensors (the
variant ``tiled_variant`` names) and runs ``column_gemm_ref`` for CPU
tensors; it never falls back from one to the other. Its bf16 ``wgmma``
variant first gathers ``x[:, kept_idx]`` once into a scratch buffer, as
the reference gathers outside its kernel, then runs a dense product.
``block_m`` and ``grid_order`` re-tile that variant's grid
(``kernels/sm90.py``), as a tuned plan asks; the other variants and the
plain version ignore them.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.epilogue import ACT_CODES, apply_epilogue, check_activation
from repro_torch.kernels.sm90 import (
    BLOCK_K,
    GRID_ORDERS,
    SKINNY_M,
    VARIANTS,
    check_grid,
    wgmma_plan,
)

# launches of the CUDA kernel since the last reset (plain int; the smoke
# run zeroes it around each driven path)
LAUNCHES = 0

_DTYPES = (torch.float32, torch.bfloat16)
SKINNY_COLS = 64           # output columns per block of the decode variant


def skinny_ksplit(M: int, K: int, P: int, sm_count: int) -> int:
    """How many slices of the K packed rows the decode variant uses: enough
    blocks for about two per SM, no slice shorter than 128 rows."""
    if M > SKINNY_M:
        return 1
    blocks = -(-P // SKINNY_COLS)
    return max(1, min(-(-2 * sm_count // blocks), K // 128))


def tiled_variant(M: int, K: int, P: int, dtype: torch.dtype) -> str:
    """The device kernel a CUDA call with M rows and w_packed (K, P)
    launches: ``skinny`` (M <= 16, decode), ``simt`` (fp32), ``wgmma``
    (bf16 whose w_packed rows TMA can address: K > 0, P % 8 == 0) or
    ``wmma`` (any other bf16 call)."""
    if M <= SKINNY_M:
        return "skinny"
    if dtype != torch.bfloat16:
        return "simt"
    if K == 0 or P % 8:
        return "wmma"
    return "wgmma"


def pack_columns(w: torch.Tensor, *, group: int = 1
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pack a column-pruned W (Q, P) -> (w_packed (K, P), kept_idx (K,)).

    Row q survives if any of its entries is nonzero; ``group > 1`` keeps
    whole aligned groups of rows. Values are copied, never rounded."""
    alive = (w != 0).any(dim=1)                             # (Q,)
    if group > 1:
        alive = alive.reshape(-1, group).any(dim=1).repeat_interleave(group)
    kept = torch.nonzero(alive).reshape(-1).to(torch.int32)
    return w[kept.long()].contiguous(), kept


def column_gemm_ref(x: torch.Tensor, w_packed: torch.Tensor,
                    kept_idx: torch.Tensor,
                    bias: Optional[torch.Tensor] = None, *,
                    activation: Optional[str] = None) -> torch.Tensor:
    """Plain version: gather the kept columns, fp32 matmul, epilogue, cast."""
    check_activation(activation)
    xg = x[:, kept_idx.long()].to(torch.float32)
    y = apply_epilogue(xg @ w_packed.to(torch.float32), bias, activation)
    return y.to(x.dtype)


def column_gemm(x: torch.Tensor, w_packed: torch.Tensor,
                kept_idx: torch.Tensor, bias: Optional[torch.Tensor] = None,
                *, activation: Optional[str] = None, block_m: int = 0,
                grid_order: Optional[str] = None) -> torch.Tensor:
    """y = act(x @ W + bias) for x (M, Q) and a column-packed W.

    CPU tensors run ``column_gemm_ref``; CUDA tensors launch the kernel
    ``tiled_variant`` names, which takes any M, K and P, bf16 or fp32 (x,
    w_packed and bias one dtype, kept_idx int32), and contiguous operands.
    ``block_m`` / ``grid_order``: the wgmma variant's row tile and grid
    order (default: ``wgmma_plan``'s, row tiles fastest).
    """
    check_activation(activation)
    check_grid(block_m, grid_order)
    if x.ndim != 2 or w_packed.ndim != 2:
        raise ValueError(f"want x (M, Q) and w_packed (K, P); got "
                         f"{tuple(x.shape)}, {tuple(w_packed.shape)}")
    M, Q = x.shape
    K, P = w_packed.shape
    if tuple(kept_idx.shape) != (K,):
        raise ValueError(f"kept_idx {tuple(kept_idx.shape)} != {(K,)}")
    if bias is not None and tuple(bias.shape) != (P,):
        raise ValueError(f"bias {tuple(bias.shape)} != {(P,)}")
    if x.device.type == "cpu":
        return column_gemm_ref(x, w_packed, kept_idx, bias,
                               activation=activation)
    if x.device.type != "cuda":
        raise ValueError(f"column_gemm: unsupported device {x.device}")
    operands = [w_packed, kept_idx] + ([bias] if bias is not None else [])
    if any(t.device != x.device for t in operands):
        raise ValueError("column_gemm: operands on different devices")
    if x.dtype not in _DTYPES or w_packed.dtype != x.dtype or (
            bias is not None and bias.dtype != x.dtype):
        raise TypeError(f"column_gemm: x {x.dtype}, w {w_packed.dtype}, "
                        f"bias {None if bias is None else bias.dtype}; want "
                        "one of float32/bfloat16 throughout")
    if kept_idx.dtype != torch.int32:
        raise TypeError(f"kept_idx must be int32, got {kept_idx.dtype}")
    if not all(t.is_contiguous() for t in [x] + operands):
        raise ValueError("column_gemm: operands must be contiguous")
    if w_packed.data_ptr() % 16:
        raise ValueError("column_gemm: w_packed must be 16-byte aligned")
    return _launch(x, w_packed, kept_idx, bias, activation,
                   tiled_variant(M, K, P, x.dtype), block_m=block_m,
                   grid_order=grid_order)


def _launch(x: torch.Tensor, w_packed: torch.Tensor, kept_idx: torch.Tensor,
            bias: Optional[torch.Tensor], activation: Optional[str],
            variant: str, *, block_m: int = 0,
            grid_order: Optional[str] = None) -> torch.Tensor:
    """Launch the device kernel ``variant`` on checked CUDA operands; the C
    entry point refuses a variant that does not take the call. Callers
    other than ``column_gemm`` only hold one variant against another.
    ``block_m`` / ``grid_order`` re-tile the wgmma variant only; its K
    split is ``wgmma_plan``'s whatever the row tile."""
    if variant not in VARIANTS:
        raise ValueError(f"column_gemm: unknown variant {variant!r}")
    M, Q = x.shape
    K, P = w_packed.shape
    out = torch.empty((M, P), dtype=x.dtype, device=x.device)
    if M == 0 or P == 0:
        return out
    sm_count = torch.cuda.get_device_properties(x.device).multi_processor_count
    bm, ksplit, xg = 0, 1, None
    if variant == "skinny":
        ksplit = skinny_ksplit(M, K, P, sm_count)
    elif variant == "wgmma":
        bm, ksplit = wgmma_plan(M, -(-P // 128), -(-K // BLOCK_K), sm_count)
        bm = block_m or bm
        xg = torch.empty((M, -(-K // 8) * 8), dtype=x.dtype, device=x.device)
    ws = (torch.empty((ksplit, M, P), dtype=torch.float32, device=x.device)
          if ksplit > 1 else None)
    _build.launch(
        "column_gemm", x.data_ptr(), w_packed.data_ptr(), kept_idx.data_ptr(),
        bias.data_ptr() if bias is not None else None, out.data_ptr(),
        ws.data_ptr() if ws is not None else None,
        xg.data_ptr() if xg is not None else None, M, Q, K, P, ksplit,
        VARIANTS[variant], bm, GRID_ORDERS[grid_order or "pm"],
        int(x.dtype == torch.bfloat16), ACT_CODES[activation],
        torch.cuda.current_stream(x.device).cuda_stream)
    global LAUNCHES
    LAUNCHES += 1
    return out
