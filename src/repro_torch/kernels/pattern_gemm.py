"""Tile-pattern sparse GEMM: packers, the Hopper kernel's wrapper and its
plain PyTorch version (mirrors ``repro/kernels/pattern_gemm.py``).

The weight W (Q=in, P=out) keeps ``keep`` of every ``group_q`` input lanes,
the same lanes for all ``block_p`` columns of an output panel. Packed, it
is ``w_packed`` (nb, Kp, block_p) — one contiguous panel per output block —
and ``lane_idx`` (nb, Kp) int32, the source row of x for each packed row:

    y[:, panel j] = act(x[:, lane_idx[j]] @ w_packed[j] + bias[panel j])

``pattern_gemm`` launches ``csrc/pattern_gemm.cu`` for CUDA tensors (the
variant ``tiled_variant`` names) and runs ``pattern_gemm_ref`` for CPU
tensors; it never falls back from one to the other.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.epilogue import ACT_CODES, apply_epilogue, check_activation
from repro_torch.kernels.sm90 import BLOCK_K, SKINNY_M, VARIANTS, wgmma_plan

# launches of the CUDA kernel since the last reset (plain int; the smoke
# run zeroes it around the served path), and per route
LAUNCHES = 0
ROUTE_LAUNCHES = dict.fromkeys(VARIANTS, 0)

BLOCK_PS = (32, 64, 128)
_DTYPES = (torch.float32, torch.bfloat16)


def skinny_ksplit(M: int, nb: int, Kp: int, bp: int, sm_count: int) -> int:
    """How many slices of the packed K rows the decode variant uses: enough
    blocks for about two per SM, no slice shorter than 128 rows."""
    if M > SKINNY_M:
        return 1
    blocks = nb * max(1, bp // 64)
    return max(1, min(-(-2 * sm_count // blocks), Kp // 128))


def tiled_variant(M: int, Q: int, Kp: int, dtype: torch.dtype,
                  aligned: bool = True) -> str:
    """The device kernel a CUDA call with x (M, Q) and Kp packed rows
    launches: ``skinny`` (M <= 16, decode), ``simt`` (fp32), ``wgmma``
    (bf16 whose x and lane_idx rows TMA can address: Q % 8 == 0,
    Kp % 4 == 0, 16-byte ``aligned`` base pointers) or ``wmma`` (any other
    bf16 call)."""
    if M <= SKINNY_M:
        return "skinny"
    if dtype != torch.bfloat16:
        return "simt"
    if Q % 8 or Kp % 4 or not aligned:
        return "wmma"
    return "wgmma"


def pack_tile_pattern(w: torch.Tensor, *, block_p: int = 128,
                      group_q: int = 8, keep: int = 4
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pack a tile-pattern-pruned W (Q, P) -> (w_packed (Kp, P), lane_idx).

    Selects, per (group, panel), the ``keep`` lanes of largest fp32 energy
    — the lanes of ``np.sort(np.argsort(-energy)[:keep])`` in the
    reference, ties going to the lower lane — for all panels and groups at
    once. Values are copied, never rounded.
    """
    wpb, lane_idx = pack_tile_pattern_blocked(w, block_p=block_p,
                                              group_q=group_q, keep=keep)
    nb, Kp, bp = wpb.shape
    return wpb.permute(1, 0, 2).reshape(Kp, nb * bp), lane_idx


def pack_tile_pattern_blocked(w: torch.Tensor, *, block_p: int = 128,
                              group_q: int = 8, keep: int = 4
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pack into the blocked kernel layout: (nb, Kp, block_p), lane_idx."""
    Q, P = w.shape
    if Q % group_q or P % block_p:
        raise ValueError(f"(Q={Q}, P={P}) not tiled by ({group_q}, {block_p})")
    ng, nb = Q // group_q, P // block_p
    energy = w.to(torch.float32).square().reshape(
        ng, group_q, nb, block_p).sum(dim=3)               # (ng, gq, nb)
    order = torch.argsort(-energy, dim=1, stable=True)[:, :keep]
    lanes = torch.sort(order, dim=1).values                # (ng, keep, nb)
    rows = lanes + (torch.arange(ng, device=w.device) * group_q)[:, None, None]
    lane_idx = rows.permute(2, 0, 1).reshape(nb, ng * keep)
    panels = w.reshape(Q, nb, block_p).permute(1, 0, 2)    # (nb, Q, bp)
    wpb = torch.gather(panels, 1, lane_idx[:, :, None].expand(
        nb, ng * keep, block_p))
    return wpb.contiguous(), lane_idx.to(torch.int32).contiguous()


def pattern_gemm_ref(x: torch.Tensor, w_packed: torch.Tensor,
                     lane_idx: torch.Tensor,
                     bias: Optional[torch.Tensor] = None, *,
                     activation: Optional[str] = None) -> torch.Tensor:
    """Plain version: gather, fp32 matmul per panel, epilogue, cast.

    Panels go in slices, so the gathered copy of x stays bounded at the
    LM head's 1187 panels.
    """
    check_activation(activation)
    M = x.shape[0]
    nb, Kp, bp = w_packed.shape
    xf = x.to(torch.float32)
    y = torch.empty((M, nb, bp), dtype=torch.float32, device=x.device)
    step = max(1, (1 << 26) // max(1, M * Kp))
    for j0 in range(0, nb, step):
        li = lane_idx[j0:j0 + step].long()                 # (n, Kp)
        xg = xf[:, li]                                     # (M, n, Kp)
        y[:, j0:j0 + step] = torch.einsum(
            "mnk,nkb->mnb", xg, w_packed[j0:j0 + step].to(torch.float32))
    y = apply_epilogue(y.reshape(M, nb * bp), bias, activation)
    return y.to(x.dtype)


def pattern_gemm(x: torch.Tensor, w_packed: torch.Tensor,
                 lane_idx: torch.Tensor,
                 bias: Optional[torch.Tensor] = None, *,
                 activation: Optional[str] = None) -> torch.Tensor:
    """y = act(x @ W + bias) for x (M, Q) and a blocked packed W.

    CPU tensors run ``pattern_gemm_ref``; CUDA tensors launch the kernel
    ``tiled_variant`` names, which takes any M, bf16 or fp32 (all operands
    one dtype, lane_idx int32), block_p in {32, 64, 128}, and contiguous
    operands.
    """
    check_activation(activation)
    if x.ndim != 2 or w_packed.ndim != 3:
        raise ValueError(f"want x (M, Q) and w_packed (nb, Kp, bp); got "
                         f"{tuple(x.shape)}, {tuple(w_packed.shape)}")
    M, Q = x.shape
    nb, Kp, bp = w_packed.shape
    if tuple(lane_idx.shape) != (nb, Kp):
        raise ValueError(f"lane_idx {tuple(lane_idx.shape)} != {(nb, Kp)}")
    if bias is not None and tuple(bias.shape) != (nb * bp,):
        raise ValueError(f"bias {tuple(bias.shape)} != {(nb * bp,)}")
    if x.device.type == "cpu":
        return pattern_gemm_ref(x, w_packed, lane_idx, bias,
                                activation=activation)
    if x.device.type != "cuda":
        raise ValueError(f"pattern_gemm: unsupported device {x.device}")
    operands = [w_packed, lane_idx] + ([bias] if bias is not None else [])
    if any(t.device != x.device for t in operands):
        raise ValueError("pattern_gemm: operands on different devices")
    if x.dtype not in _DTYPES or w_packed.dtype != x.dtype or (
            bias is not None and bias.dtype != x.dtype):
        raise TypeError(f"pattern_gemm: x {x.dtype}, w {w_packed.dtype}, "
                        f"bias {None if bias is None else bias.dtype}; want "
                        "one of float32/bfloat16 throughout")
    if lane_idx.dtype != torch.int32:
        raise TypeError(f"lane_idx must be int32, got {lane_idx.dtype}")
    if bp not in BLOCK_PS:
        raise ValueError(f"block_p {bp} not in {BLOCK_PS}")
    if not all(t.is_contiguous() for t in [x] + operands):
        raise ValueError("pattern_gemm: operands must be contiguous")
    if w_packed.data_ptr() % 16:
        raise ValueError("pattern_gemm: w_packed must be 16-byte aligned")
    return _launch(x, w_packed, lane_idx, bias, activation, tiled_variant(
        M, Q, Kp, x.dtype, aligned=all(t.data_ptr() % 16 == 0
                                       for t in (x, lane_idx))))


def _launch(x: torch.Tensor, w_packed: torch.Tensor, lane_idx: torch.Tensor,
            bias: Optional[torch.Tensor], activation: Optional[str],
            variant: str) -> torch.Tensor:
    """Launch the device kernel ``variant`` on checked CUDA operands; the C
    entry point refuses a variant that does not take the call. Callers
    other than ``pattern_gemm`` only hold one variant against another."""
    if variant not in VARIANTS:
        raise ValueError(f"pattern_gemm: unknown variant {variant!r}")
    M, Q = x.shape
    nb, Kp, bp = w_packed.shape
    out = torch.empty((M, nb * bp), dtype=x.dtype, device=x.device)
    if M == 0:
        return out
    sm_count = torch.cuda.get_device_properties(x.device).multi_processor_count
    block_m, ksplit = 0, 1
    if variant == "skinny":
        ksplit = skinny_ksplit(M, nb, Kp, bp, sm_count)
    elif variant == "wgmma":
        block_m, ksplit = wgmma_plan(M, nb, -(-Kp // BLOCK_K), sm_count)
    ws = (torch.empty((ksplit, M, nb * bp), dtype=torch.float32,
                      device=x.device) if ksplit > 1 else None)
    _build.launch(
        "pattern_gemm", x.data_ptr(), w_packed.data_ptr(),
        lane_idx.data_ptr(), bias.data_ptr() if bias is not None else None,
        out.data_ptr(), ws.data_ptr() if ws is not None else None, M, Q, nb,
        Kp, bp, ksplit, VARIANTS[variant], block_m,
        int(x.dtype == torch.bfloat16), ACT_CODES[activation],
        torch.cuda.current_stream(x.device).cuda_stream)
    global LAUNCHES
    LAUNCHES += 1
    ROUTE_LAUNCHES[variant] += 1
    return out
