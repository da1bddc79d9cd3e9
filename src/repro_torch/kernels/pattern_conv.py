"""Pattern-pruned 3x3 convolution: packers, the Hopper kernel's wrapper and
its plain PyTorch version (mirrors ``repro/kernels/pattern_conv.py``).

Every filter of input channel c keeps the same 4 of the 9 taps (a library
pattern shared over the filters). Packed, the conv weight (A, C, 3, 3) is

    w_packed (4C, A)   w_packed[c*4 + j, a] = w[a, c, taps[c, j] // 3,
                                                      taps[c, j] % 3]
    taps     (C, 4)    int32 flat tap index (0..8) kept for channel c

and the stride-1 SAME conv is ``act(xg @ w_packed + bias)`` with xg the
(B*H*W, 4C) matrix of each pixel's kept taps, channel-major (``c*4 + j``).
``pattern_conv`` launches ``csrc/pattern_conv.cu`` for CUDA tensors (the
route ``conv_variant`` names, the wgmma route's tiles from ``conv_plan``),
which never builds xg (the tap gather happens as the A operand is loaded),
and runs ``pattern_conv_ref`` for CPU tensors; it never falls back from
one to the other. Activations are NHWC, as in the reference.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.projections import pattern_library
from repro_torch.kernels import _build
from repro_torch.kernels.epilogue import ACT_CODES, apply_epilogue, check_activation
from repro_torch.kernels.sm90 import VARIANTS

# launches of the CUDA kernel since the last reset (plain int; the smoke
# run zeroes it around each driven path)
LAUNCHES = 0

_DTYPES = (torch.float32, torch.bfloat16)
CONV_ROUTES = ("wgmma", "wmma", "simt")
# launches per route (plain ints, counted with LAUNCHES)
ROUTE_LAUNCHES = dict.fromkeys(CONV_ROUTES, 0)
# the wgmma route's tiles (csrc/pattern_conv.cu, namespace pc90)
STAGE_CHANNELS = 16        # input channels per ring stage: C % this == 0
BLOCK_PIXELS = 128         # output pixels per tile (two warpgroups)
HALO_PIXELS = 512          # halo pixels a stage may hold
CHANNEL_TILES = (64, 128, 256)


def conv_variant(C: int, A: int, dtype: torch.dtype) -> str:
    """The device kernel a CUDA call with C input and A output channels
    launches: ``wgmma`` (bf16 whose x TMA can cut into 16-channel halo
    boxes and whose w_packed and out rows it can address: C % 16 == 0,
    A % 8 == 0), ``wmma`` (any other bf16 call: the C = 3 first conv of
    VGG-16 and the ResNet-18 stem) or ``simt`` (fp32)."""
    if dtype != torch.bfloat16:
        return "simt"
    if C % STAGE_CHANNELS or A % 8:
        return "wmma"
    return "wgmma"


@lru_cache(maxsize=None)
def conv_plan(B: int, H: int, W: int, A: int,
              sm_count: int) -> Tuple[int, int, int, int]:
    """(TH, TW, NIMG, BN) of the wgmma route: each tile is a patch of
    TH x TW pixels in NIMG images (at most BLOCK_PIXELS, its halo at most
    HALO_PIXELS) times BN output channels.

    The patch is the one that covers the batch in the fewest tiles, ties
    to the smallest halo (224 x 224: 16 x 8; 28 x 28: 4 x 4 in eight
    images). BN covers A in one tile where it can (up to 256), so each
    halo is read from device memory once; it halves while the tiles would
    leave an SM without one.
    """
    best = None
    for tw in range(1, min(W, BLOCK_PIXELS) + 1):
        for th in range(1, min(H, BLOCK_PIXELS // tw) + 1):
            halo = (th + 2) * (tw + 2)
            nimg = min(B, BLOCK_PIXELS // (tw * th), HALO_PIXELS // halo)
            if nimg < 1:
                continue
            tiles = -(-W // tw) * -(-H // th) * -(-B // nimg)
            key = (tiles, nimg * halo)
            if best is None or key < best[0]:
                best = (key, (th, tw, nimg))
    (tiles, _), (th, tw, nimg) = best
    bn = next(n for n in CHANNEL_TILES if n >= min(A, CHANNEL_TILES[-1]))
    while bn > CHANNEL_TILES[0] and tiles * -(-A // bn) < sm_count:
        bn //= 2
    return th, tw, nimg, bn


def assign_channel_patterns(w4: torch.Tensor,
                            patterns: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """Best library pattern per input channel, shared over the filters:
    the one keeping most fp32 energy summed over all filters (ties to the
    first). Returns int32 ids (C,)."""
    pats = pattern_library(patterns, w4.device)
    A, C, KH, KW = w4.shape
    sq = w4.to(torch.float32).square().reshape(A, C, KH * KW).sum(dim=0)
    energy = sq @ pats.to(torch.float32).T                  # (C, n_pat)
    return torch.argmax(energy, dim=1).to(torch.int32)


def pack_pattern_conv(w4: torch.Tensor, pat_ids: torch.Tensor,
                      patterns: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(A, C, 3, 3) + channel pattern ids -> (w_packed (4C, A), taps (C, 4)).

    Values are copied in w4's dtype, never rounded."""
    pats = pattern_library(patterns, w4.device)
    A, C, KH, KW = w4.shape
    keep = int(pats[0].sum())
    # each pattern's taps in ascending order (every pattern has `keep`)
    pat_taps = torch.argsort((~pats).to(torch.int32), dim=1,
                             stable=True)[:, :keep]
    taps = pat_taps[pat_ids.long()].to(torch.int32)         # (C, keep)
    wk = torch.gather(w4.reshape(A, C, KH * KW), 2,
                      taps.long()[None].expand(A, C, keep))  # (A, C, keep)
    return wk.permute(1, 2, 0).reshape(C * keep, A).contiguous(), taps


def gather_taps(x: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """im2col-lite: x (B, H, W, C) -> (B*H*W, keep*C), SAME padding.

    Column ``c*keep + j`` holds tap ``taps[c, j]`` of channel c, the row
    order of ``pack_pattern_conv``."""
    B, H, W, C = x.shape
    keep = taps.shape[1]
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    views = torch.stack([xp[:, dy:dy + H, dx:dx + W, :]
                         for dy in range(3) for dx in range(3)], dim=3)
    flat_idx = (taps.long().to(x.device) * C
                + torch.arange(C, device=x.device)[:, None])   # (C, keep)
    xg = views.reshape(B, H, W, 9 * C)[..., flat_idx.reshape(-1)]
    return xg.reshape(B * H * W, keep * C)


def pattern_conv_ref(x: torch.Tensor, w_packed: torch.Tensor,
                     taps: torch.Tensor, bias: Optional[torch.Tensor] = None,
                     *, activation: Optional[str] = None) -> torch.Tensor:
    """Plain version: gather the taps, fp32 GEMM, epilogue, cast.

    Images go in chunks so the gathered copy stays under about 1 GB."""
    check_activation(activation)
    B, H, W, C = x.shape
    A = w_packed.shape[1]
    wf = w_packed.to(torch.float32)
    y = torch.empty((B, H, W, A), dtype=x.dtype, device=x.device)
    step = max(1, (1 << 28) // max(1, H * W * w_packed.shape[0]))
    for b0 in range(0, B, step):
        xs = x[b0:b0 + step]
        acc = gather_taps(xs, taps).to(torch.float32) @ wf
        acc = apply_epilogue(acc, bias, activation)
        y[b0:b0 + step] = acc.reshape(xs.shape[0], H, W, A).to(x.dtype)
    return y


def pattern_conv(x: torch.Tensor, w_packed: torch.Tensor, taps: torch.Tensor,
                 bias: Optional[torch.Tensor] = None, *,
                 activation: Optional[str] = None) -> torch.Tensor:
    """act(conv3x3(x, W) + bias), stride 1, SAME, for x (B, H, W, C) and a
    packed W -> (B, H, W, A).

    CPU tensors run ``pattern_conv_ref``; CUDA tensors launch the kernel,
    which takes bf16 or fp32 (x, w_packed and bias one dtype, taps int32)
    and contiguous operands.
    """
    check_activation(activation)
    if x.ndim != 4 or w_packed.ndim != 2:
        raise ValueError(f"want x (B, H, W, C) and w_packed (4C, A); got "
                         f"{tuple(x.shape)}, {tuple(w_packed.shape)}")
    B, H, W, C = x.shape
    K, A = w_packed.shape
    if tuple(taps.shape) != (C, 4) or K != 4 * C:
        raise ValueError(f"taps {tuple(taps.shape)} / w_packed "
                         f"{tuple(w_packed.shape)} do not fit C={C}, keep 4")
    if bias is not None and tuple(bias.shape) != (A,):
        raise ValueError(f"bias {tuple(bias.shape)} != {(A,)}")
    if x.device.type == "cpu":
        return pattern_conv_ref(x, w_packed, taps, bias,
                                activation=activation)
    if x.device.type != "cuda":
        raise ValueError(f"pattern_conv: unsupported device {x.device}")
    operands = [w_packed, taps] + ([bias] if bias is not None else [])
    if any(t.device != x.device for t in operands):
        raise ValueError("pattern_conv: operands on different devices")
    if x.dtype not in _DTYPES or w_packed.dtype != x.dtype or (
            bias is not None and bias.dtype != x.dtype):
        raise TypeError(f"pattern_conv: x {x.dtype}, w {w_packed.dtype}, "
                        f"bias {None if bias is None else bias.dtype}; want "
                        "one of float32/bfloat16 throughout")
    if taps.dtype != torch.int32:
        raise TypeError(f"taps must be int32, got {taps.dtype}")
    if not all(t.is_contiguous() for t in [x] + operands):
        raise ValueError("pattern_conv: operands must be contiguous")
    if x.data_ptr() % 16 or w_packed.data_ptr() % 16:
        raise ValueError("pattern_conv: x and w_packed must be 16-byte "
                         "aligned")
    return _launch(x, w_packed, taps, bias, activation,
                   conv_variant(C, A, x.dtype))


def _launch(x: torch.Tensor, w_packed: torch.Tensor, taps: torch.Tensor,
            bias: Optional[torch.Tensor], activation: Optional[str],
            variant: str) -> torch.Tensor:
    """Launch the device kernel ``variant`` on checked CUDA operands (one
    launch per call); the C entry point refuses a variant that does not
    take the call. Callers other than ``pattern_conv`` only hold one route
    against another."""
    if variant not in CONV_ROUTES:
        raise ValueError(f"pattern_conv: unknown variant {variant!r}")
    B, H, W, C = x.shape
    A = w_packed.shape[1]
    out = torch.empty((B, H, W, A), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    plan = (0, 0, 0, 0)
    if variant == "wgmma":
        plan = conv_plan(B, H, W, A, torch.cuda.get_device_properties(
            x.device).multi_processor_count)
    _build.launch(
        "pattern_conv", x.data_ptr(), w_packed.data_ptr(), taps.data_ptr(),
        bias.data_ptr() if bias is not None else None, out.data_ptr(), B, H,
        W, C, A, int(x.dtype == torch.bfloat16), ACT_CODES[activation],
        VARIANTS[variant], *plan,
        torch.cuda.current_stream(x.device).cuda_stream)
    global LAUNCHES
    LAUNCHES += 1
    ROUTE_LAUNCHES[variant] += 1
    return out
