"""Routes and tile plan of the GEMM kernels' tiled variants.

``pattern_gemm`` and ``column_gemm`` each name the device kernel a CUDA
call launches with a plain function of shapes (their ``tiled_variant``),
so the CPU tests reach every route; the C entry point takes that name as
``VARIANTS[name]`` and refuses arguments the named variant does not take.
``wgmma_plan`` sizes the grid of the ``wgmma`` variant, whose core is
``csrc/sm90_gemm.cuh``.
"""

from __future__ import annotations

from typing import Tuple

# variant name -> the integer the C entry points switch on
VARIANTS = {"skinny": 0, "wgmma": 1, "wmma": 2, "simt": 3}
SKINNY_M = 16              # the decode variant serves M <= this
BLOCK_K = 64               # K rows per stage of the wgmma pipeline
BLOCKS_PER_SM = 2          # the ring (~100 KB) lets two blocks share an SM


def wgmma_plan(M: int, n_tiles: int, k_steps: int,
               sm_count: int) -> Tuple[int, int]:
    """(block_m, ksplit) of the wgmma variant for M rows, ``n_tiles``
    output tiles across (128 columns, or pattern_gemm's panels) and
    ``k_steps`` BLOCK_K-deep steps; block_m is 128 (two consumer
    warpgroups) or 64 (one).

    128-row tiles (two consumer warpgroups) ran faster per output element
    than 64-row ones at every qwen2-1.5b shape on an H100, so 64 rows serve
    only grids that would not give every SM a block. When the grid
    still fills at most half the card's block slots (wk/wv at M = 2048: 64
    blocks), K is split over blocks, no split shorter than two steps and
    none empty; the splits' fp32 partials are summed in a fixed order
    afterwards.
    """
    block_m = 128 if -(-M // 128) * n_tiles >= sm_count else 64
    blocks = -(-M // block_m) * n_tiles
    slots = BLOCKS_PER_SM * sm_count
    ksplit = 1
    if 2 * blocks <= slots:
        ksplit = max(1, min(slots // blocks, k_steps // 2))
        ksplit = -(-k_steps // -(-k_steps // ksplit))   # no empty split
    return block_m, ksplit
