"""Routes and tile plan of the GEMM kernels' tiled variants.

``pattern_gemm`` and ``column_gemm`` each name the device kernel a CUDA
call launches with a plain function of shapes (their ``tiled_variant``),
so the CPU tests reach every route; the C entry point takes that name as
``VARIANTS[name]`` and refuses arguments the named variant does not take.
``wgmma_plan`` sizes the grid of the ``wgmma`` variant, whose core is
``csrc/sm90_gemm.cuh``. A caller (the plan tuner, ``sparse/tune.py``) may
re-tile that grid: ``block_m`` in ``BLOCK_MS`` and a grid order in
``GRID_ORDERS``, names the reference's plans use (``mp``: the output's
column tiles run fastest, the rows resident; ``pm``: the row tiles run
fastest, the panels resident). Neither changes any output element's sum;
the K split stays what ``wgmma_plan`` gives.
"""

from __future__ import annotations

from typing import Optional, Tuple

# variant name -> the integer the C entry points switch on
VARIANTS = {"skinny": 0, "wgmma": 1, "wmma": 2, "simt": 3}
SKINNY_M = 16              # the decode variant serves M <= this
BLOCK_K = 64               # K rows per stage of the wgmma pipeline
BLOCKS_PER_SM = 2          # the ring (~100 KB) lets two blocks share an SM
BLOCK_MS = (64, 128)       # the wgmma variant's row tiles
# grid order name -> the integer the C entry points take; the GEMMs run
# ``pm`` unless told otherwise, the conv ``mp``
GRID_ORDERS = {"mp": 0, "pm": 1}


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


def check_grid(block_m: int, grid_order: Optional[str]) -> None:
    """A wgmma re-tiling the GEMM wrappers take: block_m 0 (``wgmma_plan``'s)
    or one of ``BLOCK_MS``; grid order None (the default) or a
    ``GRID_ORDERS`` name."""
    if block_m not in (0,) + BLOCK_MS:
        raise ValueError(f"block_m {block_m} not in {(0,) + BLOCK_MS}")
    if grid_order is not None and grid_order not in GRID_ORDERS:
        raise ValueError(f"grid_order {grid_order!r} not in "
                         f"{tuple(GRID_ORDERS)}")
