"""PackedTensor: one pruned weight in its compressed deployment form.

Mirrors ``repro/sparse/packed.py``. Buffers per scheme:

  tile_pattern   w_packed (nb, Kp, bp)  kept lanes, one contiguous panel
                                        per output block of bp columns
                 lane_idx (nb, Kp)      int32 source row of each packed row
  column         w_packed (K, P)        the surviving contraction rows
                 kept_idx (K,)          int32 source row of each packed row
  pattern        w_packed (4C, A)       each channel's 4 kept taps, all
                                        filters (conv weight (A, C, 3, 3))
                 taps (C, 4)            int32 flat tap (0..8) of each slot

``shape`` is the logical dense shape the buffers replace: (in, out) for a
GEMM weight, (A, C, 3, 3) for a conv. The port keeps per-layer weights,
so buffers never carry a layer axis.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.utils.tree import tree_items


@dataclasses.dataclass
class PackedTensor:
    scheme: str
    shape: Tuple[int, ...]
    names: Tuple[str, ...]
    buffers: Tuple[torch.Tensor, ...]
    meta: Tuple[Tuple[str, Any], ...] = ()

    def buf(self, name: str) -> torch.Tensor:
        return self.buffers[self.names.index(name)]

    @property
    def meta_dict(self) -> Dict[str, Any]:
        return dict(self.meta)

    @property
    def dtype(self) -> torch.dtype:
        return self.buf("w_packed").dtype

    @property
    def canonical_w_ndim(self) -> int:
        """3 for the blocked (nb, Kp, bp) layout; 2 for the legacy flat."""
        return int(self.meta_dict.get("w_ndim", 2))

    def packed_bytes(self) -> int:
        return sum(b.numel() * b.element_size() for b in self.buffers)

    def dense_bytes(self) -> int:
        return math.prod(self.shape) * self.buf("w_packed").element_size()


def is_packed(x: Any) -> bool:
    return isinstance(x, PackedTensor)


# index-table buffer -> bound derived from the dense shape, per scheme
_INDEX_BOUNDS = {
    "tile_pattern": ("lane_idx", lambda shape: shape[-2]),
    "column": ("kept_idx", lambda shape: shape[-2]),
    "pattern": ("taps", lambda shape: 9),
    "pattern_shared": ("taps", lambda shape: 9),
}


def validate_packed(pt: PackedTensor) -> Optional[str]:
    """Structural health check of one packed leaf: None if servable, else
    a one-line reason (missing buffers, out-of-range index tables — which
    would make a kernel gather outside x — or non-finite weights)."""
    if len(pt.names) != len(pt.buffers):
        return f"{len(pt.names)} buffer names but {len(pt.buffers)} buffers"
    if "w_packed" not in pt.names:
        return "no w_packed buffer"
    if not bool(torch.isfinite(pt.buf("w_packed")).all()):
        return "non-finite values in w_packed"
    bound = _INDEX_BOUNDS.get(pt.scheme)
    if bound is not None:
        name, hi_fn = bound
        if name not in pt.names:
            return f"scheme {pt.scheme!r} lacks its {name!r} index table"
        idx = pt.buf(name)
        hi = int(hi_fn(pt.shape))
        if idx.numel():
            lo_v, hi_v = int(idx.min()), int(idx.max())
            if lo_v < 0 or hi_v >= hi:
                return (f"{name} entries outside [0, {hi}) "
                        f"(min {lo_v}, max {hi_v})")
    return None


def tree_packed_bytes(tree: Any) -> int:
    """Total weight bytes of a params tree, counting packed leaves packed."""
    total = 0
    for _, leaf in tree_items(tree):
        if is_packed(leaf):
            total += leaf.packed_bytes()
        elif isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
    return total
