"""Packed weights (``PackedTensor``), the scheme registry and the
pruned-artifact hand-off, mirroring ``repro/sparse``."""

from repro_torch.sparse.artifact import PrunedArtifact
from repro_torch.sparse.packed import PackedTensor, is_packed, tree_packed_bytes
from repro_torch.sparse.registry import dispatch_matmul, handler_for

__all__ = ["PackedTensor", "PrunedArtifact", "dispatch_matmul", "handler_for",
           "is_packed", "tree_packed_bytes"]
