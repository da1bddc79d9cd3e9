"""PrunedArtifact: the hand-off from pruning to serving.

Reduced from ``repro/sparse/artifact.py`` to ``pack``, ``bind`` and
``summary``: save, load, tune and the privacy report are not ported yet.

    artifact = greedy_prune(params, config)      # dense, exactly sparse
    artifact = artifact.pack()                   # PackedTensor leaves
    tree     = artifact.bind(model, packed=True)  # what the LM runs on
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from repro_torch.device import DeviceLike, resolve_device, same_device
from repro_torch.sparse.packed import is_packed, tree_packed_bytes, validate_packed
from repro_torch.sparse.registry import handler_for
from repro_torch.utils.tree import tree_items, tree_map_with_path


@dataclasses.dataclass
class PrunedArtifact:
    params: Any                      # dense, exactly-sparse weights
    specs: Any                       # LayerSpec | None per leaf
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)
    packed: Optional[Any] = None     # params with PackedTensor leaves
    # set by ``bind``: packed leaves that failed validation and are served
    # dense instead ({"fallbacks": {path: reason}})
    bind_report: Optional[Dict[str, Any]] = None

    @torch.no_grad()
    def pack(self, *, verify: bool = False,
             device: DeviceLike = None) -> "PrunedArtifact":
        """Compress every packable leaf through the scheme registry, on
        ``device``. Leaves without a packed form stay dense. ``verify``
        unpacks every packed leaf and raises unless it is exactly the
        dense leaf."""
        dev = resolve_device(device)

        def pack_leaf(path, w, spec):
            if not same_device(w.device, dev):
                raise ValueError(f"param {path} is on {w.device}, not {dev}")
            if spec is None:
                return w
            pt = handler_for(spec.scheme).pack(w, spec)
            if pt is None:
                return w
            if verify and not torch.equal(
                    handler_for(pt.scheme).to_dense(pt).to(torch.float32),
                    w.to(torch.float32)):
                raise AssertionError(f"pack/unpack mismatch for scheme "
                                     f"{pt.scheme} on leaf {path}")
            return pt

        packed = tree_map_with_path(pack_leaf, self.params, self.specs)
        return dataclasses.replace(self, packed=packed)

    def bind(self, model: Any, *, packed: bool = True) -> Any:
        """The params tree ``model`` runs with, checked against its shapes.

        Leaves the model cannot run packed (``unpackable_leaf_paths``,
        e.g. ResNet's strided convs) are unpacked here, once, instead of
        inside every forward. A packed leaf that fails ``validate_packed``
        is served from the dense params instead and recorded in
        ``bind_report``.
        """
        if packed and self.packed is None:
            self.packed = self.pack(device=model.device).packed
        tree = self.packed if packed else self.params
        self.bind_report = {"fallbacks": {}}
        if packed:
            dense = dict(tree_items(self.params))
            unpackable = set(getattr(model, "unpackable_leaf_paths",
                                     lambda: ())())

            def check_leaf(path, x):
                if not is_packed(x):
                    return x
                if path in unpackable:
                    return handler_for(x.scheme).to_dense(x)
                why = validate_packed(x)
                if why is None:
                    return x
                self.bind_report["fallbacks"][path] = why
                return dense[path]

            tree = tree_map_with_path(check_leaf, tree)
        want = model.param_shapes()
        got = {p: tuple(leaf.shape) for p, leaf in tree_items(tree)}
        if set(want) != set(got):
            missing = sorted(set(want) - set(got))[:4]
            surplus = sorted(set(got) - set(want))[:4]
            raise ValueError(
                "artifact does not match the model's parameter structure "
                f"(missing: {missing}, surplus: {surplus})")
        wrong = [(p, got[p], want[p]) for p in want if got[p] != want[p]]
        if wrong:
            raise ValueError("artifact leaf shapes do not match the model "
                             f"(first mismatches: {wrong[:4]})")
        return tree

    def packed_bytes(self) -> int:
        return tree_packed_bytes(self.packed if self.packed is not None
                                 else self.params)

    def dense_bytes(self) -> int:
        return tree_packed_bytes(self.params)

    def summary(self) -> Dict[str, Any]:
        """Compression accounting: bytes and leaf counts, packed vs dense."""
        leaves = ([leaf for _, leaf in tree_items(self.packed)]
                  if self.packed is not None else [])
        dense_b, packed_b = self.dense_bytes(), self.packed_bytes()
        return {"dense_bytes": dense_b, "packed_bytes": packed_b,
                "bytes_ratio": dense_b / max(packed_b, 1),
                "packed_leaves": sum(is_packed(leaf) for leaf in leaves),
                "total_leaves": len(leaves)}
