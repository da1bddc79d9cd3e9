"""PrunedArtifact: the hand-off from pruning to serving (mirrors
``repro/sparse/artifact.py``).

    artifact = greedy_prune(params, config)      # dense, exactly sparse
    artifact = artifact.pack()                   # PackedTensor leaves
    artifact.save("/ckpt/pruned")                # the reference's format
    ...
    artifact = PrunedArtifact.load("/ckpt/pruned", cfg=cfg)   # on the card
    tree     = artifact.bind(model, packed=True)  # what the LM runs on

On disk an artifact is the reference's: ``params/``, ``masks/`` and
``packed/`` checkpoint directories (``checkpoint.save_pytree``) and
``artifact.json`` (schema version, the path-keyed ``LayerSpec`` table,
``meta``). An LM's trees are written in the reference's stacked layout
(``convert.tree_to_jax``), so each package loads what the other saved.
``meta["privacy"]`` is the privacy provenance block: the prune's data
lineage as ``PruneResult`` stamps it, extended by ``with_privacy``
downstream (``retrained_on``, the pipeline, the measured ``mia``
numbers). The tuner is not ported: ``pack`` runs untuned.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional

import torch

from repro_torch.checkpoint import ArtifactError, load_pytree, save_pytree
from repro_torch.checkpoint import verify_checkpoint
from repro_torch.configs.base import ModelConfig
from repro_torch.core.schemes import LayerSpec
from repro_torch.device import DeviceLike, resolve_device, same_device
from repro_torch.sparse.packed import is_packed, tree_packed_bytes, validate_packed
from repro_torch.sparse.registry import handler_for
from repro_torch.utils.tree import reference_path, tree_items, tree_map_with_path

ARTIFACT_JSON = "artifact.json"
# artifact.json layout version (the reference's; separate from the
# checkpoint manifest's schema_version)
ARTIFACT_SCHEMA_VERSION = 2


@dataclasses.dataclass
class PrunedArtifact:
    params: Any                      # dense, exactly-sparse weights
    masks: Any                       # {0, 1} per pruned leaf, None elsewhere
    specs: Any                       # LayerSpec | None per leaf
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)
    packed: Optional[Any] = None     # params with PackedTensor leaves
    # set by ``load``: the directory it came from (``verify_integrity``
    # re-checks its bytes). Not persisted.
    source_dir: Optional[str] = None
    # set by ``bind``: packed leaves that failed validation and are served
    # dense instead ({"fallbacks": {path: reason}})
    bind_report: Optional[Dict[str, Any]] = None

    def with_params(self, params: Any) -> "PrunedArtifact":
        """New artifact with updated weights (e.g. after masked
        retraining). Clears any packing: the packed form encodes weight
        values, not just structure."""
        return dataclasses.replace(self, params=params, packed=None)

    def with_privacy(self, **fields: Any) -> "PrunedArtifact":
        """New artifact whose manifest ``privacy`` block has ``fields``
        merged in (existing keys overwritten): ``retrained_on`` after
        masked retraining, ``mia`` once the attack harness has measured
        the model."""
        meta = dict(self.meta)
        meta["privacy"] = {**(meta.get("privacy") or {}), **fields}
        return dataclasses.replace(self, meta=meta)

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

    @property
    def privacy(self) -> Optional[Dict[str, Any]]:
        """The manifest's privacy provenance block (None if never
        stamped): which data the prune saw, by what generator and method."""
        return self.meta.get("privacy")

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

    # ---------------------------------------------------------- persistence

    def save(self, directory: str) -> None:
        """Write the artifact under ``directory`` in the reference's layout:
        ``params/``, ``masks/``, ``packed/`` (each an atomic checkpoint)
        and ``artifact.json``."""
        from repro_torch.convert import tree_to_jax   # convert imports sparse

        os.makedirs(directory, exist_ok=True)
        save_pytree(os.path.join(directory, "params"), tree_to_jax(self.params))
        save_pytree(os.path.join(directory, "masks"),
                    tree_to_jax(self.masks) if self.masks is not None else {})
        if self.packed is not None:
            save_pytree(os.path.join(directory, "packed"),
                        tree_to_jax(self.packed))
        spec_table: Dict[str, Any] = {}
        for path, spec in tree_items(self.specs):
            spec_table[reference_path(path)] = (
                None if spec is None else dataclasses.asdict(spec))
        doc = {"schema_version": ARTIFACT_SCHEMA_VERSION, "specs": spec_table,
               "meta": self.meta, "packed": self.packed is not None}
        tmp = os.path.join(directory, ARTIFACT_JSON + ".tmp")
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=1)
        os.replace(tmp, os.path.join(directory, ARTIFACT_JSON))

    @classmethod
    def load(cls, directory: str, *, cfg: Optional[ModelConfig] = None,
             device: DeviceLike = None) -> "PrunedArtifact":
        """Rebuild an artifact saved by either package, its buffers on
        ``device`` (default: the card). ``cfg`` is an LM's config (its
        blocks are stacked on disk); None for a CNN.

        Every way a damaged directory can fail (missing or truncated
        ``artifact.json``, a future schema, a missing, truncated or
        bit-flipped buffer, trees that do not fit ``cfg``) raises
        ``ArtifactError`` naming the path and the field.
        """
        from repro_torch.convert import packed_from_jax   # imports sparse

        dev = resolve_device(device)
        apath = os.path.join(directory, ARTIFACT_JSON)
        try:
            with open(apath) as f:
                doc = json.load(f)
        except FileNotFoundError:
            raise ArtifactError("artifact.json not found", path=apath,
                                field="artifact.json") from None
        except (json.JSONDecodeError, UnicodeDecodeError) as e:
            raise ArtifactError(f"artifact.json is not valid JSON: {e}",
                                path=apath, field="artifact.json") from None
        if not isinstance(doc, dict):
            raise ArtifactError("artifact.json is not a JSON object",
                                path=apath, field="artifact.json")
        version = doc.get("schema_version", 1)
        if not isinstance(version, int) or version > ARTIFACT_SCHEMA_VERSION:
            raise ArtifactError(
                f"artifact schema_version {version!r} is newer than this "
                f"build supports ({ARTIFACT_SCHEMA_VERSION})",
                path=apath, field="schema_version")

        def port_tree(sub: str) -> Any:
            """A saved (stacked) tree, per layer on ``dev``."""
            d = os.path.join(directory, sub)
            tree = load_pytree(d, device="cpu")
            try:
                return packed_from_jax(tree, cfg, dev)
            except (IndexError, KeyError, TypeError, ValueError,
                    AttributeError) as e:
                raise ArtifactError(
                    f"{sub} tree does not fit the config "
                    f"({type(e).__name__}: {e})", path=d, field=sub) from e

        params = port_tree("params")
        masks_flat: Dict[str, torch.Tensor] = {}
        mask_dir = os.path.join(directory, "masks")
        if os.path.isdir(mask_dir):
            for path, m in tree_items(load_pytree(mask_dir, device="cpu")):
                if isinstance(m, torch.Tensor):
                    masks_flat[path] = m

        def mask_at(path, _w):
            m = masks_flat.get(reference_path(path))
            if m is None:
                return None
            if cfg is not None and path.startswith("blocks/"):
                m = m[int(path.split("/")[1])]
            return m.contiguous().to(dev)

        # masks and specs congruent with params: absent paths are None
        masks = tree_map_with_path(mask_at, params)
        spec_table = doc.get("specs", {})

        def spec_at(path, _w):
            d = spec_table.get(reference_path(path))
            if d is None:
                return None
            if d.get("conv_shape") is not None:
                d = dict(d, conv_shape=tuple(d["conv_shape"]))
            try:
                return LayerSpec(**d)
            except TypeError as e:
                raise ArtifactError(f"bad LayerSpec for {path}: {e}",
                                    path=apath, field=f"specs.{path}") from e

        specs = tree_map_with_path(spec_at, params)
        packed = None
        if doc.get("packed") and os.path.isdir(os.path.join(directory,
                                                            "packed")):
            packed = port_tree("packed")
        return cls(params=params, masks=masks, specs=specs,
                   meta=doc.get("meta", {}), packed=packed,
                   source_dir=directory)

    def verify_integrity(self) -> Dict[str, Any]:
        """Health check: re-verify the CRC32 of every saved buffer (when
        the artifact came from disk; ``ArtifactError`` on corruption) and
        ``validate_packed`` every in-memory packed leaf (faults returned,
        not raised: ``bind`` serves those leaves dense). Returns ``{"disk":
        {subdir: stats}, "packed_ok": n, "packed_bad": {path: reason}}``."""
        report: Dict[str, Any] = {"disk": {}, "packed_ok": 0,
                                  "packed_bad": {}}
        if self.source_dir is not None:
            for sub in ("params", "masks", "packed"):
                d = os.path.join(self.source_dir, sub)
                if os.path.isdir(d):
                    report["disk"][sub] = verify_checkpoint(d)
        if self.packed is not None:
            for path, leaf in tree_items(self.packed):
                if not is_packed(leaf):
                    continue
                why = validate_packed(leaf)
                if why is None:
                    report["packed_ok"] += 1
                else:
                    report["packed_bad"][path] = why
        return report
