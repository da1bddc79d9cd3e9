"""Checkpoint directories in the reference's on-disk format (mirrors
``repro/checkpoint/checkpointer.py``).

A checkpoint is a directory holding ``manifest.json`` and one ``.npy``
file per array (per buffer for a ``PackedTensor`` leaf). The manifest is
the reference's schema v2: ``schema_version``, a ``leaves`` table (path,
file, shape, logical dtype and the CRC32 of the whole ``.npy`` file, or a
``packed`` entry with scheme, dense shape, meta and one such record per
buffer), the ``containers`` (which node paths are lists or tuples, and
their lengths) and ``extra``. Schema v1 (no version, no CRC32) loads too.
Either package loads what the other saved; bf16, which numpy lacks, is
stored as its ``uint16`` bits with the logical dtype in the manifest.

Every load checks the bytes it is about to read and raises
``ArtifactError``, naming the file and the leaf, on a missing, truncated
or bit-flipped file or a broken manifest. ``save_pytree`` writes into a
temporary directory beside the target and renames it into place, so a
crash mid-write never leaves a half-written checkpoint under its name.

Leaves are torch tensors (any device), numpy arrays or ``PackedTensor``s;
``None`` leaves are not saved (the reference's masks have ``None`` at
unpruned params). ``CheckpointManager`` keeps step-indexed checkpoints
(``<root>/step_<k:09d>``) with rotation, in the reference's layout, so
either package reads the other's steps.
"""

from __future__ import annotations

import io
import json
import os
import re
import shutil
import tempfile
import time
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device

MANIFEST = "manifest.json"
COMMIT_RE = re.compile(r"^step_(\d+)$")

# the reference's manifest layout version; loaders accept <= current.
# v1: no version field, no checksums; v2: + schema_version, per-file crc32
SCHEMA_VERSION = 2


class ArtifactError(ValueError):
    """A checkpoint or artifact failed validation at load time.

    ``path`` is the file or directory that failed and ``field`` names what
    was being checked, so a failure in a many-leaf artifact points at the
    one bad buffer.
    """

    def __init__(self, message: str, *, path: Optional[str] = None,
                 field: Optional[str] = None):
        self.path = path
        self.field = field
        detail = []
        if path is not None:
            detail.append(f"path={path}")
        if field is not None:
            detail.append(f"field={field}")
        super().__init__(
            message + (f" [{', '.join(detail)}]" if detail else ""))


# numpy has no bfloat16: saved as its uint16 bits, logical dtype recorded
_VIEW_DTYPES = {"bfloat16": np.uint16}


def _is_packed(x: Any) -> bool:
    # duck-typed, as the reference does, so this module needs no sparse
    return type(x).__name__ == "PackedTensor" and hasattr(x, "buffers")


def _to_numpy(leaf: Any) -> Tuple[np.ndarray, str]:
    """A tensor or array -> (array to save, logical dtype name)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu").contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
        return arr, arr.dtype.name
    arr = np.asarray(leaf)
    logical = arr.dtype.name
    if logical in _VIEW_DTYPES:
        arr = arr.view(_VIEW_DTYPES[logical])
    return arr, logical


def _to_tensor(arr: np.ndarray, logical: str) -> torch.Tensor:
    if not arr.flags.writeable:
        arr = arr.copy()
    if logical in _VIEW_DTYPES:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _flatten(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) in the reference's order: dict keys sorted, sequences
    in order, ``None`` dropped, a ``PackedTensor`` one leaf."""
    if tree is None:
        return []
    if _is_packed(tree):
        return [(prefix, tree)]
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return [(prefix, tree)]
    out = []
    for key, sub in items:
        out += _flatten(sub, f"{prefix}/{key}" if prefix else key)
    return out


def _container_kinds(tree: Any, prefix: str = "",
                     out: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Node path -> {kind: 'list'|'tuple', len} for every sequence, so a
    load rebuilds sequences as sequences (and leaf-less elements as None)."""
    if out is None:
        out = {}
    if _is_packed(tree):
        return out
    if isinstance(tree, (list, tuple)):
        out[prefix] = {"kind": "tuple" if isinstance(tree, tuple) else "list",
                       "len": len(tree)}
        for i, v in enumerate(tree):
            _container_kinds(v, f"{prefix}/{i}" if prefix else str(i), out)
    elif isinstance(tree, dict):
        for k, v in tree.items():
            _container_kinds(v, f"{prefix}/{k}" if prefix else str(k), out)
    return out


def _structure(tree: Any) -> str:
    """The tree's shape as text, leaves ``*`` (the manifest's informative
    ``treedef``; no loader reads it)."""
    if tree is None:
        return "None"
    if _is_packed(tree):
        return "*"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_structure(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, (list, tuple)):
        inner = ", ".join(_structure(v) for v in tree)
        return f"({inner},)" if isinstance(tree, tuple) else f"[{inner}]"
    return "*"


def save_pytree(directory: str, tree: Any, *,
                extra: Optional[Dict] = None) -> None:
    """Atomically save a tree of tensors/arrays and ``PackedTensor``s."""
    parent = os.path.dirname(os.path.abspath(directory)) or "."
    os.makedirs(parent, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="tmp.ckpt.", dir=parent)
    try:
        manifest = {"schema_version": SCHEMA_VERSION,
                    "treedef": _structure(tree), "leaves": [],
                    "containers": _container_kinds(tree),
                    "extra": extra or {}, "time": time.time()}

        def save_buf(arr: np.ndarray, fname: str) -> int:
            """np.save, then the crc32 of the WHOLE file (header too)."""
            fpath = os.path.join(tmp, fname)
            np.save(fpath, arr)
            with open(fpath, "rb") as f:
                return zlib.crc32(f.read()) & 0xFFFFFFFF

        for i, (path, leaf) in enumerate(_flatten(tree)):
            if _is_packed(leaf):
                bufs = []
                for name, buf in zip(leaf.names, leaf.buffers):
                    arr, logical = _to_numpy(buf)
                    fname = f"leaf_{i:05d}.{name}.npy"
                    bufs.append({"name": name, "file": fname,
                                 "shape": list(arr.shape), "dtype": logical,
                                 "crc32": save_buf(arr, fname)})
                manifest["leaves"].append({"path": path, "packed": {
                    "scheme": leaf.scheme, "shape": list(leaf.shape),
                    "meta": [list(kv) for kv in leaf.meta],
                    "buffers": bufs}})
                continue
            arr, logical = _to_numpy(leaf)
            fname = f"leaf_{i:05d}.npy"
            manifest["leaves"].append({
                "path": path, "file": fname, "shape": list(arr.shape),
                "dtype": logical, "crc32": save_buf(arr, fname)})
        with open(os.path.join(tmp, MANIFEST), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(directory):
            shutil.rmtree(directory)
        os.rename(tmp, directory)            # atomic commit
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


# ------------------------------------------------------------------- loading

def _read_manifest(directory: str) -> Dict:
    mpath = os.path.join(directory, MANIFEST)
    if not os.path.isfile(mpath):
        raise ArtifactError("checkpoint has no manifest (missing, "
                            "truncated copy, or not a checkpoint dir)",
                            path=mpath, field="manifest")
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        raise ArtifactError(f"manifest is not valid JSON ({e})",
                            path=mpath, field="manifest") from e
    if not isinstance(manifest, dict) or "leaves" not in manifest:
        raise ArtifactError("manifest lacks a 'leaves' table",
                            path=mpath, field="leaves")
    version = manifest.get("schema_version", 1)
    if not isinstance(version, int) or version > SCHEMA_VERSION:
        raise ArtifactError(
            f"manifest schema_version {version!r} is newer than this "
            f"loader (supports <= {SCHEMA_VERSION})",
            path=mpath, field="schema_version")
    return manifest


def _entry_field(entry: Dict, key: str, *, leaf_path: str, directory: str):
    if key not in entry:
        raise ArtifactError(
            f"manifest entry for leaf {leaf_path!r} lacks field {key!r}",
            path=os.path.join(directory, MANIFEST),
            field=f"{leaf_path}.{key}")
    return entry[key]


def _read_checked(directory: str, entry: Dict, *, leaf_path: str) -> bytes:
    """The bytes of one buffer file, checked against its recorded crc32."""
    fname = _entry_field(entry, "file", leaf_path=leaf_path,
                         directory=directory)
    fpath = os.path.join(directory, fname)
    if not os.path.isfile(fpath):
        raise ArtifactError(f"buffer file for leaf {leaf_path!r} is missing",
                            path=fpath, field=leaf_path)
    with open(fpath, "rb") as f:
        data = f.read()
    want = entry.get("crc32")
    if want is not None:                # v1 manifests recorded none
        got = zlib.crc32(data) & 0xFFFFFFFF
        if got != int(want):
            raise ArtifactError(
                f"buffer bytes for leaf {leaf_path!r} do not match their "
                f"manifest crc32 (got {got:#010x}, recorded "
                f"{int(want):#010x}): the file was corrupted after save",
                path=fpath, field=leaf_path)
    return data


def _load_buffer(directory: str, entry: Dict, *, leaf_path: str,
                 device: torch.device) -> torch.Tensor:
    data = _read_checked(directory, entry, leaf_path=leaf_path)
    fpath = os.path.join(directory, entry["file"])
    try:
        arr = np.load(io.BytesIO(data), allow_pickle=False)
    except Exception as e:
        raise ArtifactError(
            f"buffer file for leaf {leaf_path!r} is not a readable .npy "
            f"({type(e).__name__}: {e})", path=fpath, field=leaf_path) from e
    logical = _entry_field(entry, "dtype", leaf_path=leaf_path,
                           directory=directory)
    if list(arr.shape) != list(entry.get("shape", arr.shape)):
        raise ArtifactError(
            f"buffer for leaf {leaf_path!r} has shape {list(arr.shape)}, "
            f"manifest records {entry.get('shape')}", path=fpath,
            field=leaf_path)
    return _to_tensor(arr, logical).to(device)


def _load_leaf(directory: str, entry: Dict, device: torch.device) -> Any:
    """One manifest entry -> a tensor or a ``PackedTensor``."""
    leaf_path = entry.get("path", "?")
    if "packed" not in entry:
        return _load_buffer(directory, entry, leaf_path=leaf_path,
                            device=device)
    from repro_torch.sparse.packed import PackedTensor

    p = entry["packed"]
    for key in ("scheme", "shape", "meta", "buffers"):
        _entry_field(p, key, leaf_path=leaf_path, directory=directory)
    names, bufs = [], []
    for b in p["buffers"]:
        names.append(_entry_field(b, "name", leaf_path=leaf_path,
                                  directory=directory))
        bufs.append(_load_buffer(directory, b, leaf_path=leaf_path,
                                 device=device))
    return PackedTensor(p["scheme"], tuple(p["shape"]), tuple(names),
                        tuple(bufs), tuple((k, v) for k, v in p["meta"]))


def verify_checkpoint(directory: str) -> Dict[str, Any]:
    """Byte-level integrity pass: every buffer file's crc32 against the
    manifest, no arrays built. Raises ``ArtifactError`` on the first
    failure; returns ``{leaves, buffers, schema_version}`` (``buffers``
    counts files actually checksummed: v1 manifests recorded none)."""
    manifest = _read_manifest(directory)
    checked = 0
    for entry in manifest["leaves"]:
        leaf_path = entry.get("path", "?")
        for e in (entry["packed"]["buffers"] if "packed" in entry
                  else [entry]):
            _read_checked(directory, e, leaf_path=leaf_path)
            checked += int("crc32" in e)
    return {"leaves": len(manifest["leaves"]), "buffers": checked,
            "schema_version": manifest.get("schema_version", 1)}


def _unflatten(like: Any, leaves: List[Any]) -> Any:
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if _is_packed(node) or not isinstance(node, (dict, list, tuple)):
            return next(it)
        if isinstance(node, dict):
            # fill in the sorted order the leaves were saved in
            done = {k: build(node[k]) for k in sorted(node)}
            return {k: done[k] for k in node}
        seq = [build(v) for v in node]
        if hasattr(node, "_fields"):          # a NamedTuple keeps its type
            return type(node)(*seq)
        return tuple(seq) if isinstance(node, tuple) else seq

    return build(like)


def restore_pytree(directory: str, like: Any) -> Any:
    """Restore into the structure of ``like``; each tensor lands on the
    device of the ``like`` leaf it replaces (CPU for other leaves)."""
    manifest = _read_manifest(directory)
    flat = _flatten(like)
    if len(manifest["leaves"]) != len(flat):
        raise ArtifactError(
            f"checkpoint has {len(manifest['leaves'])} leaves; target "
            f"structure has {len(flat)}", path=directory, field="leaves")
    leaves = []
    for entry, (_, leaf) in zip(manifest["leaves"], flat):
        dev = leaf.device if isinstance(leaf, torch.Tensor) else (
            torch.device("cpu"))
        leaves.append(_load_leaf(directory, entry, dev))
    return _unflatten(like, leaves)


def _nest(flat: Dict[str, Any],
          containers: Optional[Dict[str, Any]] = None) -> Any:
    """Rebuild a nested tree from '/'-joined leaf paths; ``containers``
    says which nodes were sequences (absent in old manifests: digit-keyed
    nodes become lists)."""
    if list(flat) == [""]:
        return flat[""]              # a bare leaf saved at the root
    root: Dict[str, Any] = {}
    for path, leaf in flat.items():
        node = root
        keys = path.split("/")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = leaf

    def rebuild(node, prefix):
        if not isinstance(node, dict):
            return node
        out = {k: rebuild(v, f"{prefix}/{k}" if prefix else k)
               for k, v in node.items()}
        if containers is not None:
            entry = containers.get(prefix)
            if entry is not None:
                seq = [out.get(str(i)) for i in range(entry["len"])]
                return tuple(seq) if entry["kind"] == "tuple" else seq
            return out
        if out and all(k.isdigit() for k in out):
            idxs = sorted(int(k) for k in out)
            if idxs == list(range(len(idxs))):
                return [out[str(i)] for i in idxs]
        return out

    return rebuild(root, "")


def load_pytree(directory: str, *, device: DeviceLike = None) -> Any:
    """Restore a checkpoint WITHOUT a template tree, on ``device``.

    The nesting comes from the manifest's leaf paths and containers;
    ``PackedTensor`` leaves from their packed entries. Every buffer's
    crc32 is checked before it is read.
    """
    dev = resolve_device(device)
    manifest = _read_manifest(directory)
    flat = {}
    for entry in manifest["leaves"]:
        if "path" not in entry:
            raise ArtifactError("manifest leaf entry lacks its 'path'",
                                path=os.path.join(directory, MANIFEST),
                                field="path")
        flat[entry["path"]] = _load_leaf(directory, entry, dev)
    return _nest(flat, manifest.get("containers"))


class CheckpointManager:
    """Step-indexed checkpoints with rotation and crash-safe commits.

    A step is committed once its directory holds a manifest:
    ``save_pytree`` writes into a temporary directory and renames it into
    place, so ``steps`` never lists a half-written step. After each save
    only the ``keep`` newest steps are kept.
    """

    def __init__(self, root: str, keep: int = 3):
        self.root = root
        self.keep = keep
        os.makedirs(root, exist_ok=True)

    def _dir(self, step: int) -> str:
        return os.path.join(self.root, f"step_{step:09d}")

    def steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.root):
            m = COMMIT_RE.match(name)
            if m and os.path.exists(os.path.join(self.root, name, MANIFEST)):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, tree: Any, *,
             extra: Optional[Dict] = None) -> None:
        save_pytree(self._dir(step), tree, extra=extra)
        self._rotate()

    def restore(self, like: Any, step: Optional[int] = None) -> Any:
        """Step ``step`` (default: the newest) in the structure of ``like``,
        each tensor on the device of the leaf it replaces."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.root}")
        return restore_pytree(self._dir(step), like)

    def extra(self, step: Optional[int] = None) -> Dict:
        if step is None:
            step = self.latest_step()
        with open(os.path.join(self._dir(step), MANIFEST)) as f:
            return json.load(f)["extra"]

    def _rotate(self) -> None:
        steps = self.steps()
        for s in steps[: max(0, len(steps) - self.keep)]:
            shutil.rmtree(self._dir(s), ignore_errors=True)
