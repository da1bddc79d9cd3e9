"""Convert parameter trees between the reference's layout and the port's.

An LM's reference tree keeps a leading ``(L, ...)`` layer axis under
``blocks`` (and so do its ``PackedTensor`` buffers); the port keeps a list
with one entry per layer. A CNN's tree (``cfg`` None) has no stacked axis,
its ``layers`` are already a list, and it converts leaf by leaf.

``params_from_jax`` / ``packed_from_jax`` take the reference's tree with
numpy leaves (``jax.device_get`` of its params, or its packed tree with
buffers as numpy) or with CPU tensors (``checkpoint.load_pytree`` of a
reference checkpoint) and return the port's tree on a device.
``tree_to_jax`` is the inverse: the port's tree in the reference's layout,
CPU tensors and stacked ``PackedTensor``s, which ``checkpoint.save_pytree``
writes as the reference's ``.npy`` files.

This module imports neither jax nor ``repro``: a reference
``PackedTensor`` is read by its attributes (``scheme``, ``shape``,
``names``, ``buffers``, ``meta``).

Plans: the port's tuned plans (``plan_torch*`` meta entries,
``sparse/tune.py``) ride a stacked leaf's meta one value per key: the
layers' common value, or each layer's value joined by ``|`` (empty for a
layer without it) where they differ, e.g. a column leaf whose layers kept
different row counts. Loading picks each layer's own. The reference's
``plan:*`` and ``plan_mode`` entries are dropped on load: they were
chosen for a CPU or a TPU.
"""

from __future__ import annotations

from typing import Any, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.sparse.packed import PackedTensor

PLAN_META = "plan_torch"      # sparse/tune.py's PLAN_PREFIX and MODE_KEY
LAYER_SEP = "|"


def tensor_from_numpy(a: Any, device: torch.device) -> torch.Tensor:
    """numpy (or a tensor) -> a tensor on ``device``; bf16
    (``ml_dtypes.bfloat16``, which ``torch.from_numpy`` refuses) goes
    through its uint16 bits."""
    if isinstance(a, torch.Tensor):
        return a.contiguous().to(device)
    a = np.array(a, order="C")       # a writable copy torch may own
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _array(a: Any) -> Any:
    return a if isinstance(a, torch.Tensor) else np.asarray(a)


def _is_reference_packed(x: Any) -> bool:
    return all(hasattr(x, a) for a in ("scheme", "shape", "names", "buffers"))


def _convert(tree: Any, leaf_fn) -> Any:
    if isinstance(tree, dict):
        return {k: _convert(v, leaf_fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_convert(v, leaf_fn) for v in tree]
    return leaf_fn(tree)


def _per_layer(tree: Any, cfg: Optional[ModelConfig], leaf_fn) -> Any:
    if cfg is None:
        return _convert(tree, lambda a: leaf_fn(a, None))
    out = {}
    for key, sub in tree.items():
        if key == "blocks":
            out[key] = [_convert(sub, lambda a, l=layer: leaf_fn(a, l))
                        for layer in range(cfg.num_layers)]
        else:
            out[key] = _convert(sub, lambda a: leaf_fn(a, None))
    return out


def params_from_jax(np_tree: Any, cfg: Optional[ModelConfig],
                    device: DeviceLike = None) -> Any:
    """Reference params (an LM's blocks stacked) -> the port's."""
    dev = resolve_device(device)
    return _per_layer(np_tree, cfg, lambda a, layer: tensor_from_numpy(
        a if layer is None else _array(a)[layer], dev))


def packed_from_jax(np_tree: Any, cfg: Optional[ModelConfig],
                    device: DeviceLike = None) -> Any:
    """Reference packed params (any leaf may be packed) -> the port's tree.

    Tuned ``plan:*`` and ``plan_mode`` meta entries are dropped: they were
    chosen for a CPU or a TPU. The port's ``plan_torch*`` entries stay,
    each layer of a stacked leaf taking its own value.
    """
    dev = resolve_device(device)

    def leaf(x, layer):
        if x is None:
            return None
        if not _is_reference_packed(x):
            return tensor_from_numpy(
                x if layer is None else _array(x)[layer], dev)
        shape = tuple(x.shape) if layer is None else tuple(x.shape)[1:]
        bufs = tuple(tensor_from_numpy(
            b if layer is None else _array(b)[layer], dev)
            for b in x.buffers)
        if x.scheme == "column" and layer is not None:
            bufs = _trim_column_pad(tuple(x.names), bufs)
        meta = tuple(_layer_meta(x.meta, layer))
        return PackedTensor(x.scheme, shape, tuple(x.names), bufs, meta)

    return _per_layer(np_tree, cfg, leaf)


def _layer_meta(meta, layer: Optional[int]):
    """One layer's meta entries of a (stacked) reference-layout leaf."""
    for k, v in meta:
        if k.startswith("plan:") or k == "plan_mode":
            continue
        if k.startswith(PLAN_META) and isinstance(v, str) and (
                layer is not None and LAYER_SEP in v):
            v = v.split(LAYER_SEP)[layer]
            if not v:
                continue
        yield k, v


def _stack_meta(layers: List[PackedTensor]):
    """Layer 0's meta, its plan entries replaced by every layer's."""
    metas = [dict(pt.meta) for pt in layers]
    keys = [k for k, _ in layers[0].meta if not k.startswith(PLAN_META)]
    plan_keys = list(dict.fromkeys(
        k for m in metas for k in m if k.startswith(PLAN_META)))
    out = [(k, metas[0][k]) for k in keys]
    for k in plan_keys:
        vals = [m.get(k, "") for m in metas]
        out.append((k, vals[0] if len(set(vals)) == 1
                    else LAYER_SEP.join(vals)))
    return tuple(out)


def _trim_column_pad(names, bufs):
    """One layer of a stacked column leaf, without the stacking's padding.

    A stacked leaf pads every layer to the largest kept-row count with
    index-0 rows of zero weight after its kept rows, which ascend; so any
    index 0 past the first row is padding. Cutting it off gives the layer
    exactly as it was packed alone: the same contraction length K, hence
    the same kernel plan and the same bits as serving it unsaved.
    """
    kept, wp = bufs[names.index("kept_idx")], bufs[names.index("w_packed")]
    n = 1 + int(torch.count_nonzero(kept[1:]))
    if n == kept.shape[0] or bool(wp[n:].any()):
        return bufs
    return tuple(b[:n].contiguous() for b in bufs)


# ------------------------------------------------------------ port -> disk

def _stack_packed(layers: List[PackedTensor]) -> PackedTensor:
    """Per-layer packed leaves -> one with a leading layer axis. Column
    leaves that kept different row counts are padded to the largest with
    index-0 rows of zero weight, as the reference's stacked pack does."""
    first = layers[0]
    bufs = []
    for i, name in enumerate(first.names):
        parts = [pt.buffers[i].detach().to("cpu") for pt in layers]
        if first.scheme == "column":
            kmax = max(p.shape[0] for p in parts)
            parts = [torch.cat([p, p.new_zeros((kmax - p.shape[0],)
                                               + tuple(p.shape[1:]))])
                     for p in parts]
        bufs.append(torch.stack(parts))
    return PackedTensor(first.scheme, (len(layers),) + tuple(first.shape),
                        first.names, tuple(bufs), _stack_meta(layers))


def _stack(leaves: List[Any]) -> Any:
    if all(x is None for x in leaves):
        return None
    if isinstance(leaves[0], PackedTensor):
        if not all(isinstance(x, PackedTensor) and x.scheme == leaves[0].scheme
                   for x in leaves):
            raise ValueError("a stacked leaf is packed in some layers and "
                             "not in others")
        return _stack_packed(leaves)
    return torch.stack([x.detach().to("cpu") for x in leaves])


def _stack_tree(layers: List[Any]) -> Any:
    first = layers[0]
    if isinstance(first, dict):
        return {k: _stack_tree([layer[k] for layer in layers]) for k in first}
    return _stack(layers)


def _to_cpu(x: Any) -> Any:
    if isinstance(x, PackedTensor):
        return PackedTensor(x.scheme, x.shape, x.names,
                            tuple(b.detach().to("cpu") for b in x.buffers),
                            x.meta)
    return x.detach().to("cpu") if isinstance(x, torch.Tensor) else x


def tree_to_jax(tree: Any) -> Any:
    """The port's tree (params, packed params or masks) in the reference's
    layout, on the CPU: an LM's ``blocks`` list becomes one dict of
    ``(L, ...)`` leaves, ``PackedTensor`` buffers stacked the same way;
    any other tree (a CNN's) is copied leaf by leaf."""
    if isinstance(tree, dict) and isinstance(tree.get("blocks"), list):
        return {k: (_stack_tree(v) if k == "blocks" else _convert(v, _to_cpu))
                for k, v in tree.items()}
    return _convert(tree, _to_cpu)
