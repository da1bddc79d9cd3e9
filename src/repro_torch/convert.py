"""Bring the JAX package's parameters and packed buffers into the port.

The caller hands trees of numpy arrays (``jax.device_get`` of the
reference's params, or its packed tree with buffers as numpy). For an LM
(``cfg`` given) the reference keeps a leading ``(L, ...)`` layer axis under
``blocks`` and these functions return the port's trees with one entry per
layer; a CNN's tree (``cfg`` None) has no stacked axis, its ``layers`` are
already a list, and it converts leaf by leaf. This module
imports neither jax nor ``repro``: a reference ``PackedTensor`` is read by
its attributes (``scheme``, ``shape``, ``names``, ``buffers``, ``meta``).
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.sparse.packed import PackedTensor


def tensor_from_numpy(a: Any, device: torch.device) -> torch.Tensor:
    """numpy -> torch; bf16 (``ml_dtypes.bfloat16``, which
    ``torch.from_numpy`` refuses) goes through its uint16 bits."""
    a = np.array(a, order="C")       # a writable copy torch may own
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


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
    """Reference params (numpy; an LM's blocks stacked) -> the port's."""
    dev = resolve_device(device)
    return _per_layer(np_tree, cfg, lambda a, layer: tensor_from_numpy(
        a if layer is None else np.asarray(a)[layer], dev))


def packed_from_jax(np_tree: Any, cfg: Optional[ModelConfig],
                    device: DeviceLike = None) -> Any:
    """Reference packed params (buffers as numpy) -> the port's packed tree.

    Tuned ``plan:*`` and ``plan_mode`` meta entries are dropped: they were
    chosen for a CPU or a TPU.
    """
    dev = resolve_device(device)

    def leaf(x, layer):
        if not _is_reference_packed(x):
            a = np.asarray(x)
            return tensor_from_numpy(a if layer is None else a[layer], dev)
        shape = tuple(x.shape) if layer is None else tuple(x.shape)[1:]
        bufs = tuple(tensor_from_numpy(
            np.asarray(b) if layer is None else np.asarray(b)[layer], dev)
            for b in x.buffers)
        meta = tuple((k, v) for k, v in x.meta
                     if not (k.startswith("plan:") or k == "plan_mode"))
        return PackedTensor(x.scheme, shape, tuple(x.names), bufs, meta)

    return _per_layer(np_tree, cfg, leaf)
