"""Input-shape cells and the meta-tensor ``input_specs`` of the dry-run
(mirrors ``repro/configs/shapes.py``).

The 4 shapes per arch:
    train_4k      seq 4,096  × gb 256   → traces the train step
    prefill_32k   seq 32,768 × gb 32    → traces prefill (encode for audio)
    decode_32k    seq 32,768 × gb 128   → traces decode_step (1 token, KV=32k)
    long_500k     seq 524,288 × gb 1    → decode_step; SSM/SWA/hybrid only

Skip rules: long_500k skipped for pure full-attention archs; decode
shapes skipped for encoder-only archs. ``applicable_shapes`` encodes
them; skipped cells are REPORTED (with reason) by the dry-run, not
silently dropped.

Where the reference hands out ``ShapeDtypeStruct``s, the port hands out
meta tensors (shape and dtype, no storage); with ``rules`` each is a
DTensor with its placements.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig
from repro_torch.models.layers import dtype_of


def skip_reason(cfg: ModelConfig, shape: ShapeConfig) -> Optional[str]:
    if cfg.encoder_only and shape.kind == "decode":
        return "encoder-only arch has no decode step"
    if shape.name == "long_500k":
        sub_quadratic = (
            cfg.family in ("ssm", "hybrid") or cfg.sliding_window is not None
        )
        if not sub_quadratic:
            return "pure full-attention arch; 500k decode needs sub-quadratic attention"
    return None


def applicable_shapes(cfg: ModelConfig):
    return [s for s in SHAPES.values() if skip_reason(cfg, s) is None]


def _meta(shape: Tuple[int, ...], dtype: torch.dtype, sharding=None):
    from repro_torch.parallel.sharding import shard

    return shard(torch.empty(shape, dtype=dtype, device="meta"), sharding)


def input_specs(
    cfg: ModelConfig,
    shape: ShapeConfig,
    *,
    rules=None,
) -> Dict[str, Any]:
    """Meta-tensor stand-ins for every model input of this cell.

    Returns {"kind": train|prefill|decode, **tensors}. With ``rules``
    (``parallel.AxisRules``) each is a DTensor with its placements, as
    the reference's structs carry their NamedShardings.
    """
    from repro_torch.parallel.sharding import logical_sharding

    B, S = shape.global_batch, shape.seq_len
    dt = dtype_of(cfg.param_dtype)

    def batch_sharding(ndim, shape):
        if rules is None:
            return None
        logical = [None] * ndim
        logical[0] = "batch"
        return logical_sharding(rules, logical, shape=shape)

    def inputs_of(S_in):
        if cfg.input_kind == "tokens":
            return _meta((B, S_in), torch.int32,
                         batch_sharding(2, (B, S_in)))
        return _meta((B, S_in, cfg.d_model), dt,
                     batch_sharding(3, (B, S_in, cfg.d_model)))

    if shape.kind == "train":
        labels = _meta((B, S), torch.int32, batch_sharding(2, (B, S)))
        return {"kind": "train",
                "batch": {"inputs": inputs_of(S), "labels": labels}}

    if shape.kind == "prefill":
        return {"kind": "prefill", "inputs": inputs_of(S), "seq_len": S}

    # decode: one new token against a cache of S
    from repro_torch.models import build_model
    from repro_torch.utils.tree import tree_map

    model = build_model(cfg, device="cpu").on_meta()
    cache = model.init_cache(B, S)
    if rules is not None:
        axes = model.cache_logical_axes(cache)
        cache = tree_map(
            lambda x, ax: _meta(tuple(x.shape), x.dtype, logical_sharding(
                rules, ax, shape=tuple(x.shape))), cache, axes)
    return {"kind": "decode", "cache": cache, "tokens": inputs_of(1)}
