"""Architecture registry of the port: the reference's dense-family archs,
its two embedding-input ones (vlm, audio) and its two MoE ones."""

from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.deepseek_moe_16b import CONFIG as _deepseek_moe_16b
from repro_torch.configs.granite_3_2b import CONFIG as _granite_3_2b
from repro_torch.configs.h2o_danube_1_8b import CONFIG as _h2o_danube_1_8b
from repro_torch.configs.hubert_xlarge import CONFIG as _hubert_xlarge
from repro_torch.configs.phi4_mini_3_8b import CONFIG as _phi4_mini_3_8b
from repro_torch.configs.pixtral_12b import CONFIG as _pixtral_12b
from repro_torch.configs.qwen2_1_5b import CONFIG as _qwen2_1_5b
from repro_torch.configs.qwen2_moe_a2_7b import CONFIG as _qwen2_moe_a2_7b

ARCHS: Dict[str, ModelConfig] = {
    c.name: c for c in (_qwen2_1_5b, _granite_3_2b, _h2o_danube_1_8b,
                        _phi4_mini_3_8b, _pixtral_12b, _hubert_xlarge,
                        _qwen2_moe_a2_7b, _deepseek_moe_16b)}


def get_config(name: str) -> ModelConfig:
    try:
        return ARCHS[name]
    except KeyError:
        known = ", ".join(sorted(ARCHS))
        raise KeyError(f"unknown arch '{name}'; known: [{known}]") from None


def reduced_config(name: str, **overrides) -> ModelConfig:
    """Small variant of an arch with the same topology knobs (mirrors
    ``repro.configs.reduced_config`` for the families the port has)."""
    cfg = get_config(name)
    small = dict(
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=max(1, min(cfg.num_kv_heads, 2)),
        head_dim=16,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=512,
        param_dtype="float32",
        remat="none",
    )
    if cfg.num_experts:
        small.update(num_experts=8,
                     num_shared_experts=min(2, cfg.num_shared_experts),
                     moe_top_k=min(2, cfg.moe_top_k), expert_d_ff=32)
    if cfg.sliding_window:
        small.update(sliding_window=32)
    small.update(overrides)
    return dataclasses.replace(cfg, **small)
