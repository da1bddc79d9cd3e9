"""Model construction entry point: config -> LM (mirrors
``repro/models/model.py``)."""

from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike
from repro_torch.models.transformer import LM


def build_model(config: ModelConfig, *, device: DeviceLike = None) -> LM:
    """The LM of ``config``: ``ValueError`` for a family the reference
    does not know, ``NotImplementedError`` for one not ported yet."""
    return LM(config, device=device)
