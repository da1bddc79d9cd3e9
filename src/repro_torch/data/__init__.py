"""The client's step-indexed data pipelines (mirrors ``repro/data``)."""

from repro_torch.data.pipeline import (
    ClassificationPipeline,
    DataConfig,
    TokenPipeline,
)

__all__ = ["ClassificationPipeline", "DataConfig", "TokenPipeline"]
