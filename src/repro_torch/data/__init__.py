"""The client's step-indexed data pipelines (mirrors ``repro/data``)."""

from repro_torch.data.pipeline import (
    ClassificationPipeline,
    DataConfig,
    EmbeddingPipeline,
    TokenPipeline,
    make_pipeline_for,
)

__all__ = ["ClassificationPipeline", "DataConfig", "EmbeddingPipeline",
           "TokenPipeline", "make_pipeline_for"]
