"""Checkpoints on disk in the reference's format (mirrors
``repro/checkpoint``)."""

from repro_torch.checkpoint.checkpointer import (
    SCHEMA_VERSION,
    ArtifactError,
    CheckpointManager,
    load_pytree,
    restore_pytree,
    save_pytree,
    verify_checkpoint,
)

__all__ = ["SCHEMA_VERSION", "ArtifactError", "CheckpointManager",
           "load_pytree", "restore_pytree", "save_pytree", "verify_checkpoint"]
