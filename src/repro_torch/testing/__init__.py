"""Deterministic fault-injection utilities (``repro_torch.testing.chaos``,
mirroring ``repro.testing``).

Test-support code lives under the package (not ``tests/``) because the
chaos injectors are part of the reliability CONTRACT: ``launch/prune.py
--chaos-kill-at``, ``chip_smoke.py`` and any consumer hardening a
deployment drive the same seams the tests do.
"""

from repro_torch.testing.chaos import (
    ChaosKill,
    ScriptedClock,
    chunk_action_hook,
    corrupt_admm_checkpoint,
    corrupt_buffer,
    corrupt_manifest,
    corrupt_packed_index,
    kill_at_iteration,
    kv_poison_hook,
    nan_grad_poison,
    nan_poison_leaf,
)

__all__ = [
    "ChaosKill",
    "ScriptedClock",
    "chunk_action_hook",
    "corrupt_admm_checkpoint",
    "corrupt_buffer",
    "corrupt_manifest",
    "corrupt_packed_index",
    "kill_at_iteration",
    "kv_poison_hook",
    "nan_grad_poison",
    "nan_poison_leaf",
]
