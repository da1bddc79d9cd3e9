"""Elastic scaling: re-plan the mesh when the healthy device set changes
(copied from ``repro/runtime/elastic.py``).

Checkpoints are saved unsharded (``checkpoint``), and every sharding in
the system is derived from LOGICAL axis rules (``parallel.sharding``),
so scaling in/out is:

    plan = replan_mesh(n_healthy)                 # choose new mesh shape
    mesh = init_device_mesh("cuda", plan.shape, mesh_dim_names=plan.axes)
    rules = default_rules(mesh)
    state = manager.restore(template, shardings=...)  # DTensor placements

Policy: keep the model axis fixed (TP degree is architecture-determined;
changing it changes per-op shapes and numerics), scale the data/pod axes.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    shape: Tuple[int, ...]
    axes: Tuple[str, ...]
    dropped: int                  # devices intentionally left idle


def replan_mesh(
    healthy_devices: int,
    *,
    model_parallel: int = 16,
    pod_size: int = 256,
) -> ElasticPlan:
    """Largest (pod, data, model) mesh that fits the healthy device set.

    data must stay a power-of-two divisor of pod_size/model for collective
    efficiency; surplus devices idle until the next replan.
    """
    if healthy_devices < model_parallel:
        raise ValueError(
            f"{healthy_devices} devices cannot host model_parallel={model_parallel}"
        )
    pods = max(1, healthy_devices // pod_size)
    per_pod = healthy_devices // pods
    data = 1
    while data * 2 * model_parallel <= per_pod:
        data *= 2
    used = pods * data * model_parallel
    if pods > 1:
        return ElasticPlan(
            shape=(pods, data, model_parallel),
            axes=("pod", "data", "model"),
            dropped=healthy_devices - used,
        )
    return ElasticPlan(
        shape=(data, model_parallel),
        axes=("data", "model"),
        dropped=healthy_devices - used,
    )
