"""Production mesh construction (mirrors ``repro/launch/mesh.py``).

A FUNCTION, not a module-level constant: importing this module touches
no process group. The default process group must be initialised with
256 ranks (512 with ``multi_pod``) first: NCCL on a fleet of cards, or
the fake group of ``launch/dryrun.py`` to plan one without it.
"""

from __future__ import annotations


def make_production_mesh(multi_pod: bool = False, *,
                         device_type: str = "cuda"):
    """(16, 16) ("data", "model"), or (2, 16, 16) ("pod", "data",
    "model") with ``multi_pod``, on ``init_device_mesh``."""
    from torch.distributed.device_mesh import init_device_mesh

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)
