"""Scale-out on ``torch.distributed`` (mirrors ``repro/parallel``): the
logical-axis sharding rules and their DTensor placements."""

from repro_torch.parallel.sharding import (
    AxisRules,
    NamedSharding,
    axis_rules,
    batch_spec,
    constrain,
    current_rules,
    default_rules,
    logical_sharding,
    param_shardings,
    placements,
)

__all__ = ["AxisRules", "NamedSharding", "axis_rules", "batch_spec",
           "constrain", "current_rules", "default_rules",
           "logical_sharding", "param_shardings", "placements"]
