"""Runtime reliability and observability (mirrors ``repro/runtime``).

What the port has: the fault-tolerant step loop and the staged pipeline
runner (``fault_tolerance``), straggler detection (``straggler``), the
metrics registry and span tracer (``telemetry``) with its JSON and
Prometheus exporters (``telemetry_export``), the offline reader of a
serving trace (``trace_analysis``) and the sampling kernel profiler
(``profiler``: inert unless a ``profiler_scope`` is open) and the
elastic mesh re-plan (``elastic``). The registry is host Python, written
by the pruning loop, ``StagedRun``, the straggler monitor and the serving
engines at their host syncs; never from inside a captured CUDA graph.
"""

from repro_torch.runtime import telemetry_export, trace_analysis
from repro_torch.runtime.elastic import ElasticPlan, replan_mesh
from repro_torch.runtime.fault_tolerance import (
    FaultTolerantLoop,
    StagedRun,
    StageError,
    StageRecord,
    StepResult,
)
from repro_torch.runtime.profiler import (
    KernelProfiler,
    get_profiler,
    profiler_scope,
    set_profiler,
)
from repro_torch.runtime.straggler import StragglerMonitor
from repro_torch.runtime.telemetry import (
    MetricsRegistry,
    Telemetry,
    Tracer,
    get_registry,
    registry_scope,
)

__all__ = [
    "ElasticPlan", "FaultTolerantLoop", "KernelProfiler", "MetricsRegistry", "StageError",
    "StageRecord", "StagedRun", "StepResult", "StragglerMonitor",
    "Telemetry", "Tracer", "get_profiler", "get_registry",
    "profiler_scope", "registry_scope", "replan_mesh", "set_profiler",
    "telemetry_export",
    "trace_analysis",
]
