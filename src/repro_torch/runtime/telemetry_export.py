"""Exporters for :mod:`repro_torch.runtime.telemetry` snapshots (copied
from ``repro/runtime/telemetry_export.py``).

Two formats:

  * :func:`to_prometheus` — the text exposition format scrapers expect
    (``# HELP``/``# TYPE`` headers from :data:`METRIC_HELP`,
    ``_bucket{le=...}`` cumulative histogram series,
    ``_sum``/``_count``).  Metric names are sanitised from the
    registry's dotted taxonomy (``serve.ttft_seconds`` →
    ``serve_ttft_seconds``).
  * :func:`to_json` / :func:`write_json` — the registry's raw snapshot
    plus a stamp (wall-clock time, schema version), which is what
    ``launch/pipeline.py`` writes beside each arch's ``progress.json``.

Both operate on a snapshot dict (``MetricsRegistry.snapshot()``) or a
live registry, so offline tools can re-render persisted snapshots.
"""

from __future__ import annotations

import json
import time
from typing import Any, Dict, Union

from .telemetry import MetricsRegistry, TRACE_SCHEMA_VERSION

__all__ = ["METRIC_HELP", "to_json", "to_prometheus", "write_json",
           "write_prometheus"]

# ``# HELP`` text per dotted metric name — the scraper-facing doc line.
# Keyed by the registry taxonomy (see runtime/telemetry.py); metrics
# without an entry get a generic pointer rather than silence, so every
# exported family carries BOTH header lines.
METRIC_HELP: Dict[str, str] = {
    "serve.requests_total":
        "Terminal request dispositions by engine and status.",
    "serve.ttft_seconds":
        "Time to first token: request arrival to first emitted token.",
    "serve.tpot_seconds":
        "Per-output-token decode time of retired requests.",
    "serve.queue_wait_seconds":
        "Request arrival to slot admission (scheduler queue time).",
    "serve.chunk_seconds":
        "Wall time of one decode micro-chunk (device + host sync).",
    "serve.chunks_total":
        "Decode micro-chunks dispatched.",
    "serve.busy_slot_steps_total":
        "Slot-steps that emitted tokens (occupancy numerator).",
    "serve.total_slot_steps_total":
        "Slot-steps of capacity offered (occupancy denominator).",
    "serve.quarantined_slots_total":
        "Batch slots quarantined after non-finite decode output.",
    "serve.bind_fallbacks_total":
        "Packed leaves served dense after a bind integrity fallback.",
    "spec.rounds_total":
        "Speculative draft-verify rounds executed.",
    "spec.drafted_total":
        "Tokens proposed by the drafter.",
    "spec.accepted_total":
        "Drafted tokens accepted by target verification.",
    "spec.dispatches_total":
        "Device dispatches issued by the speculative engine.",
    "sparse.dispatch_total":
        "Packed-kernel dispatches by kind, scheme and M-bucket "
        "(trace-time: per compiled graph, not per step).",
    "sparse.plan_build_total":
        "Kernel execution plans built (jit closures), by resolved plan.",
    "prune.iterations_total":
        "ADMM pruning iterations completed.",
    "prune.divergence_recoveries_total":
        "Bounded-divergence recoveries taken by the pruning loop.",
    "straggler.step_seconds":
        "Observed step walls feeding the straggler median/MAD window.",
    "straggler.events_total":
        "Steps flagged as stragglers (deviation above threshold).",
    "profiler.dispatch_seconds":
        "Sampled block_until_ready walls by kind, scheme, M-bucket "
        "and plan (warmup-discarded).",
    "profiler.events_total":
        "Profiler-eligible calls seen (sampled or not).",
    "profiler.samples_total":
        "Calls actually walled and recorded after warmup discard.",
    "profiler.bytes_streamed_total":
        "Bytes streamed by sampled calls: packed weights + indices, "
        "activations, outputs, KV bytes per chunk.",
}


def _help_text(dotted: str) -> str:
    return METRIC_HELP.get(
        dotted, "No description registered; see the metric taxonomy in "
                "repro_torch/runtime/telemetry.py.")


def _snap(reg: Union[MetricsRegistry, Dict[str, Any]]) -> Dict[str, Any]:
    return reg.snapshot() if isinstance(reg, MetricsRegistry) else reg


def _name(dotted: str) -> str:
    out = []
    for ch in dotted:
        out.append(ch if ch.isalnum() or ch == "_" else "_")
    name = "".join(out)
    return name if not name[:1].isdigit() else "_" + name


def _labels(labels: Dict[str, str], extra: str = "") -> str:
    parts = [f'{_name(k)}="{v}"' for k, v in sorted(labels.items())]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def to_prometheus(reg: Union[MetricsRegistry, Dict[str, Any]]) -> str:
    """Render a registry (or persisted snapshot) as Prometheus text."""
    snap = _snap(reg)
    lines = []
    typed = set()

    def header(name: str, kind: str, dotted: str) -> None:
        if name not in typed:
            typed.add(name)
            # HELP precedes TYPE, once per family (exposition format)
            lines.append(f"# HELP {name} {_help_text(dotted)}")
            lines.append(f"# TYPE {name} {kind}")

    for c in snap.get("counters", ()):
        name = _name(c["name"])
        header(name, "counter", c["name"])
        lines.append(f"{name}{_labels(c['labels'])} {c['value']:g}")
    for g in snap.get("gauges", ()):
        name = _name(g["name"])
        header(name, "gauge", g["name"])
        lines.append(f"{name}{_labels(g['labels'])} {g['value']:g}")
    for h in snap.get("histograms", ()):
        name = _name(h["name"])
        header(name, "histogram", h["name"])
        cum = 0
        for edge, n in zip(h["edges"], h["counts"]):
            cum += n
            le = 'le="%g"' % edge
            lines.append(f"{name}_bucket{_labels(h['labels'], le)} {cum}")
        cum += h["counts"][len(h["edges"])]
        le = 'le="+Inf"'
        lines.append(f"{name}_bucket{_labels(h['labels'], le)} {cum}")
        lines.append(f"{name}_sum{_labels(h['labels'])} {h['sum']:g}")
        lines.append(f"{name}_count{_labels(h['labels'])} {h['count']}")
    return "\n".join(lines) + "\n"


def to_json(reg: Union[MetricsRegistry, Dict[str, Any]],
            **stamp: Any) -> Dict[str, Any]:
    """Snapshot + stamp (wall-clock ``written_at`` is always added)."""
    return {
        "schema": TRACE_SCHEMA_VERSION,
        "written_at": time.time(),
        **stamp,
        "metrics": _snap(reg),
    }


def write_json(path: str, reg: Union[MetricsRegistry, Dict[str, Any]],
               **stamp: Any) -> None:
    with open(path, "w") as f:
        json.dump(to_json(reg, **stamp), f, indent=1)


def write_prometheus(path: str,
                     reg: Union[MetricsRegistry, Dict[str, Any]]) -> None:
    with open(path, "w") as f:
        f.write(to_prometheus(reg))
