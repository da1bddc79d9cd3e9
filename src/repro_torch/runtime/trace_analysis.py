"""Offline trace analysis (copied from ``repro/runtime/trace_analysis.py``;
pure Python over the port's ``read_trace``): per-request critical paths,
engine timeline, occupancy and SLO tables from a serving trace JSONL.

The engines record enough to reconstruct the registry's numbers offline
(their timestamps are on the engine clock); this module turns the same
events into operator-facing artifacts:

  * CRITICAL PATH per request: queue-wait (enqueue to admit), prefill
    (the admit span: solo prefill + first token), decode (first token to
    retire) and stall time (decode wall not covered by any decode_chunk
    span: scheduler gaps, admission pauses, arrival idling).
  * ASCII TIMELINE: wall time bucketed into columns; each column shaded
    by mean chunk occupancy (busy slot-steps / capacity), with admit and
    retire markers on gutter rows. ``straggler`` events show as ``!``.
  * SLO TABLES: quantiles of TTFT, queue wait, end-to-end latency and
    per-token decode time over retired requests.
  * CROSSCHECK: recompute TTFT/queue-wait sums and occupancy from the
    events and compare them to a ``MetricsRegistry`` exactly.

Works on any engine's trace; the per-request path analysis needs the
continuous engine's event vocabulary (enqueue/admit/first_token/retire
with arrivals), the only engine with per-request admission.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Union

from .telemetry import MetricsRegistry, read_trace

DEFAULT_QUANTILES = (0.5, 0.9, 0.99)


def _quantile(values: Sequence[float], q: float) -> float:
    """Nearest-rank-with-interpolation quantile (no numpy dependency:
    analysis must run anywhere the trace file can be read)."""
    if not values:
        return 0.0
    s = sorted(values)
    if len(s) == 1:
        return float(s[0])
    pos = q * (len(s) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(s) - 1)
    frac = pos - lo
    return float(s[lo] * (1.0 - frac) + s[hi] * frac)


@dataclasses.dataclass
class RequestPath:
    """Critical-path breakdown of one request's life in the engine."""

    uid: str
    status: str
    arrival: float
    admit_ts: Optional[float] = None
    first_token_ts: Optional[float] = None
    retire_ts: Optional[float] = None
    tokens: int = 0
    queue_wait_s: float = 0.0    # enqueue → admit
    prefill_s: float = 0.0       # admit span (solo prefill + first token)
    decode_s: float = 0.0        # first token → retire
    stall_s: float = 0.0         # decode wall not covered by chunk spans
    e2e_s: float = 0.0           # arrival → retire

    def breakdown(self) -> Dict[str, float]:
        return {"queue_wait_s": self.queue_wait_s,
                "prefill_s": self.prefill_s,
                "decode_s": self.decode_s,
                "stall_s": self.stall_s}


def _covered(start: float, end: float,
             spans: Sequence[Dict[str, Any]]) -> float:
    """Total time inside [start, end] covered by (sorted) chunk spans."""
    total = 0.0
    for sp in spans:
        s0, s1 = sp["ts"], sp["ts"] + sp["dur"]
        if s1 <= start:
            continue
        if s0 >= end:
            break
        total += min(s1, end) - max(s0, start)
    return total


class TraceAnalysis:
    """Parsed view of one trace; build with ``analyze``."""

    def __init__(self, events: List[Dict[str, Any]]):
        self.events = events
        by: Dict[str, List[Dict[str, Any]]] = {}
        for e in events:
            by.setdefault(e.get("name", "?"), []).append(e)
        self.by_name = by
        self.engines = sorted({e["engine"] for e in events if "engine" in e})
        self.chunks = sorted(by.get("decode_chunk", []),
                             key=lambda e: e["ts"])
        self.stragglers = by.get("straggler", [])
        self.requests = self._build_paths()
        busy = sum(c.get("busy", 0) for c in self.chunks)
        cap = sum(c.get("batch", 0) * c.get("steps", 0)
                  for c in self.chunks)
        self.occupancy = busy / cap if cap else 0.0

    # -- per-request critical paths ------------------------------------
    def _build_paths(self) -> List[RequestPath]:
        admits = {e["uid"]: e for e in self.by_name.get("admit", [])}
        firsts = {e["uid"]: e for e in self.by_name.get("first_token", [])}
        paths = []
        for e in sorted(self.by_name.get("retire", []),
                        key=lambda r: r.get("order", 0)):
            if "arrival" not in e:        # chunked-engine retire: no
                continue                  # per-request lifecycle events
            p = RequestPath(uid=e["uid"], status=e["status"],
                            arrival=e["arrival"], retire_ts=e["ts"],
                            tokens=int(e.get("tokens", 0)))
            adm = admits.get(p.uid)
            first = firsts.get(p.uid)
            if adm is not None:
                p.admit_ts = adm["ts"]
                p.queue_wait_s = max(adm["ts"] - p.arrival, 0.0)
                p.prefill_s = max(adm["dur"], 0.0)
            if first is not None:
                p.first_token_ts = first["ts"]
                p.decode_s = max(p.retire_ts - first["ts"], 0.0)
                p.stall_s = max(
                    p.decode_s - _covered(first["ts"], p.retire_ts,
                                          self.chunks), 0.0)
            p.e2e_s = max(p.retire_ts - p.arrival, 0.0)
            paths.append(p)
        return paths

    # -- SLO percentile tables -----------------------------------------
    def slo_table(self, quantiles: Sequence[float] = DEFAULT_QUANTILES,
                  ) -> Dict[str, Dict[str, float]]:
        served = [p for p in self.requests if p.first_token_ts is not None]
        metrics = {
            "ttft_s": [p.first_token_ts - p.arrival for p in served],
            "queue_wait_s": [p.queue_wait_s for p in served],
            "e2e_s": [p.e2e_s for p in self.requests],
            "decode_per_token_s": [p.decode_s / p.tokens
                                   for p in served if p.tokens],
        }
        table = {}
        for name, vals in metrics.items():
            row = {f"p{int(q * 100)}": _quantile(vals, q)
                   for q in quantiles}
            row["mean"] = sum(vals) / len(vals) if vals else 0.0
            row["count"] = float(len(vals))
            table[name] = row
        return table

    # -- ASCII engine timeline -----------------------------------------
    def timeline(self, width: int = 72) -> str:
        if not self.chunks:
            return "(no decode_chunk spans in trace)"
        # the wall must cover the marker rows too: an admit before the
        # first chunk or a retire at the final chunk edge still renders
        marked = (self.by_name.get("admit", [])
                  + self.by_name.get("retire", []) + self.stragglers)
        stamps = ([c["ts"] for c in self.chunks]
                  + [c["ts"] + c["dur"] for c in self.chunks]
                  + [e["ts"] for e in marked if "ts" in e])
        t0, t1 = min(stamps), max(stamps)
        span = max(t1 - t0, 1e-9)
        shades = " .:-=%#@"      # 8 occupancy levels, empty to full

        # column occupancy: overlap-weighted mean of chunk busy fractions
        occ = [0.0] * width
        wgt = [0.0] * width
        for c in self.chunks:
            cap = max(c.get("batch", 0) * c.get("steps", 0), 1)
            frac = c.get("busy", 0) / cap
            lo = int((c["ts"] - t0) / span * width)
            hi = int((c["ts"] + c["dur"] - t0) / span * width)
            for i in range(max(lo, 0), min(hi + 1, width)):
                occ[i] += frac
                wgt[i] += 1.0
        row = "".join(
            shades[min(int((occ[i] / wgt[i]) * (len(shades) - 1) + 0.5),
                       len(shades) - 1)] if wgt[i] else " "
            for i in range(width))

        def marks(events: Sequence[Dict[str, Any]], ch: str) -> str:
            cols = [" "] * width
            for e in events:
                if "ts" not in e:
                    continue
                # an event at exactly t1 lands in the last column
                i = min(int((e["ts"] - t0) / span * width), width - 1)
                if 0 <= i:
                    cols[i] = ch
            return "".join(cols)

        admit_row = marks(self.by_name.get("admit", []), "A")
        retire_row = marks(self.by_name.get("retire", []), "R")
        strag_row = marks(self.stragglers, "!")
        lines = [
            f"engine timeline ({', '.join(self.engines) or '?'}): "
            f"{span * 1e3:.1f} ms wall, occupancy {self.occupancy:.2f}",
            f"occupancy |{row}|",
            f"admits    |{admit_row}|",
            f"retires   |{retire_row}|",
        ]
        if self.stragglers:
            lines.append(f"straggler |{strag_row}|")
        return "\n".join(lines)

    # -- registry crosscheck -------------------------------------------
    def crosscheck(self, registry: MetricsRegistry,
                   engine: str = "continuous") -> Dict[str, Any]:
        """The trace must recompute the registry EXACTLY (same clock,
        same floats through JSON), verified over the analyzer's own
        parse."""
        def _close(a: float, b: float) -> bool:
            return abs(a - b) <= 1e-9 * max(1.0, abs(a), abs(b))

        firsts = self.by_name.get("first_token", [])
        admits = self.by_name.get("admit", [])
        h_ttft = registry.histogram("serve.ttft_seconds", engine=engine)
        h_qwait = registry.histogram("serve.queue_wait_seconds",
                                     engine=engine)
        off_ttft = sum(e["ts"] - e["arrival"] for e in firsts)
        off_qwait = sum(e["ts"] - e["arrival"] for e in admits)
        busy = sum(c.get("busy", 0) for c in self.chunks)
        total = sum(c.get("batch", 0) * c.get("steps", 0)
                    for c in self.chunks)
        reg_busy = registry.value("serve.busy_slot_steps_total",
                                  engine=engine) or 0
        reg_total = registry.value("serve.total_slot_steps_total",
                                   engine=engine) or 0
        out = {
            "ttft_count_matches": h_ttft.count == len(firsts),
            "ttft_sum_matches": _close(off_ttft, h_ttft.sum),
            "queue_wait_count_matches": h_qwait.count == len(admits),
            "queue_wait_sum_matches": _close(off_qwait, h_qwait.sum),
            "occupancy_matches": (busy == reg_busy and total == reg_total),
            "offline_ttft_sum_s": off_ttft,
            "offline_queue_wait_sum_s": off_qwait,
        }
        out["matches"] = all(v for k, v in out.items()
                             if k.endswith("_matches"))
        return out

    # -- serialization -------------------------------------------------
    def summary(self) -> Dict[str, Any]:
        status: Dict[str, int] = {}
        for p in self.requests:
            status[p.status] = status.get(p.status, 0) + 1
        return {
            "trace_events": len(self.events),
            "engines": self.engines,
            "requests": len(self.requests),
            "status_counts": status,
            "decode_chunks": len(self.chunks),
            "straggler_events": len(self.stragglers),
            "occupancy": self.occupancy,
            "total_stall_s": sum(p.stall_s for p in self.requests),
        }

    def to_dict(self) -> Dict[str, Any]:
        return {
            "schema": 1,
            "summary": self.summary(),
            "slo": self.slo_table(),
            "requests": [dataclasses.asdict(p) for p in self.requests],
        }


def analyze(trace: Union[str, Sequence[Dict[str, Any]]]) -> TraceAnalysis:
    """Build a ``TraceAnalysis`` from a trace path or parsed events."""
    events = read_trace(trace) if isinstance(trace, str) else list(trace)
    return TraceAnalysis(events)


def render(analysis: TraceAnalysis, width: int = 72,
           top_requests: int = 8) -> str:
    """Full human-readable report."""
    s = analysis.summary()
    lines = [
        f"trace: {s['trace_events']} events, {s['requests']} requests "
        f"({', '.join(f'{k}={v}' for k, v in sorted(s['status_counts'].items()))}), "
        f"{s['decode_chunks']} chunks, occupancy {s['occupancy']:.2f}, "
        f"stall {s['total_stall_s'] * 1e3:.1f} ms",
        "",
        analysis.timeline(width),
        "",
        "SLO percentiles (seconds):",
        f"  {'metric':<20s} {'p50':>10s} {'p90':>10s} {'p99':>10s} "
        f"{'mean':>10s} {'n':>5s}",
    ]
    for name, row in analysis.slo_table().items():
        lines.append(
            f"  {name:<20s} {row.get('p50', 0):10.4f} "
            f"{row.get('p90', 0):10.4f} {row.get('p99', 0):10.4f} "
            f"{row['mean']:10.4f} {int(row['count']):5d}")
    slowest = sorted(analysis.requests, key=lambda p: -p.e2e_s)
    if slowest:
        lines += ["", f"critical paths (slowest {min(top_requests, len(slowest))}):",
                  f"  {'uid':<14s} {'status':<9s} {'queue':>9s} "
                  f"{'prefill':>9s} {'decode':>9s} {'stall':>9s} "
                  f"{'e2e':>9s} {'tok':>5s}"]
        for p in slowest[:top_requests]:
            lines.append(
                f"  {str(p.uid):<14.14s} {str(p.status):<9s} "
                f"{p.queue_wait_s * 1e3:8.2f}m {p.prefill_s * 1e3:8.2f}m "
                f"{p.decode_s * 1e3:8.2f}m {p.stall_s * 1e3:8.2f}m "
                f"{p.e2e_s * 1e3:8.2f}m {p.tokens:5d}")
    return "\n".join(lines)
