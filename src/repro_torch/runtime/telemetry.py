"""Unified telemetry: a process-wide metrics registry + span tracer
(copied from ``repro/runtime/telemetry.py``; pure Python, the same code,
so the same operations give the same snapshot in both packages).

  * :class:`MetricsRegistry` — counters, gauges, and fixed-bucket
    log-spaced histograms.  Pure Python, label-aware (labels are kwargs
    frozen into the series key), and clock-injectable.
  * :class:`Tracer` — span-based structured tracing to schema-versioned
    JSONL.  Spans carry ids and parent ids so nesting is reconstructible
    offline; plain point events share the stream.
  * a process-wide default registry, scope-able via
    :func:`registry_scope` so runs and tests can measure without
    clobbering each other.

In the port the registry is written by the pruning loop
(``core/prune_state.py``: ``prune.*``), ``runtime.fault_tolerance
.StagedRun`` (``pipeline.*``), ``runtime.straggler`` (``straggler.*``)
and the serving engines (``serve/engine.py``: ``serve.*``;
``serve/speculative.py``: ``spec.*``; at their host syncs: nothing may
write from inside a captured CUDA graph, the registry is host Python).
The ``sparse.*`` and ``tune.*`` series are the reference's taxonomy,
with no writer in the port yet.

Metric-name taxonomy (dots group the subsystem, labels split series):

  serve.requests_total{engine,status}     counter  terminal dispositions
  serve.ttft_seconds{engine}              histogram  arrival → first token
  serve.tpot_seconds{engine}              histogram  per-token decode time
  serve.queue_wait_seconds{engine}        histogram  arrival → admission
  serve.chunk_seconds{engine}             histogram  decode micro-chunk wall
  serve.chunks_total{engine}              counter
  serve.busy_slot_steps_total /           counters  occupancy numerator /
      serve.total_slot_steps_total{engine}          denominator
  serve.quarantined_slots_total{engine}   counter
  serve.bind_fallbacks_total{engine}      counter
  spec.rounds_total / spec.drafted_total / spec.accepted_total /
      spec.demotions_total{engine}        counters  speculative loop
  sparse.dispatch_total{kind,scheme,bucket}      counter  trace-time
  sparse.plan_build_total{kind,scheme,plan}      counter  dispatches
  tune.search_seconds{kind,scheme}        histogram  autotune search wall
  straggler.events_total                  counter
  straggler.step_seconds                  histogram
  pipeline.stage_seconds{stage,status}    histogram  StagedRun stages
  pipeline.stage_retries_total{stage}     counter
  pipeline.stage_peak_device_bytes{stage} gauge  launch/pipeline.py, card
  prune.iterations_total / prune.recoveries_total  counters  ADMM loop
  prune.loss / prune.residual / prune.rho          gauges

Span taxonomy (``name`` field of trace records): ``request`` is the
root span per request (enqueue → terminal), with child events/spans
``enqueue``, ``admit`` (admission + slot prefill; its end is the
first-token time), ``first_token``, ``decode_chunk`` (one per micro-
chunk, engine-wide, listing the slots it advanced), and exactly one
terminal event per request — ``retire`` | ``shed`` | ``timeout`` |
``cancelled`` | ``failed`` | ``quarantine`` — matching the request's
``Result.status``.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import json
import math
import threading
import time
from typing import Any, Callable, Dict, IO, Iterator, List, Optional, Tuple

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "Span",
    "Telemetry",
    "TRACE_SCHEMA_VERSION",
    "Tracer",
    "default_bucket_edges",
    "get_registry",
    "registry_scope",
]

TRACE_SCHEMA_VERSION = 1

LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, Any]) -> LabelKey:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def default_bucket_edges(lo: float = 1e-4, hi: float = 100.0,
                         per_decade: int = 4) -> Tuple[float, ...]:
    """Log-spaced histogram edges, ``per_decade`` buckets per decade.

    Edges are the *upper-inclusive* bucket bounds (Prometheus ``le``
    semantics): an observation equal to an edge lands in that edge's
    bucket, observations above the last edge land in the implicit
    ``+Inf`` overflow bucket.  Edges are rounded through ``repr`` only
    by float math itself — the same value observed twice always lands
    in the same bucket, which the bucket-edge exactness test pins.
    """
    n = int(round(math.log10(hi / lo) * per_decade))
    edges = [lo * (10.0 ** (i / per_decade)) for i in range(n + 1)]
    return tuple(edges)


class Counter:
    """Monotonic counter.  ``inc`` only; never reset in place."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n


class Gauge:
    """Last-write-wins instantaneous value."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Fixed-bucket log-spaced histogram (upper-inclusive edges).

    ``counts`` has ``len(edges) + 1`` cells — the final cell is the
    ``+Inf`` overflow bucket.  ``observe`` is a ``bisect_left`` plus two
    adds: cheap enough for the decode hot loop.
    """

    __slots__ = ("edges", "counts", "count", "sum", "min", "max")

    def __init__(self, edges: Tuple[float, ...]) -> None:
        self.edges = edges
        self.counts = [0] * (len(edges) + 1)
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, v: float) -> None:
        v = float(v)
        self.counts[bisect.bisect_left(self.edges, v)] += 1
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v

    def quantile(self, q: float) -> float:
        """Bucket-upper-bound estimate of the q-quantile (0 if empty)."""
        if self.count == 0:
            return 0.0
        rank = q * self.count
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= rank and c:
                return self.edges[i] if i < len(self.edges) else self.max
        return self.max


class MetricsRegistry:
    """Named, labelled metric series with an injectable clock.

    Series are created on first touch (``counter``/``gauge``/
    ``histogram`` are get-or-create) and keyed by ``(name, labels)``.
    The registry is thread-safe at series-creation granularity; the
    individual record operations are plain attribute updates, safe
    under the GIL for the single-writer engines that use it.
    """

    def __init__(self, clock: Optional[Callable[[], float]] = None) -> None:
        self.clock = clock or time.perf_counter
        self._lock = threading.Lock()
        self._counters: Dict[Tuple[str, LabelKey], Counter] = {}
        self._gauges: Dict[Tuple[str, LabelKey], Gauge] = {}
        self._hists: Dict[Tuple[str, LabelKey], Histogram] = {}
        self._hist_edges: Dict[str, Tuple[float, ...]] = {}

    # -- series access -----------------------------------------------------

    def counter(self, name: str, **labels: Any) -> Counter:
        key = (name, _label_key(labels))
        c = self._counters.get(key)
        if c is None:
            with self._lock:
                c = self._counters.setdefault(key, Counter())
        return c

    def gauge(self, name: str, **labels: Any) -> Gauge:
        key = (name, _label_key(labels))
        g = self._gauges.get(key)
        if g is None:
            with self._lock:
                g = self._gauges.setdefault(key, Gauge())
        return g

    def histogram(self, name: str,
                  edges: Optional[Tuple[float, ...]] = None,
                  **labels: Any) -> Histogram:
        key = (name, _label_key(labels))
        h = self._hists.get(key)
        if h is None:
            with self._lock:
                if edges is not None:
                    self._hist_edges.setdefault(name, tuple(edges))
                use = self._hist_edges.setdefault(
                    name, default_bucket_edges())
                h = self._hists.setdefault(key, Histogram(use))
        return h

    def timer(self, name: str, **labels: Any) -> "_Timer":
        """``with reg.timer("tune.search_seconds", kind=...):`` sugar."""
        return _Timer(self, name, labels)

    # -- snapshots ---------------------------------------------------------

    def value(self, name: str, **labels: Any) -> float:
        """Counter/gauge lookup without creating the series (0 if absent)."""
        key = (name, _label_key(labels))
        if key in self._counters:
            return self._counters[key].value
        if key in self._gauges:
            return self._gauges[key].value
        return 0.0

    def sum_counter(self, name: str) -> float:
        """Sum a counter family across all label sets (0 if absent)."""
        return sum(c.value for (n, _), c in self._counters.items()
                   if n == name)

    def counter_family(self, name: str) -> Dict[LabelKey, float]:
        return {lk: c.value for (n, lk), c in self._counters.items()
                if n == name}

    def snapshot(self) -> Dict[str, Any]:
        """JSON-ready dump of every series (see telemetry_export)."""
        def fam(d: Dict[Tuple[str, LabelKey], Any],
                render: Callable[[Any], Any]) -> List[Dict[str, Any]]:
            return [{"name": n, "labels": dict(lk), **render(s)}
                    for (n, lk), s in sorted(d.items())]

        return {
            "schema": TRACE_SCHEMA_VERSION,
            "counters": fam(self._counters, lambda c: {"value": c.value}),
            "gauges": fam(self._gauges, lambda g: {"value": g.value}),
            "histograms": fam(self._hists, lambda h: {
                "edges": list(h.edges),
                "counts": list(h.counts),
                "count": h.count,
                "sum": h.sum,
                "min": None if h.count == 0 else h.min,
                "max": None if h.count == 0 else h.max,
            }),
        }


class _Timer:
    __slots__ = ("_reg", "_name", "_labels", "_t0")

    def __init__(self, reg: MetricsRegistry, name: str,
                 labels: Dict[str, Any]) -> None:
        self._reg = reg
        self._name = name
        self._labels = labels

    def __enter__(self) -> "_Timer":
        self._t0 = self._reg.clock()
        return self

    def __exit__(self, *exc: Any) -> None:
        self._reg.histogram(self._name, **self._labels).observe(
            self._reg.clock() - self._t0)


# ---------------------------------------------------------------------------
# Process-wide default registry, scope-able for tests and benches.
# ---------------------------------------------------------------------------

_DEFAULT = MetricsRegistry()
_current = _DEFAULT


def get_registry() -> MetricsRegistry:
    """The registry ambient instrumentation (sparse dispatch, straggler,
    prune loop, StagedRun) records into.  Engines with an explicit
    ``Telemetry`` use theirs instead."""
    return _current


@contextlib.contextmanager
def registry_scope(reg: Optional[MetricsRegistry] = None
                   ) -> Iterator[MetricsRegistry]:
    """Swap the process-wide registry for the duration of a block.

    ``with registry_scope() as reg:`` gives a fresh, empty registry and
    restores the previous one on exit — concurrent benches and tests
    each see only their own counts.
    """
    global _current
    prev = _current
    _current = reg if reg is not None else MetricsRegistry(clock=prev.clock)
    try:
        yield _current
    finally:
        _current = prev


# ---------------------------------------------------------------------------
# Span tracer → schema-versioned JSONL
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Span:
    """An open span; closed via the ``Tracer.span`` context manager or
    an explicit ``tracer.end(span)``."""

    span_id: int
    parent_id: Optional[int]
    name: str
    t_start: float
    attrs: Dict[str, Any]


class Tracer:
    """Append-only JSONL event stream with span begin/end bracketing.

    Record shapes (all carry ``schema`` + monotonic ``ts`` from the
    injected clock):

      {"schema":1,"kind":"span","name":...,"span":id,"parent":id|null,
       "ts":start,"dur":seconds, ...attrs}      — emitted at span END
      {"schema":1,"kind":"event","name":...,"parent":id|null,
       "ts":t, ...attrs}                        — point event

    Spans are emitted on close (a single line carries start + duration)
    so the stream stays one-line-per-fact like ``prune_state``'s
    trace.jsonl, and a reader never has to pair begin/end lines.
    Attribute keys must not collide with the reserved header keys.
    """

    _RESERVED = ("schema", "kind", "name", "span", "parent", "ts", "dur")

    def __init__(self, sink: Any,
                 clock: Optional[Callable[[], float]] = None) -> None:
        """``sink`` is a path (opened append) or a writable file object."""
        if hasattr(sink, "write"):
            self._fh: IO[str] = sink
            self._owns = False
        else:
            self._fh = open(sink, "a")
            self._owns = True
        self.clock = clock or time.perf_counter
        self._next_id = 1
        self._stack: List[int] = []
        self._lock = threading.Lock()

    # -- emission ----------------------------------------------------------

    def _emit(self, rec: Dict[str, Any]) -> None:
        line = json.dumps(rec, sort_keys=False)
        with self._lock:
            self._fh.write(line + "\n")

    def event(self, name: str, parent: Optional[int] = None,
              ts: Optional[float] = None, **attrs: Any) -> None:
        self._emit({
            "schema": TRACE_SCHEMA_VERSION,
            "kind": "event",
            "name": name,
            "parent": parent if parent is not None else
            (self._stack[-1] if self._stack else None),
            "ts": self.clock() if ts is None else ts,
            **attrs,
        })

    def begin(self, name: str, parent: Optional[int] = None,
              **attrs: Any) -> Span:
        with self._lock:
            sid = self._next_id
            self._next_id += 1
        if parent is None and self._stack:
            parent = self._stack[-1]
        return Span(span_id=sid, parent_id=parent, name=name,
                    t_start=self.clock(), attrs=dict(attrs))

    def end(self, span: Span, **attrs: Any) -> float:
        """Close a span; returns its duration (clock units)."""
        t_end = self.clock()
        dur = t_end - span.t_start
        span.attrs.update(attrs)
        self._emit({
            "schema": TRACE_SCHEMA_VERSION,
            "kind": "span",
            "name": span.name,
            "span": span.span_id,
            "parent": span.parent_id,
            "ts": span.t_start,
            "dur": dur,
            **span.attrs,
        })
        return dur

    def span_record(self, name: str, ts: float, dur: float,
                    parent: Optional[int] = None, **attrs: Any) -> int:
        """Emit an already-timed span in one shot (the engines time their
        chunk with the run clock and hand the measurement over, so the
        traced duration is EXACTLY the one the histograms observed)."""
        with self._lock:
            sid = self._next_id
            self._next_id += 1
        if parent is None and self._stack:
            parent = self._stack[-1]
        self._emit({
            "schema": TRACE_SCHEMA_VERSION,
            "kind": "span",
            "name": name,
            "span": sid,
            "parent": parent,
            "ts": ts,
            "dur": dur,
            **attrs,
        })
        return sid

    @contextlib.contextmanager
    def span(self, name: str, **attrs: Any) -> Iterator[Span]:
        """Nested-span context manager: children opened inside inherit
        this span as parent (per-tracer stack; engines are single-
        threaded through their run loop)."""
        s = self.begin(name, **attrs)
        self._stack.append(s.span_id)
        try:
            yield s
        finally:
            self._stack.pop()
            self.end(s)

    def flush(self) -> None:
        self._fh.flush()

    def close(self) -> None:
        self.flush()
        if self._owns:
            self._fh.close()


def read_trace(path: str) -> List[Dict[str, Any]]:
    """Load a trace JSONL file, skipping blank/corrupt tail lines (the
    same tolerant read discipline as prune_state's trace reader)."""
    out: List[Dict[str, Any]] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                continue
    return out


# ---------------------------------------------------------------------------
# Bundle handed to engines / launch entry points
# ---------------------------------------------------------------------------


class Telemetry:
    """What an engine takes: a registry plus an optional tracer.

    ``Telemetry(trace_path="t.jsonl")`` gives a private registry and a
    file tracer; ``Telemetry(metrics=get_registry())`` records into the
    process-wide registry with no tracing.  The engine clock (the same
    injectable ``clock=`` its ``generate`` accepts) should be passed so
    metrics, trace timestamps, and scheduler deadlines agree.
    """

    def __init__(self,
                 metrics: Optional[MetricsRegistry] = None,
                 tracer: Optional[Tracer] = None,
                 trace_path: Optional[str] = None,
                 clock: Optional[Callable[[], float]] = None) -> None:
        if tracer is None and trace_path is not None:
            tracer = Tracer(trace_path, clock=clock)
        self.metrics = metrics if metrics is not None \
            else MetricsRegistry(clock=clock)
        self.tracer = tracer
        if clock is not None:
            self.metrics.clock = clock
            if self.tracer is not None:
                self.tracer.clock = clock

    def close(self) -> None:
        if self.tracer is not None:
            self.tracer.close()
