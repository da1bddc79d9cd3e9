"""Sampling device-time profiler for the dispatch seam and the engines'
calls (the port of ``repro/runtime/profiler.py``).

It walls eager packed dispatches (``sparse/registry.py``'s
``dispatch_matmul`` / ``dispatch_conv``) and the engines' prefill and
decode calls (``serve/engine.py``), with the reference's rules:

  * DISABLED IS FREE — the default profiler is inert: the hooks reduce to
    one attribute check, add no launch, and never touch values (tokens
    are bit-identical on and off).
  * SAMPLING IS CHEAP — when active, a deterministic stride derived from
    ``sample_rate`` decides which calls are walled; the others pass
    straight through. On the card a wall is a CUDA event pair recorded on
    the current stream around the call; the pairs are read lazily, when
    ``report()`` runs or when ``PENDING_CAP`` pairs wait, so a wall never
    syncs the host. On the CPU a wall is the host clock around the call.
  * WARMUP IS DISCARDED — the first ``warmup`` walls per key are taken
    but not recorded.
  * A dispatch inside a CUDA graph capture is never walled (the
    counterpart of the reference's traced dispatch): its launches only
    run at a replay, and the registry passes it straight through.

Samples land in per-(kind, scheme, M-bucket, plan) rings (bounded: the
profiler's memory is O(keys), not O(calls)) and are mirrored into the
active ``MetricsRegistry``:

  profiler.dispatch_seconds{kind,scheme,bucket,plan}  histogram
  profiler.events_total{kind,scheme,bucket}           counter (eligible)
  profiler.samples_total{kind,scheme,bucket}          counter (recorded)
  profiler.bytes_streamed_total{kind,scheme}          counter

Bytes: a packed dispatch counts its packed buffers, the activation in and
the output out; an engine wall the params (prefill) or the KV cache bytes
times the steps (decode). ``report()`` returns one row per key.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import torch

from repro_torch.runtime.telemetry import MetricsRegistry, get_registry

Key = Tuple[str, str, int, str]   # (kind, scheme, m_bucket, plan)

PENDING_CAP = 4096     # event pairs kept unread before the profiler syncs


@dataclasses.dataclass
class _Reservoir:
    """Bounded ring of wall samples (seconds) for one profile key."""

    cap: int
    events: int = 0           # eligible calls seen (walled or not)
    walls: int = 0            # walls taken (warmup included)
    samples: int = 0          # walls recorded after the warmup discard
    bytes_per_call: float = 0.0
    values: List[float] = dataclasses.field(default_factory=list)
    _next: int = 0

    def add(self, seconds: float) -> None:
        self.samples += 1
        if len(self.values) < self.cap:
            self.values.append(seconds)
        else:                 # overwrite the oldest: a ring
            self.values[self._next] = seconds
            self._next = (self._next + 1) % self.cap

    def quantile(self, q: float) -> float:
        if not self.values:
            return 0.0
        s = sorted(self.values)
        i = min(len(s) - 1, max(0, int(round(q * (len(s) - 1)))))
        return s[i]


class KernelProfiler:
    """Sampling wall profiler.

    ``sample_rate`` in (0, 1] maps to a deterministic stride
    (``round(1/rate)``): no RNG, so two runs over the same call sequence
    wall the same calls. ``warmup`` walls per key are taken but
    discarded. A disabled profiler (``enabled=False``, the module
    default) does nothing and holds no state.
    """

    def __init__(self, *, enabled: bool = True, sample_rate: float = 1.0,
                 warmup: int = 1, reservoir: int = 256,
                 registry: Optional[MetricsRegistry] = None,
                 clock: Callable[[], float] = time.perf_counter):
        if not 0.0 < sample_rate <= 1.0:
            raise ValueError(f"sample_rate must be in (0, 1]: {sample_rate}")
        self.enabled = bool(enabled)
        self.sample_rate = float(sample_rate)
        self.stride = max(1, int(round(1.0 / sample_rate)))
        self.warmup = int(warmup)
        self.reservoir_cap = int(reservoir)
        self._registry = registry
        self._clock = clock
        self._res: Dict[Key, _Reservoir] = {}
        # unread CUDA walls: (key, start event, end event, bytes)
        self._pending: List[Tuple[Key, Any, Any, float]] = []

    # -- state ---------------------------------------------------------
    @property
    def active(self) -> bool:
        return self.enabled

    @property
    def registry(self) -> MetricsRegistry:
        return self._registry if self._registry is not None else get_registry()

    def reset(self) -> None:
        self._res.clear()
        self._pending.clear()

    def _reservoir(self, key: Key) -> _Reservoir:
        res = self._res.get(key)
        if res is None:
            res = self._res[key] = _Reservoir(cap=self.reservoir_cap)
        return res

    def _event(self, key: Key) -> Tuple[_Reservoir, bool]:
        """Count one eligible call -> (its ring, whether it is walled)."""
        res = self._reservoir(key)
        res.events += 1
        kind, scheme, bucket, _ = key
        self.registry.counter("profiler.events_total", kind=kind,
                              scheme=scheme, bucket=bucket).inc()
        return res, (res.events - 1) % self.stride == 0

    def _record(self, key: Key, seconds: float, nbytes: float) -> None:
        res = self._reservoir(key)
        res.add(seconds)
        res.bytes_per_call = float(nbytes)
        kind, scheme, bucket, plan = key
        reg = self.registry
        reg.histogram("profiler.dispatch_seconds", kind=kind, scheme=scheme,
                      bucket=bucket, plan=plan).observe(seconds)
        reg.counter("profiler.samples_total", kind=kind, scheme=scheme,
                    bucket=bucket).inc()
        if nbytes:
            reg.counter("profiler.bytes_streamed_total", kind=kind,
                        scheme=scheme).inc(float(nbytes))

    def flush(self) -> None:
        """Read every waiting CUDA wall (a wall may sit on another stream
        than the last, so each end event is waited for; a done one costs
        no wait)."""
        pending, self._pending = self._pending, []
        for key, start, end, nbytes in pending:
            end.synchronize()
            self._record(key, start.elapsed_time(end) * 1e-3, nbytes)

    # -- core wall -----------------------------------------------------
    def wall(self, kind: str, fn: Callable, args: tuple, *,
             scheme: str = "engine", bucket: int = 0, plan: str = "-",
             nbytes: float = 0.0) -> Any:
        """Call ``fn(*args)``; wall it when the per-key stride samples
        this event. Returns ``fn``'s result unchanged either way."""
        if not self.enabled:
            return fn(*args)
        key = (kind, scheme, int(bucket), plan)
        res, sampled = self._event(key)
        if not sampled:
            return fn(*args)
        t = next((a for a in args if isinstance(a, torch.Tensor)), None)
        cuda = (t is not None and t.is_cuda
                and not torch.cuda.is_current_stream_capturing())
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args)
            end.record()
        else:
            t0 = self._clock()
            out = fn(*args)
            dt = self._clock() - t0
        res.walls += 1
        if res.walls <= self.warmup:      # warm-up wall: discarded
            return out
        if not cuda:
            self._record(key, dt, nbytes)
            return out
        self._pending.append((key, start, end, float(nbytes)))
        if len(self._pending) >= PENDING_CAP:
            self.flush()
        return out

    def observe(self, kind: str, seconds: float, *, scheme: str = "engine",
                bucket: int = 0, plan: str = "-",
                nbytes: float = 0.0) -> None:
        """Record a wall the caller already measured at a host sync (the
        continuous engine's chunk). The warmup discard applies; sampling
        does not (the measurement is free)."""
        if not self.enabled:
            return
        key = (kind, scheme, int(bucket), plan)
        res, _ = self._event(key)
        res.walls += 1
        if res.walls <= self.warmup:
            return
        self._record(key, float(seconds), nbytes)

    # -- dispatch-seam hook (sparse/registry.py) -----------------------
    def wall_dispatch(self, kind: str, pt, m: int, plan: str,
                      fn: Callable, args: tuple) -> Any:
        """Wall one eager packed dispatch. Bytes streamed = packed
        buffers + activation in + output out, the output taken as m x
        ``pt.shape[-1]`` elements of x's dtype (the reference's count)."""
        from repro_torch.sparse.tune import m_bucket  # import cycle

        x = args[0]
        nbytes = (pt.packed_bytes() + x.numel() * x.element_size()
                  + m * int(pt.shape[-1]) * x.element_size())
        small = int(pt.meta_dict.get("small_m", 32))
        return self.wall(kind, fn, args, scheme=pt.scheme,
                         bucket=m_bucket(m, small), plan=plan, nbytes=nbytes)

    # -- reporting -----------------------------------------------------
    def report(self) -> List[Dict[str, Any]]:
        """One row per (kind, scheme, bucket, plan), median-based."""
        self.flush()
        rows = []
        for (kind, scheme, bucket, plan), res in sorted(self._res.items()):
            if not res.values:
                continue
            rows.append({
                "kind": kind, "scheme": scheme, "bucket": int(bucket),
                "plan": plan, "events": res.events, "samples": res.samples,
                "measured_ns": res.quantile(0.5) * 1e9,
                "p10_ns": res.quantile(0.10) * 1e9,
                "p90_ns": res.quantile(0.90) * 1e9,
                "bytes_per_call": res.bytes_per_call,
            })
        return rows


# -- the module-global profiler (mirrors telemetry.get_registry) ---------
_DISABLED = KernelProfiler(enabled=False)
_current: KernelProfiler = _DISABLED


def get_profiler() -> KernelProfiler:
    """The active profiler: inert unless inside ``profiler_scope`` or
    after ``set_profiler``."""
    return _current


def set_profiler(prof: Optional[KernelProfiler]) -> KernelProfiler:
    """Install ``prof`` (None restores the inert default); returns the
    previous profiler."""
    global _current
    prev = _current
    _current = prof if prof is not None else _DISABLED
    return prev


@contextlib.contextmanager
def profiler_scope(prof: Optional[KernelProfiler] = None,
                   **kwargs) -> Iterator[KernelProfiler]:
    """Activate a profiler for the dynamic extent of the block.

        with profiler_scope(sample_rate=0.5, warmup=2) as prof:
            engine.generate(reqs)
        rows = prof.report()
    """
    prof = prof if prof is not None else KernelProfiler(**kwargs)
    prev = set_profiler(prof)
    try:
        yield prof
    finally:
        set_profiler(prev)
