"""Straggler detection (copied from ``repro/runtime/straggler.py``).

In a synchronous-SPMD program a straggling host delays every step (the
collectives act as a barrier). Detection is therefore a *time-series*
problem on the step watermark: we keep a robust running estimate (median +
MAD) of step time and flag steps exceeding ``threshold`` deviations.
Mitigation on a real fleet: report the slow host to the scheduler and
swap in a hot spare — here the hook is a callback.

Flagged samples are EXCLUDED from the median/MAD window.  Folding them
in lets a sustained slowdown inflate the baseline: after ~window/2
straggling steps the median has drifted up to the degraded speed and
follow-on stragglers read as normal.  The window must model *healthy*
step time, so outliers are observed (event, counter, histogram) but
never absorbed.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, Deque, Dict, List, Optional

from .telemetry import get_registry


@dataclasses.dataclass
class StragglerEvent:
    step: int
    seconds: float
    median: float
    deviation: float


class StragglerMonitor:
    def __init__(self, window: int = 50, threshold: float = 3.0,
                 on_straggler: Optional[Callable[[StragglerEvent], None]] = None):
        self.window: Deque[float] = deque(maxlen=window)
        self.threshold = threshold
        self.on_straggler = on_straggler
        self.events: List[StragglerEvent] = []
        self.samples = 0

    @staticmethod
    def _median(xs: List[float]) -> float:
        s = sorted(xs)
        n = len(s)
        return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])

    def record(self, step: int, seconds: float) -> Optional[StragglerEvent]:
        self.samples += 1
        reg = get_registry()
        reg.histogram("straggler.step_seconds").observe(seconds)
        if len(self.window) >= 8:
            med = self._median(list(self.window))
            mad = self._median([abs(x - med) for x in self.window]) or 1e-9
            dev = (seconds - med) / (1.4826 * mad)
            if dev > self.threshold:
                ev = StragglerEvent(step, seconds, med, dev)
                self.events.append(ev)
                reg.counter("straggler.events_total").inc()
                if self.on_straggler:
                    self.on_straggler(ev)
                # flagged sample stays OUT of the window — see module doc
                return ev
        self.window.append(seconds)
        return None

    def snapshot(self) -> Dict[str, object]:
        """Current state for the telemetry layer / engine stats."""
        win = list(self.window)
        return {
            "samples": self.samples,
            "events": len(self.events),
            "window_len": len(win),
            "median": self._median(win) if win else 0.0,
            "threshold": self.threshold,
            "last_event": dataclasses.asdict(self.events[-1])
            if self.events else None,
        }
