"""Fault tolerance at two granularities (mirrors
``repro/runtime/fault_tolerance.py``; pure Python over the port's
``CheckpointManager``).

``FaultTolerantLoop`` drives a training loop of steps:

  1. every step is a pure function of (state, step_index) — data is
     regenerated from (seed, step), so restart-exactness holds;
  2. periodic checkpoints via CheckpointManager (atomic, rotated);
  3. on any step exception the loop restores the latest checkpoint and
     continues — bounded retries to avoid crash loops;
  4. step watermarks feed the StragglerMonitor.

``StagedRun`` drives a pipeline of named stages (``launch/pipeline.py``:
teacher → prune → retrain → pack → MIA → save) with per-stage retries, a
``progress.json`` ledger and resume by skipping completed stages.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.checkpoint import CheckpointManager
from repro_torch.runtime.straggler import StragglerMonitor
from repro_torch.runtime.telemetry import get_registry

log = logging.getLogger(__name__)


@dataclasses.dataclass
class StepResult:
    step: int
    metrics: Dict[str, float]
    seconds: float


class FaultTolerantLoop:
    def __init__(
        self,
        *,
        manager: CheckpointManager,
        save_every: int = 100,
        max_restarts: int = 3,
        straggler: Optional[StragglerMonitor] = None,
    ):
        self.manager = manager
        self.save_every = save_every
        self.max_restarts = max_restarts
        self.straggler = straggler or StragglerMonitor()

    def run(
        self,
        state: Any,
        step_fn: Callable[[Any, int], tuple],
        *,
        start_step: int = 0,
        num_steps: int = 100,
        restore_fn: Optional[Callable[[Any, int], Any]] = None,
        on_step: Optional[Callable[[StepResult], None]] = None,
    ) -> Any:
        """Run ``num_steps`` of ``step_fn(state, step) -> (state, metrics)``.

        ``restore_fn(state_template, step) -> state`` rebuilds device state
        from the checkpoint (used after a failure). Returns the final state.
        """
        step = start_step
        restarts = 0
        while step < start_step + num_steps:
            t0 = time.perf_counter()
            try:
                state, metrics = step_fn(state, step)
            except Exception as e:  # noqa: BLE001 — any device/step failure
                restarts += 1
                log.warning("step %d failed (%s); restart %d/%d",
                            step, e, restarts, self.max_restarts)
                if restarts > self.max_restarts:
                    raise
                latest = self.manager.latest_step()
                if latest is None:
                    raise
                if restore_fn is None:
                    raise
                state = restore_fn(state, latest)
                step = latest
                continue
            dt = time.perf_counter() - t0
            self.straggler.record(step, dt)
            if on_step:
                on_step(StepResult(step, metrics, dt))
            step += 1
            if step % self.save_every == 0:
                self.manager.save(step, state, extra={"step": step})
        return state


# --------------------------------------------------------------------------
# Stage-granularity fault tolerance (pipelines, not training steps)


@dataclasses.dataclass
class StageRecord:
    name: str
    status: str                       # "ok" | "failed"
    attempts: int
    seconds: float
    error: Optional[str] = None


class StageError(RuntimeError):
    """A pipeline stage exhausted its retries. Carries which stage and the
    last cause, so a batch run can report precisely and move on."""

    def __init__(self, stage: str, attempts: int, cause: BaseException):
        super().__init__(
            f"stage {stage!r} failed after {attempts} attempt(s): {cause}")
        self.stage = stage
        self.attempts = attempts
        self.cause = cause


class StagedRun:
    """``FaultTolerantLoop``'s contract at PIPELINE granularity.

    A pipeline (e.g. ``launch/pipeline.run_arch``: teacher → prune →
    retrain → pack → MIA → save) is a short sequence of expensive, named
    stages — the step-indexed checkpoint loop above is the wrong shape
    for it. This runner takes ``fn(carry) -> carry`` stages in order with:

      * bounded per-stage retries (``max_retries`` EXTRA attempts after
        the first) — a transient fault in stage 4 re-runs stage 4 only,
        never the stages already completed (their results stay in the
        carry: stage-level resume within the run);
      * a terminal ``StageError`` naming the stage once retries are
        exhausted, so a batch run (``--arch all``) fails ONE unit and
        continues;
      * a progress file (JSON, atomically replaced after every stage)
        recording each stage's status/attempts/seconds — the post-mortem
        for a killed run, and the resume ledger: pass
        ``completed_stages()`` of a previous run as ``skip`` together
        with a carry rebuilt from its persisted outputs to resume a
        partially-finished unit across processes;
      * stage wall times fed to a ``StragglerMonitor`` (a stage running
        3+ MAD over the others' median is flagged, same policy as the
        training loop).
    """

    def __init__(self, name: str, *, max_retries: int = 1,
                 progress_path: Optional[str] = None,
                 straggler: Optional[StragglerMonitor] = None):
        if max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        self.name = name
        self.max_retries = max_retries
        self.progress_path = progress_path
        self.straggler = straggler
        self.records: List[StageRecord] = []

    @staticmethod
    def completed_stages(progress_path: str) -> List[str]:
        """Stage names a previous run finished, in order ([] if the file
        is missing/corrupt — resume degrades to a fresh run)."""
        try:
            with open(progress_path) as f:
                doc = json.load(f)
            return [r["name"] for r in doc.get("stages", [])
                    if r.get("status") == "ok"]
        except (OSError, ValueError, KeyError, TypeError):
            return []

    @staticmethod
    def invalidate_stage(progress_path: str, name: str) -> List[str]:
        """Drop ``name`` AND every later record from the ledger.

        The force-rerun seam: a completed-but-wrong stage (bad teacher
        checkpoint, stale prune config) would otherwise be skipped by
        resume forever. Later stages fall with it because they consumed
        its output. Atomic rewrite, same as ``_write_progress``; returns
        the stage names still marked ok (missing/corrupt ledger → []).
        """
        try:
            with open(progress_path) as f:
                doc = json.load(f)
            stages = list(doc.get("stages", []))
        except (OSError, ValueError, TypeError):
            return []
        keep = []
        for rec in stages:
            if rec.get("name") == name:
                break
            keep.append(rec)
        doc["stages"] = keep
        tmp = progress_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=1)
        os.replace(tmp, progress_path)
        return [r["name"] for r in keep if r.get("status") == "ok"]

    def _write_progress(self) -> None:
        if self.progress_path is None:
            return
        doc = {"name": self.name,
               "stages": [dataclasses.asdict(r) for r in self.records]}
        d = os.path.dirname(self.progress_path)
        if d:
            os.makedirs(d, exist_ok=True)
        tmp = self.progress_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=1)
        os.replace(tmp, self.progress_path)

    def run(self, carry: Any,
            stages: Sequence[Tuple[str, Callable[[Any], Any]]],
            *, skip: Sequence[str] = ()) -> Any:
        reg = get_registry()
        skip_set = set(skip)
        for i, (sname, fn) in enumerate(stages):
            if sname in skip_set:
                log.info("[%s] stage %s: resumed from previous run, "
                         "skipping", self.name, sname)
                # re-record in THIS run's ledger (attempts 0 = inherited)
                # so the rewritten progress file still marks it complete
                # and a third resume skips it again
                self.records.append(StageRecord(sname, "ok", 0, 0.0))
                self._write_progress()
                continue
            attempts = 0
            while True:
                attempts += 1
                t0 = time.perf_counter()
                try:
                    carry = fn(carry)
                    dt = time.perf_counter() - t0
                    break
                except Exception as e:  # noqa: BLE001 — fault boundary
                    dt = time.perf_counter() - t0
                    reg.counter("pipeline.stage_retries_total",
                                pipeline=self.name, stage=sname).inc()
                    reg.histogram("pipeline.stage_seconds",
                                  stage=sname, status="failed").observe(dt)
                    if attempts > self.max_retries:
                        self.records.append(StageRecord(
                            sname, "failed", attempts, round(dt, 3),
                            error=f"{type(e).__name__}: {e}"))
                        self._write_progress()
                        raise StageError(sname, attempts, e) from e
                    log.warning("[%s] stage %s failed (%s); retry %d/%d",
                                self.name, sname, e, attempts,
                                self.max_retries)
            if self.straggler is not None:
                self.straggler.record(i, dt)
            reg.histogram("pipeline.stage_seconds", stage=sname,
                          status="ok").observe(dt)
            self.records.append(StageRecord(sname, "ok", attempts,
                                            round(dt, 3)))
            self._write_progress()
        return carry
