"""Resumable, self-healing ADMM run state (mirrors
``repro/core/prune_state.py``).

Every ADMM entry point of ``core`` (``PrivacyPreservingPruner`` and
``admm_task_prune``) runs one shared loop, ``run_admm_loop``, which is:

  RESUMABLE    the whole run state (params W, ``ADMMVars`` Z/U, the run's
               key, the iteration counter, the recovery overrides and the
               per-iteration ``history``) commits through the reference's
               CRC32 schema-v2 checkpoints every ``save_every``
               iterations. A killed run resumed from its latest checkpoint
               is BIT-IDENTICAL to an uninterrupted one: each iteration's
               synthetic batch comes from a generator seeded by a key
               derived from the saved key alone, real batches from the
               iteration index, and tensors round-trip exactly.
  SELF-HEALING a health check on loss / primal / dual residual raises
               ``PruneDivergence`` on non-finite or exploding iterates;
               the loop rolls back to the last good checkpoint (or the
               start), backs the lr off, switches rho to residual
               balancing (``adaptive_rho``) and retries, at most
               ``HealthPolicy.max_recoveries`` times.
  DIAGNOSABLE  every iteration and lifecycle event is appended to
               ``trace.jsonl`` beside the checkpoints.

The run's key is an int64 tensor. Iteration k splits it with splitmix64
(``serve/sampler.py``'s ``fold_in``): ``fold_in(key, 0)`` is the key of
iteration k + 1 and ``fold_in(key, 1)`` seeds iteration k's batch, so no
generator state needs saving. A checkpoint is trusted only if its
``run_fingerprint`` (CRC32 of the initial weights and the config) matches
the run's. Each committed iteration also lands in the ambient metrics
registry (``runtime.telemetry``): ``prune.iterations_total``, the
``prune.loss`` / ``residual`` / ``dual_residual`` / ``rho`` gauges, and
``prune.recoveries_total`` per rollback, from the Python floats the loop
already holds (no device sync of its own).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import math
import os
import time
import zlib
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.checkpoint import (
    ArtifactError,
    CheckpointManager,
    restore_pytree,
)
from repro_torch.checkpoint.checkpointer import _to_numpy
from repro_torch.core import admm
from repro_torch.runtime.telemetry import get_registry
from repro_torch.utils.tree import tree_leaves

log = logging.getLogger(__name__)

TRACE_FILE = "trace.jsonl"
HISTORY_KEYS = ("loss", "residual", "dual_residual", "rho")


class PruneDivergence(RuntimeError):
    """An ADMM run produced non-finite or exploding iterates.

    ``iteration`` is where it was detected, ``metric`` / ``value`` name
    the offending diagnostic, ``recoveries`` counts the rollbacks already
    used.
    """

    def __init__(self, message: str, *, iteration: int,
                 metric: Optional[str] = None, value: Any = None,
                 recoveries: int = 0):
        self.iteration = iteration
        self.metric = metric
        self.value = value
        self.recoveries = recoveries
        detail = [f"iteration={iteration}"]
        if metric is not None:
            detail.append(f"metric={metric}")
        if value is not None:
            detail.append(f"value={value}")
        if recoveries:
            detail.append(f"recoveries={recoveries}")
        super().__init__(f"{message} [{', '.join(detail)}]")


@dataclasses.dataclass(frozen=True)
class HealthPolicy:
    """Divergence detection and bounded recovery.

    ``explode_factor`` compares |loss| with the largest |loss| of the
    trailing ``warmup_iters`` iterations (silent before that many);
    ``residual_cap`` bounds the normalised primal residual. A recovery
    retries at ``lr * lr_backoff`` with rho in residual-balancing mode
    (x ``rho_tau`` when the primal residual exceeds ``rho_mu`` x the dual,
    / ``rho_tau`` in the mirror case), at most ``max_recoveries`` times.
    """

    explode_factor: float = 50.0
    residual_cap: float = 10.0
    warmup_iters: int = 3
    max_recoveries: int = 2
    lr_backoff: float = 0.5
    rho_mu: float = 10.0
    rho_tau: float = 2.0


def adaptive_rho(rho: float, primal: float, dual: float, *,
                 mu: float = 10.0, tau: float = 2.0, rho_min: float = 0.0,
                 rho_max: float = float("inf")) -> float:
    """Boyd's residual-balancing rho update, clamped to [rho_min,
    rho_max]: x ``tau`` when the primal residual exceeds ``mu`` x the
    dual, / ``tau`` in the mirror case."""
    if tau < 1.0:
        raise ValueError(f"tau must be >= 1 (got {tau})")
    if mu <= 0:
        raise ValueError(f"mu must be > 0 (got {mu})")
    if primal > mu * dual:
        rho = rho * tau
    elif dual > mu * primal:
        rho = rho / tau
    return float(min(max(rho, rho_min), rho_max))


def _empty_history() -> Dict[str, List[float]]:
    return {k: [] for k in HISTORY_KEYS}


@dataclasses.dataclass
class PruneRunState:
    """Everything a mid-run ADMM prune needs to continue bit-exactly."""

    params: Any                                   # W^k
    av: Any                                       # ADMMVars | [ADMMVars]
    key: torch.Tensor                             # int64 key BEFORE split k
    iteration: int = 0                            # next iteration to run
    history: Dict[str, List[float]] = dataclasses.field(
        default_factory=_empty_history)
    rho_override: Optional[float] = None          # set after a recovery
    lr_scale: float = 1.0                         # backed off on recovery
    recoveries: int = 0

    def snapshot(self) -> "PruneRunState":
        """Copy with its own history (the trees are never mutated)."""
        return dataclasses.replace(
            self, history={k: list(v) for k, v in self.history.items()})


def as_key(seed: int) -> torch.Tensor:
    """A run key: the int64 tensor of ``seed``."""
    return torch.tensor(int(seed), dtype=torch.int64)


def split_key(key: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(next key, this iteration's batch key), both pure functions of
    ``key``."""
    # imported here: serve pulls in the models, which import core
    from repro_torch.serve.sampler import fold_in

    return fold_in(key, 0), fold_in(key, 1)


def key_generator(key: torch.Tensor, device) -> torch.Generator:
    """A generator on ``device`` seeded by ``key``'s 64 bits."""
    return torch.Generator(device).manual_seed(int(key) % (1 << 64))


def run_fingerprint(params: Any, config: Any, iterations: int,
                    kind: str) -> str:
    """CRC32 of a prune run: the initial weights' bytes and the config.

    Stored in every checkpoint's ``extra``; a directory with another
    fingerprint belongs to another teacher or config and is not resumed.
    """
    crc = 0
    for leaf in tree_leaves(params):
        crc = zlib.crc32(_to_numpy(leaf)[0].tobytes(), crc)
    sig = json.dumps([kind, int(iterations), dataclasses.asdict(config)],
                     sort_keys=True, default=str)
    return f"{zlib.crc32(sig.encode('utf-8'), crc) & 0xFFFFFFFF:08x}"


def _z_trees(av: Any) -> List[Any]:
    if isinstance(av, admm.ADMMVars):
        return [av.z]
    return [a.z for a in av]


def loop_dual_residual(av_new: Any, av_old: Any, rho: float) -> float:
    """The dual residual of a whole-model ``ADMMVars`` or, averaged over
    layers, of a per-layer list of them."""
    vals = [float(admm.dual_residual(n, o, rho))
            for n, o in zip(_z_trees(av_new), _z_trees(av_old))]
    return float(sum(vals) / max(len(vals), 1))


class PruneCheckpointer:
    """Checkpoints and ``trace.jsonl`` of one ADMM run.

    Wraps ``CheckpointManager`` (atomic commits, rotation): the saved tree
    is ``{params, av, key}``; the scalar side of ``PruneRunState`` rides
    in the manifest's ``extra`` (floats round-trip exactly through JSON).
    ``load_latest`` walks the steps newest first, skipping corrupt ones
    (each skip traced); if every one is corrupt the last
    ``ArtifactError`` escapes.
    """

    def __init__(self, directory: str, *, save_every: int = 0,
                 keep: int = 3, fingerprint: Optional[str] = None):
        self.directory = directory
        self.save_every = int(save_every)
        self.fingerprint = fingerprint
        self.manager = CheckpointManager(directory, keep=keep)
        self.trace_path = os.path.join(directory, TRACE_FILE)

    def trace(self, record: Dict[str, Any]) -> None:
        with open(self.trace_path, "a") as f:
            f.write(json.dumps(record) + "\n")

    def save(self, state: PruneRunState) -> None:
        tree = {"params": state.params, "av": state.av, "key": state.key}
        self.manager.save(state.iteration, tree, extra={"prune_state": {
            "iteration": state.iteration,
            "history": state.history,
            "rho_override": state.rho_override,
            "lr_scale": state.lr_scale,
            "recoveries": state.recoveries,
            "fingerprint": self.fingerprint,
        }})

    def maybe_save(self, state: PruneRunState) -> bool:
        if (self.save_every > 0 and state.iteration > 0
                and state.iteration % self.save_every == 0):
            self.save(state)
            self.trace({"event": "checkpoint", "step": state.iteration})
            return True
        return False

    def steps(self) -> List[int]:
        return self.manager.steps()

    def load_latest(self, template: PruneRunState
                    ) -> Optional[PruneRunState]:
        """The newest loadable checkpoint as a ``PruneRunState`` (tensors
        on the devices of ``template``'s), or None: nothing committed, or
        a stale directory (another fingerprint)."""
        like = {"params": template.params, "av": template.av,
                "key": template.key}
        last_err: Optional[ArtifactError] = None
        for step in reversed(self.manager.steps()):
            directory = self.manager._dir(step)
            try:
                extra = self.manager.extra(step).get("prune_state", {})
                recorded = extra.get("fingerprint")
                if (self.fingerprint is not None and recorded is not None
                        and recorded != self.fingerprint):
                    log.warning(
                        "checkpoints under %s have fingerprint %s; this run "
                        "is %s: stale directory ignored, starting fresh",
                        self.directory, recorded, self.fingerprint)
                    self.trace({"event": "stale_checkpoint", "step": step,
                                "recorded": recorded,
                                "expected": self.fingerprint})
                    return None
                tree = restore_pytree(directory, like)
                return PruneRunState(
                    params=tree["params"], av=tree["av"], key=tree["key"],
                    iteration=int(extra.get("iteration", step)),
                    history={k: list(v) for k, v in extra.get(
                        "history", _empty_history()).items()},
                    rho_override=extra.get("rho_override"),
                    lr_scale=float(extra.get("lr_scale", 1.0)),
                    recoveries=int(extra.get("recoveries", 0)),
                )
            except ArtifactError as e:
                last_err = e
                log.warning("checkpoint step %d unreadable (%s); trying an "
                            "older one", step, e)
                self.trace({"event": "corrupt_checkpoint", "step": step,
                            "error": str(e)})
            except (OSError, ValueError, KeyError, TypeError) as e:
                last_err = ArtifactError(
                    f"checkpoint step {step} unreadable "
                    f"({type(e).__name__}: {e})", path=directory)
                log.warning("%s; trying an older one", last_err)
                self.trace({"event": "corrupt_checkpoint", "step": step,
                            "error": str(last_err)})
        if last_err is not None:
            raise last_err
        return None


# iter_fn(params, av, batch_key, it, lr=..., rho=...) -> (params, av,
# metrics), metrics {"loss": float, "residual": float} of Python floats
IterFn = Callable[..., Tuple[Any, Any, Dict[str, float]]]


def check_health(it: int, metrics: Dict[str, float],
                 history: Dict[str, List[float]], policy: HealthPolicy,
                 *, recoveries: int = 0) -> None:
    """Raise ``PruneDivergence`` if this iteration's diagnostics are bad."""
    for name in ("loss", "residual", "dual_residual"):
        v = metrics.get(name)
        if v is not None and not math.isfinite(v):
            raise PruneDivergence(f"non-finite {name}", iteration=it,
                                  metric=name, value=v,
                                  recoveries=recoveries)
    residual = metrics.get("residual")
    if residual is not None and residual > policy.residual_cap:
        raise PruneDivergence(
            "primal residual exploded", iteration=it, metric="residual",
            value=residual, recoveries=recoveries)
    loss = metrics.get("loss")
    past = history.get("loss", [])
    if loss is not None and len(past) >= policy.warmup_iters:
        ref = max(abs(v) for v in past[-policy.warmup_iters:])
        if abs(loss) > policy.explode_factor * max(ref, 1e-12):
            raise PruneDivergence(
                "loss exploded vs the run's recent scale", iteration=it,
                metric="loss", value=loss, recoveries=recoveries)


def _recover(state: PruneRunState, err: PruneDivergence,
             policy: HealthPolicy,
             checkpointer: Optional[PruneCheckpointer],
             anchor: PruneRunState, rho_at_failure: float,
             rho_bounds: Tuple[float, float]) -> PruneRunState:
    """Roll back to the last good state and adapt, or re-raise."""
    attempt = state.recoveries + 1
    if attempt > policy.max_recoveries:
        if checkpointer is not None:
            checkpointer.trace({"event": "gave_up",
                                "iteration": err.iteration,
                                "recoveries": state.recoveries,
                                "error": str(err)})
        raise PruneDivergence(
            f"diverged and exhausted {policy.max_recoveries} recovery "
            f"attempt(s): {err}", iteration=err.iteration,
            metric=err.metric, value=err.value,
            recoveries=state.recoveries) from err

    rolled: Optional[PruneRunState] = None
    if checkpointer is not None:
        try:
            rolled = checkpointer.load_latest(anchor)
        except ArtifactError:
            rolled = None        # every checkpoint corrupt: use the anchor
    if rolled is None:
        rolled = anchor.snapshot()
    rolled.recoveries = attempt
    rolled.lr_scale = state.lr_scale * policy.lr_backoff
    # restart rho below the failing value; residual balancing (each
    # iteration while the override is set) takes it from there
    rho_min, rho_max = rho_bounds
    rolled.rho_override = float(min(max(rho_at_failure / policy.rho_tau,
                                        rho_min), rho_max))
    log.warning(
        "prune diverged at iteration %d (%s); rolled back to iteration "
        "%d, lr_scale=%.3g, rho=%.3g (recovery %d/%d)", err.iteration,
        err, rolled.iteration, rolled.lr_scale, rolled.rho_override,
        attempt, policy.max_recoveries)
    if checkpointer is not None:
        checkpointer.trace({"event": "rollback",
                            "diverged_at": err.iteration,
                            "metric": err.metric,
                            "resumed_from": rolled.iteration,
                            "lr_scale": rolled.lr_scale,
                            "rho_override": rolled.rho_override,
                            "recovery": attempt,
                            "max_recoveries": policy.max_recoveries})
    return rolled


def run_admm_loop(
    state: PruneRunState,
    iter_fn: IterFn,
    *,
    iterations: int,
    lr: float,
    rho_fn: Callable[[int], float],
    rho_bounds: Tuple[float, float],
    policy: Optional[HealthPolicy] = None,
    checkpointer: Optional[PruneCheckpointer] = None,
    callback: Optional[Callable[[int, Dict[str, float]], None]] = None,
    fault_hook: Optional[Callable[[int, Any, Any], Any]] = None,
) -> PruneRunState:
    """Drive ``iter_fn`` from ``state.iteration`` to ``iterations``.

    Per iteration: split the key, resolve rho (a recovery's override wins
    over ``rho_fn``), run ``iter_fn``, derive the dual residual from the
    Z trees, check health, then commit the new state, append history,
    trace, checkpoint at the cadence and last call ``callback``: a run
    stopped inside the callback has committed the iteration it saw.

    ``fault_hook(it, params, av)`` may return a ``(params, av)`` pair that
    replaces the iterates before the iteration runs (an injected fault);
    None leaves them alone. On ``PruneDivergence`` the state rolls back
    and retries under ``policy``; any other exception propagates, and the
    run resumes from its last committed checkpoint.
    """
    reg = get_registry()
    policy = policy or HealthPolicy()
    anchor = state.snapshot()
    saved_at = None
    if checkpointer is not None:
        checkpointer.trace({
            "event": "resume" if state.iteration > 0 else "start",
            "iteration": state.iteration, "iterations": iterations,
            "fingerprint": checkpointer.fingerprint, "time": time.time()})
    while state.iteration < iterations:
        it = state.iteration
        key, bkey = split_key(state.key)
        rho = (float(state.rho_override) if state.rho_override is not None
               else float(rho_fn(it)))
        params, av = state.params, state.av
        if fault_hook is not None:
            injected = fault_hook(it, params, av)
            if injected is not None:
                params, av = injected
        params, av, metrics = iter_fn(params, av, bkey, it,
                                      lr=lr * state.lr_scale, rho=rho)
        metrics = dict(metrics)
        metrics.setdefault("dual_residual",
                           loop_dual_residual(av, state.av, rho))
        metrics["rho"] = rho
        try:
            check_health(it, metrics, state.history, policy,
                         recoveries=state.recoveries)
        except PruneDivergence as e:
            reg.counter("prune.recoveries_total").inc()
            state = _recover(state, e, policy, checkpointer, anchor,
                             rho, rho_bounds)
            continue
        state.params, state.av, state.key = params, av, key
        state.iteration = it + 1
        for k in HISTORY_KEYS:
            state.history.setdefault(k, []).append(metrics[k])
        # the numbers the history row holds, scrapeable beside the stages
        reg.counter("prune.iterations_total").inc()
        for k in HISTORY_KEYS:
            reg.gauge(f"prune.{k}").set(metrics[k])
        if state.rho_override is not None:
            state.rho_override = adaptive_rho(
                state.rho_override, metrics["residual"],
                metrics["dual_residual"], mu=policy.rho_mu,
                tau=policy.rho_tau, rho_min=rho_bounds[0],
                rho_max=rho_bounds[1])
        if checkpointer is not None:
            checkpointer.trace({"it": it, **{k: metrics[k]
                                             for k in HISTORY_KEYS},
                                "lr_scale": state.lr_scale,
                                "recoveries": state.recoveries})
            if checkpointer.maybe_save(state):
                saved_at = state.iteration
        if callback is not None:
            callback(it, metrics)
    if checkpointer is not None and checkpointer.save_every > 0:
        # the final state (a retried run resumes to a no-op), unless the
        # cadence just committed it
        if saved_at != state.iteration:
            checkpointer.save(state)
        checkpointer.trace({"event": "done", "iteration": state.iteration})
    return state
