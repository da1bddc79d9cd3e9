"""Traditional ADMM pruning, ADMM-dagger of the paper's Table I, which
needs the real data (mirrors ``repro/core/admm_traditional.py``).

The no-privacy baseline: the same ADMM machinery, but the primal loss is
the task loss (cross-entropy against the client's real labels) instead of
the synthetic-data distillation distance. It runs on the same resumable
loop as ``PrivacyPreservingPruner``; checkpointing needs step-indexed
data (a callable ``iteration -> batch``), since a plain iterator cannot be
replayed across a restart.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Iterator, Optional, Union

import torch

from repro_torch.core import admm
from repro_torch.core.masks import masks_from_specs
from repro_torch.core.prune_state import (
    HealthPolicy,
    PruneCheckpointer,
    PruneRunState,
    run_admm_loop,
    run_fingerprint,
)
from repro_torch.core.pruner import PruneResult, rho_schedule
from repro_torch.core.schemes import PruneConfig, build_specs, project_tree


def per_example_cross_entropy(logits: torch.Tensor,
                              labels: torch.Tensor) -> torch.Tensor:
    """Per-example NLL, unreduced: (..., C) logits and (...) labels ->
    (...), in fp32 (what a membership-inference attack thresholds)."""
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    return -torch.gather(logp, -1, labels.long()[..., None])[..., 0]


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return per_example_cross_entropy(logits, labels).mean()


@torch.no_grad()
def admm_task_prune(
    key: torch.Tensor,
    teacher_params: Any,
    apply_fn: Callable[[Any, Any], torch.Tensor],
    data_iter: Union[Iterator, Callable[[int], Any]],
    config: PruneConfig,
    *,
    loss_fn: Callable[[torch.Tensor, torch.Tensor],
                      torch.Tensor] = cross_entropy,
    checkpoint_dir: Optional[str] = None,
    save_every: int = 0,
    resume: bool = False,
    health: Optional[HealthPolicy] = None,
    fault_hook: Optional[Callable[[int, Any, Any], Any]] = None,
    callback: Optional[Callable[[int, Dict[str, float]], None]] = None,
) -> PruneResult:
    """ADMM-dagger: prune with the real labelled data (no privacy).

    ``data_iter`` is an iterator of ``(x, y)`` batches or a step-indexed
    callable ``iteration -> (x, y)``; checkpoint / resume needs the
    callable form.
    """
    if callable(data_iter):
        batch_for = data_iter
    else:
        if checkpoint_dir is not None:
            raise ValueError(
                "checkpoint/resume for admm_task_prune requires "
                "step-indexed data (a callable iteration -> batch); a "
                "plain iterator cannot be replayed across a restart")
        src = iter(data_iter)

        def batch_for(it):
            return next(src)

    params = teacher_params
    specs = build_specs(params, config)
    av = admm.admm_init(params)

    def primal_loss(p, batch):
        x, y = batch
        return loss_fn(apply_fn(p, x), y)

    def iter_fn(p, av_, bkey, it, *, lr, rho):
        del bkey                      # data order comes from the step index
        p, av_, loss = admm.admm_iteration(
            primal_loss, lambda tree: project_tree(tree, specs), p, av_,
            batch_for(it), lr=lr, rho=rho,
            primal_steps=config.primal_steps, specs=specs)
        return p, av_, {"loss": float(loss),
                        "residual": float(admm.primal_residual(p, av_))}

    state = PruneRunState(params=params, av=av, key=key)
    ckpt = None
    if checkpoint_dir is not None:
        ckpt = PruneCheckpointer(
            checkpoint_dir, save_every=save_every,
            fingerprint=run_fingerprint(teacher_params, config,
                                        config.iterations, "task"))
        if resume:
            state = ckpt.load_latest(state) or state
    start_it = state.iteration
    t0 = time.perf_counter()
    state = run_admm_loop(
        state, iter_fn, iterations=config.iterations, lr=config.lr,
        rho_fn=lambda it: rho_schedule(config, it),
        rho_bounds=(config.rho_init, config.rho_max),
        policy=health, checkpointer=ckpt, callback=callback,
        fault_hook=fault_hook)
    secs = (time.perf_counter() - t0) / max(state.iteration - start_it, 1)

    pruned = project_tree(state.params, specs)
    return PruneResult(pruned, masks_from_specs(pruned, specs), specs,
                       state.history, secs,
                       provenance={"data": "real",
                                   "method": "admm_traditional"})
