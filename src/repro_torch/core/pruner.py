"""Privacy-preserving weight pruning, paper Algorithm 1 (mirrors
``repro/core/pruner.py``).

The system designer gets a pre-trained model and NO training data. It
prunes with randomly generated synthetic inputs only and hands back the
pruned model and the mask function for the client's retraining on her
confidential data. Two formulations:

  * ``run_layerwise``   problem (3), layer-by-layer distillation (the
    paper's recommended one, Table IV);
  * ``run_whole_model`` problem (2), the final outputs only.

Models are reached through the ``SequentialAdapter`` protocol: CNNs
(``models/cnn.py``) and ``LMAdapter`` over the LM. The reference jits one
update per layer; here each runs eagerly on the params' device, with
autograd for the primal step and ``torch.no_grad`` everywhere else.

As in the reference (and the authors' other ADMM pruning work), Z and U
are initialised once before the loop, not reset every iteration as the
printed listing has it.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Dict, List, Optional, Protocol, Tuple

import torch

from repro_torch.core import admm, distill
from repro_torch.core.masks import masks_from_specs
from repro_torch.core.prune_state import (
    HealthPolicy,
    PruneCheckpointer,
    PruneRunState,
    as_key,
    key_generator,
    run_admm_loop,
    run_fingerprint,
)
from repro_torch.core.schemes import PruneConfig, build_specs, project_tree
from repro_torch.utils.tree import tree_leaves


class SequentialAdapter(Protocol):
    """What the pruner needs to know about a model. A "layer" is the
    paper's f_n, one prunable stage whose output the teacher is matched
    on (conv + activation for a CNN, one block for a transformer)."""

    num_layers: int
    device: torch.device

    def synthetic_batch(self, gen: torch.Generator, batch_size: int) -> Any:
        """Random synthetic inputs (no knowledge of client data)."""

    def embed(self, params: Any, batch: Any) -> Any:
        """Raw inputs -> the first layer's input."""

    def layer_params(self, params: Any, n: int) -> Any: ...

    def with_layer_params(self, params: Any, n: int, lp: Any) -> Any: ...

    def apply_layer(self, n: int, lp: Any, x: Any) -> Any: ...

    def apply(self, params: Any, batch: Any) -> torch.Tensor:
        """Full forward to soft outputs (problem (2))."""


@dataclasses.dataclass
class PruneResult:
    """Raw pruner output; ``to_artifact()`` is the deployment hand-off."""

    params: Any                       # pruned model (exactly sparse)
    masks: Any                        # mask function: 1 kept, 0 pruned
    specs: Any                        # LayerSpec tree used
    history: Dict[str, List[float]]   # per-iteration diagnostics
    seconds_per_iter: float = 0.0
    # data lineage for the artifact manifest's ``privacy`` block: which
    # data the prune consumed ("synthetic" | "real" | "none") and the
    # generator / method that produced it
    provenance: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def to_artifact(self, **meta):
        """``PrunedArtifact`` of the result (``.pack()`` it to serve).
        ``meta`` goes into the manifest beside the run's diagnostics; the
        provenance lands under ``meta["privacy"]``."""
        # imported here: sparse -> kernels.pattern_conv -> core
        from repro_torch.sparse.artifact import PrunedArtifact

        info = {
            "seconds_per_iter": self.seconds_per_iter,
            "iterations": len(self.history.get("loss", [])),
            "history": {k: list(v) for k, v in self.history.items()},
            **meta,
        }
        if self.provenance:
            info.setdefault("privacy", dict(self.provenance))
        return PrunedArtifact(params=self.params, masks=self.masks,
                              specs=self.specs, meta=info)


def rho_schedule(config: PruneConfig, it: int) -> float:
    """rho starts at rho_init and x rho_mult every rho_every_iters,
    capped at rho_max."""
    steps = it // max(config.rho_every_iters, 1)
    # cap the exponent first: rho_mult ** steps overflows for a huge it
    if steps * math.log(max(config.rho_mult, 1 + 1e-12)) > math.log(
            config.rho_max / config.rho_init):
        return float(config.rho_max)
    return float(min(config.rho_init * (config.rho_mult ** steps),
                     config.rho_max))


def _check_device(params: Any, device: torch.device) -> None:
    for leaf in tree_leaves(params):
        if leaf.device.type != device.type:
            raise ValueError(f"params on {leaf.device}, the adapter's model "
                             f"on {device}")


class PrivacyPreservingPruner:
    """Drives Algorithm 1 over a ``SequentialAdapter``, on the device of
    the adapter's model (which the params must share)."""

    def __init__(self, adapter: SequentialAdapter, config: PruneConfig):
        self.adapter = adapter
        self.config = config

    # -- layer-wise (problem 3) ---------------------------------------------

    def teacher_acts(self, teacher_params: Any, batch: Any) -> List[Any]:
        """Every layer's teacher output on ``batch``, one frozen pass."""
        adapter = self.adapter
        x = adapter.embed(teacher_params, batch)
        acts = []
        for n in range(adapter.num_layers):
            x = adapter.apply_layer(
                n, adapter.layer_params(teacher_params, n), x)
            acts.append(x)
        return acts

    def layer_update(self, n: int, specs: Any, lp: Any, av: admm.ADMMVars,
                     x_in: Any, teacher_out: Any, lr: float, rho: float):
        """One ADMM iteration of layer ``n`` (problem (3)): the specs pick
        the projection and mask the penalty."""
        adapter = self.adapter

        def loss_fn(p, batch):
            x, t = batch
            return distill.layerwise_loss(
                lambda q, xx: adapter.apply_layer(n, q, xx), p, x, t)

        return admm.admm_iteration(
            loss_fn, lambda tree: project_tree(tree, specs), lp, av,
            (x_in, teacher_out), lr=lr, rho=rho,
            primal_steps=self.config.primal_steps, specs=specs)

    @torch.no_grad()
    def run_layerwise(
        self,
        key: torch.Tensor,
        teacher_params: Any,
        *,
        iterations: Optional[int] = None,
        callback: Optional[Callable[[int, Dict[str, float]], None]] = None,
        checkpoint_dir: Optional[str] = None,
        save_every: int = 0,
        resume: bool = False,
        health: Optional[HealthPolicy] = None,
        fault_hook: Optional[Callable[[int, Any, Any], Any]] = None,
    ) -> PruneResult:
        cfg = self.config
        adapter = self.adapter
        iterations = iterations if iterations is not None else cfg.iterations
        _check_device(teacher_params, adapter.device)

        params = teacher_params                       # W^0 <- W'
        L = adapter.num_layers
        layer_specs = [build_specs(adapter.layer_params(params, n), cfg)
                       for n in range(L)]
        layer_av = [admm.admm_init(adapter.layer_params(params, n))
                    for n in range(L)]

        def iter_fn(params, layer_av, bkey, it, *, lr, rho):
            batch = adapter.synthetic_batch(
                key_generator(bkey, adapter.device), cfg.batch_size)
            teacher = self.teacher_acts(teacher_params, batch)
            # the student pass updates layer n before feeding layer n + 1
            # (Algorithm 1's inner loop). The av list is copied, never
            # mutated: a rollback needs the previous state intact.
            x_s = adapter.embed(params, batch)
            losses = []
            new_av = list(layer_av)
            for n in range(L):
                lp, new_av[n], loss = self.layer_update(
                    n, layer_specs[n], adapter.layer_params(params, n),
                    new_av[n], x_s, teacher[n], lr, rho)
                params = adapter.with_layer_params(params, n, lp)
                x_s = adapter.apply_layer(n, lp, x_s)
                losses.append(loss)
            res = torch.stack([
                admm.primal_residual(adapter.layer_params(params, n),
                                     new_av[n]) for n in range(L)]).sum()
            # one host sync per iteration; the layers' losses summed as
            # Python floats in layer order, as the reference does
            it_loss = 0.0
            for v in torch.stack(losses).tolist():
                it_loss += v
            return params, new_av, {"loss": it_loss,
                                    "residual": float(res) / L}

        state, secs = self._run(params, layer_av, key, iter_fn, iterations,
                          "layerwise", teacher_params, checkpoint_dir,
                          save_every, resume, health, callback, fault_hook)
        # the final hard projection: exactly sparse weights + the masks
        specs_full = build_specs(state.params, cfg)
        pruned = project_tree(state.params, specs_full)
        return PruneResult(pruned, masks_from_specs(pruned, specs_full),
                           specs_full, state.history, secs,
                           provenance=self._provenance("layerwise"))

    # -- whole-model (problem 2) --------------------------------------------

    @torch.no_grad()
    def run_whole_model(
        self,
        key: torch.Tensor,
        teacher_params: Any,
        *,
        iterations: Optional[int] = None,
        callback: Optional[Callable[[int, Dict[str, float]], None]] = None,
        checkpoint_dir: Optional[str] = None,
        save_every: int = 0,
        resume: bool = False,
        health: Optional[HealthPolicy] = None,
        fault_hook: Optional[Callable[[int, Any, Any], Any]] = None,
    ) -> PruneResult:
        cfg = self.config
        adapter = self.adapter
        iterations = iterations if iterations is not None else cfg.iterations
        _check_device(teacher_params, adapter.device)

        params = teacher_params
        specs = build_specs(params, cfg)
        av = admm.admm_init(params)

        def loss_fn(p, batch):
            x, teacher_out = batch
            return distill.frobenius_distance(adapter.apply(p, x),
                                              teacher_out)

        def iter_fn(p, av_, bkey, it, *, lr, rho):
            x = adapter.synthetic_batch(key_generator(bkey, adapter.device),
                                        cfg.batch_size)
            teacher_out = adapter.apply(teacher_params, x)
            p, av_, loss = admm.admm_iteration(
                loss_fn, lambda tree: project_tree(tree, specs), p, av_,
                (x, teacher_out), lr=lr, rho=rho,
                primal_steps=cfg.primal_steps, specs=specs)
            return p, av_, {"loss": float(loss),
                            "residual": float(admm.primal_residual(p, av_))}

        state, secs = self._run(params, av, key, iter_fn, iterations,
                          "whole_model", teacher_params, checkpoint_dir,
                          save_every, resume, health, callback, fault_hook)
        pruned = project_tree(state.params, specs)
        return PruneResult(pruned, masks_from_specs(pruned, specs), specs,
                           state.history, secs,
                           provenance=self._provenance("whole_model"))

    def run(self, key: torch.Tensor, teacher_params: Any, **kw
            ) -> PruneResult:
        if self.config.layerwise:
            return self.run_layerwise(key, teacher_params, **kw)
        return self.run_whole_model(key, teacher_params, **kw)

    # -- helpers ------------------------------------------------------------

    def _run(self, params, av, key, iter_fn, iterations, kind,
             teacher_params, checkpoint_dir, save_every, resume, health,
             callback, fault_hook) -> Tuple[PruneRunState, float]:
        """The shared run: resume if asked, run the loop -> (final
        state, seconds per iteration this call ran)."""
        cfg = self.config
        if not isinstance(key, torch.Tensor):
            key = as_key(key)
        state = PruneRunState(params=params, av=av, key=key)
        ckpt = None
        if checkpoint_dir is not None:
            ckpt = PruneCheckpointer(
                checkpoint_dir, save_every=save_every,
                fingerprint=run_fingerprint(teacher_params, cfg, iterations,
                                            kind))
            if resume:
                state = ckpt.load_latest(state) or state
        start_it = state.iteration
        t0 = time.perf_counter()
        state = run_admm_loop(
            state, iter_fn, iterations=iterations, lr=cfg.lr,
            rho_fn=lambda it: rho_schedule(cfg, it),
            rho_bounds=(cfg.rho_init, cfg.rho_max),
            policy=health, checkpointer=ckpt, callback=callback,
            fault_hook=fault_hook)
        return state, ((time.perf_counter() - t0)
                       / max(state.iteration - start_it, 1))

    def _provenance(self, formulation: str) -> Dict[str, Any]:
        """Data lineage: this path only ever saw synthetic inputs."""
        return {
            "data": "synthetic",
            "generator": getattr(self.adapter, "synthetic_kind", "synthetic"),
            "method": "privacy_preserving_admm",
            "formulation": formulation,
        }
