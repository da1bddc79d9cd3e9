"""The training driver (mirrors ``repro/launch/train.py``).

Builds: mesh -> axis rules -> sharded init (masked when retraining) ->
train step (masked retraining + optional int8 gradient compression) ->
fault-tolerant loop with checkpointing, resumed from the latest
checkpoint. ``make_train_step`` and ``train_state_specs`` are also what
``launch/dryrun.py`` traces.

With ``mesh`` (a ``DeviceMesh`` of ("data", "model") or ("pod", "data",
"model")) the run is SPMD on ``torch.distributed``: every rank calls
``run_training`` with the same arguments, the state lives as DTensors
placed by ``parallel.sharding.default_rules(mesh)``, each rank builds
the global batch from (seed, step) and keeps its shard, and DTensor's
sharding propagation runs the step (gradients reduced to their params'
placements before the clip). Checkpoints are written whole by rank 0
and restore onto any mesh, or none.

``make_train_step`` is the reference's step: grads -> the mask function
-> global-norm clip -> fp32 grads -> (int8 + error feedback) ->
optimizer -> ``(p.float() + u).to(p.dtype)`` -> mask. Updates land in
the params' own dtype: no fp32 master copy is kept, as the reference
keeps none. The privacy report and the pipeline run the same step.

CLI (the card unless ``--device cpu``):

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \
        --reduced --steps 20 --batch 8 --seq 128 [--device cpu]

``--masks DIR`` restores the mask function ``launch/prune.py`` wrote
(``<out>/masks``) and runs the client's masked retraining.
"""

from __future__ import annotations

import argparse
import logging
import os
import tempfile
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.checkpoint import CheckpointManager, load_pytree
from repro_torch.configs import get_config, reduced_config
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.convert import params_from_jax
from repro_torch.core.masks import apply_mask, mask_gradients
from repro_torch.data import DataConfig, make_pipeline_for
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import build_model
from repro_torch.models.transformer import LM
from repro_torch.parallel.sharding import (
    AxisRules,
    NamedSharding,
    axis_rules,
    batch_spec,
    current_rules,
    default_rules,
    gather_full,
    like,
    local_elementwise,
    param_shardings,
    shard,
    shard_tree,
    shardings_of,
)
from repro_torch.optim import (
    adamw,
    clip_scale,
    decompress_int8,
    error_feedback_compress,
    error_feedback_init,
    warmup_cosine,
)
from repro_torch.runtime import FaultTolerantLoop, StepResult, StragglerMonitor
from repro_torch.utils.tree import tree_items, tree_leaves, tree_map

log = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# Train state & step
# ---------------------------------------------------------------------------

def init_state(model: LM, optimizer, gen: torch.Generator, *,
               masks: Any = None, grad_compression: bool = False
               ) -> Dict[str, Any]:
    """``{"params", "opt", "step"}`` (+ ``"ef"`` with compression); the
    params drawn from ``gen`` on the model's device, masked if asked.

    Under active axis rules the state is built sharded: every rank draws
    the same params, keeps its shard of each leaf (placed by
    ``param_logical_axes``), and the moments and residuals are made
    sharded like their params; ``masks`` are sharded like the params
    too. So a sharded init holds exactly the unsharded one's values.
    """
    params = model.init(gen)
    rules = current_rules()
    if rules is not None and rules.mesh is not None:
        shardings = param_shardings(rules, model.param_logical_axes(),
                                    params)
        params = shard_tree(params, shardings)
        if masks is not None:
            masks = shard_tree(masks, shardings)
    if masks is not None:
        params = apply_mask(params, masks)
    state = {
        "params": params,
        "opt": optimizer.init(params),
        "step": torch.zeros((), dtype=torch.int32),
    }
    if grad_compression:
        state["ef"] = error_feedback_init(params)
    return state


def global_norm(tree: Any) -> torch.Tensor:
    """The fp32 norm of every leaf of ``tree`` together."""
    return clip_scale(tree_leaves(tree), 1.0)[0]


def make_train_step(model: LM, optimizer, *, masks: Any = None,
                    grad_clip: float = 1.0, grad_compression: bool = False):
    """``step(state, batch) -> (state, metrics)``, the state as
    ``init_state`` builds it, the batches ``{"inputs", "labels"}``.

    With ``masks`` the gradients of pruned weights are zeroed and the
    weights masked after the update, so the pruned architecture survives
    any optimizer. With ``grad_compression`` the fp32 gradients go
    through the int8 + error-feedback codec before the optimizer (the
    state carries the residuals under ``"ef"``), and the metrics add
    ``ef_residual_ratio``: the largest |residual| / scale over the leaves,
    at most one half for a sound codec.
    """

    def step(state: Dict[str, Any], batch: Dict[str, torch.Tensor]
             ) -> Tuple[Dict[str, Any], Dict[str, torch.Tensor]]:
        with torch.enable_grad():
            p = tree_map(lambda w: w.detach().requires_grad_(True),
                         state["params"])
            loss = model.train_loss(p, batch)
            leaves = [w for _, w in tree_items(p)]
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        # a sharded gradient's pending reductions (the data-parallel
        # all-reduce / reduce-scatter) land it on its param's placements
        it = iter([torch.zeros_like(w) if g is None else like(g, w)
                   for w, g in zip(leaves, grads)])
        grads = tree_map(lambda _: next(it), p)
        metrics = {"loss": loss.detach()}
        with torch.no_grad():
            if masks is not None:
                grads = mask_gradients(grads, masks)
            gnorm, scale = clip_scale(tree_leaves(grads), grad_clip)
            metrics["grad_norm"] = gnorm
            grads = tree_map(lambda g: local_elementwise(
                lambda g, s: g.to(torch.float32) * s, g, scale), grads)
            new_state = dict(state)
            if grad_compression:
                q, s, new_state["ef"] = error_feedback_compress(
                    grads, state["ef"])
                grads = tree_map(lambda q, s: local_elementwise(
                    decompress_int8, q, s), q, s)
                metrics["ef_residual_ratio"] = torch.stack([
                    r.abs().max() / sc for r, sc in zip(
                        tree_leaves(new_state["ef"].residual),
                        tree_leaves(s))]).max()
            updates, new_state["opt"] = optimizer.update(
                grads, state["opt"], state["params"])
            params = tree_map(lambda w, u: local_elementwise(
                lambda w, u: (w.to(torch.float32) + u).to(w.dtype), w, u),
                state["params"], updates)
            if masks is not None:
                params = apply_mask(params, masks)
        new_state["params"] = params
        new_state["step"] = state["step"] + 1
        return new_state, metrics

    return step


def train_state_specs(model: LM, optimizer, rules: Optional[AxisRules], *,
                      grad_compression: bool = False):
    """(state shapes, state shardings) of ``init_state``: the shapes as
    meta tensors (nothing allocated), the shardings a congruent tree of
    ``NamedSharding`` (None without rules). Moments and residuals follow
    their params' placements; scalars are replicated."""
    params = model.abstract_params()
    shapes = {"params": params, "opt": optimizer.init(params),
              "step": torch.zeros((), dtype=torch.int32, device="meta")}
    if grad_compression:
        shapes["ef"] = error_feedback_init(params)
    if rules is None:
        return shapes, None
    from torch.distributed.tensor import Replicate

    p_shard = param_shardings(rules, model.param_logical_axes(), params)
    repl = NamedSharding(rules.mesh, (Replicate(),) * rules.mesh.ndim)

    def opt_fields(opt_shapes):
        """Each field of an optimizer's NamedTuple state: a scalar
        replicated, a param-congruent tree sharded like the params."""
        return type(opt_shapes)(*[
            repl if isinstance(field, torch.Tensor) else p_shard
            for field in opt_shapes])

    shardings = {"params": p_shard, "opt": opt_fields(shapes["opt"]),
                 "step": repl}
    if grad_compression:
        shardings["ef"] = type(shapes["ef"])(p_shard)
    return shapes, shardings


# ---------------------------------------------------------------------------
# The training loop
# ---------------------------------------------------------------------------

def run_training(
    cfg: ModelConfig,
    tcfg: TrainConfig,
    *,
    seq_len: int,
    global_batch: int,
    mesh=None,
    masks: Any = None,
    on_step: Optional[Callable[[StepResult], None]] = None,
    device: DeviceLike = None,
) -> Dict[str, Any]:
    """``tcfg.steps`` steps of AdamW on warmup-cosine from the latest
    checkpoint under ``tcfg.checkpoint_dir`` (else from the init of
    ``tcfg.seed``), on ``FaultTolerantLoop`` with a ``StragglerMonitor``.

    A resumed run continues ``tcfg.steps`` steps past its checkpoint, as
    the reference's does; its batches are regenerated from (seed, step),
    so it ends bit-equal to a run never stopped. Returns ``{"state",
    "metrics": [StepResult], "straggler": the monitor's snapshot}``.

    With ``mesh`` (every rank of its process group calling this with the
    same arguments) the run is sharded under ``default_rules(mesh)``:
    the state and each step's batch are DTensors, and a checkpoint
    written on any mesh (or none) resumes onto this one. ``masks`` are
    whole trees; ``device`` must be the mesh's device type.
    """
    dev = resolve_device(device)
    if mesh is not None and mesh.device_type != dev.type:
        raise ValueError(f"mesh on {mesh.device_type!r} but device {dev}")
    rules = default_rules(mesh) if mesh is not None else None
    with axis_rules(rules):
        return _run(cfg, tcfg, seq_len=seq_len, global_batch=global_batch,
                    masks=masks, on_step=on_step, dev=dev, rules=rules)


def _run(cfg: ModelConfig, tcfg: TrainConfig, *, seq_len: int,
         global_batch: int, masks: Any, on_step, dev: torch.device,
         rules: Optional[AxisRules]) -> Dict[str, Any]:
    model = build_model(cfg, device=dev)
    optimizer = adamw(
        warmup_cosine(tcfg.learning_rate, tcfg.warmup_steps, tcfg.steps),
        weight_decay=tcfg.weight_decay,
    )
    if rules is not None and masks is not None:
        masks = shard_tree(masks, param_shardings(
            rules, model.param_logical_axes(), model.abstract_params()))
    step_fn = make_train_step(
        model, optimizer, masks=masks, grad_clip=tcfg.grad_clip,
        grad_compression=tcfg.grad_compression,
    )
    data = make_pipeline_for(
        "lm" if cfg.input_kind == "tokens" else "embeddings",
        DataConfig(seq_len=seq_len, global_batch=global_batch,
                   vocab_size=cfg.vocab_size, d_model=cfg.d_model,
                   seed=tcfg.seed),
        device=dev,
    )
    state = init_state(model, optimizer,
                       torch.Generator(dev).manual_seed(tcfg.seed),
                       masks=masks, grad_compression=tcfg.grad_compression)
    manager = CheckpointManager(tcfg.checkpoint_dir,
                                keep=tcfg.keep_checkpoints)
    loop = FaultTolerantLoop(
        manager=manager, save_every=tcfg.checkpoint_every,
        straggler=StragglerMonitor(),
    )

    shardings = shardings_of(state) if rules is not None else None
    start = 0
    latest = manager.latest_step()
    if latest is not None:
        log.info("resuming from checkpoint step %d", latest)
        state = manager.restore(state, shardings=shardings)
        start = latest

    metrics_log = []

    def batch_at(step):
        batch = data.batch_at(step)
        if rules is None:
            return batch
        return {k: shard(v, batch_spec(rules, v.ndim, shape=v.shape))
                for k, v in batch.items()}

    def step_adapter(state, step):
        state, metrics = step_fn(state, batch_at(step))
        return state, {k: float(gather_full(v)) for k, v in metrics.items()}

    def record(res):
        metrics_log.append(res)
        if on_step:
            on_step(res)

    state = loop.run(
        state, step_adapter,
        start_step=start, num_steps=tcfg.steps,
        restore_fn=lambda template, s: manager.restore(
            template, step=s, shardings=shardings),
        on_step=record,
    )
    return {"state": state, "metrics": metrics_log,
            "straggler": loop.straggler.snapshot()}


def restore_masks(directory: str, cfg: ModelConfig,
                  device: DeviceLike = None) -> Any:
    """The mask function ``launch/prune.py`` saved (the reference's stacked
    layout, bf16 {0, 1}) as the port's tree on ``device``."""
    return params_from_jax(load_pytree(directory, device="cpu"), cfg,
                           resolve_device(device))


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="reduced config (a few layers, narrow widths)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoints, resumed from when present (default: "
                         "repro_torch_ckpt/<arch>[-reduced] under the "
                         "temporary directory)")
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--masks", default=None,
                    help="mask-function checkpoint from launch/prune.py — "
                         "runs the paper's client-side masked retraining")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    dev = resolve_device(args.device)
    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    ckpt_dir = args.ckpt_dir or os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt",
        args.arch + ("-reduced" if args.reduced else ""))
    tcfg = TrainConfig(steps=args.steps, learning_rate=args.lr,
                       checkpoint_dir=ckpt_dir,
                       grad_compression=args.grad_compression)
    masks = None
    if args.masks:
        masks = restore_masks(args.masks, cfg, dev)
        log.info("masked retraining with mask function from %s", args.masks)
    out = run_training(cfg, tcfg, seq_len=args.seq, global_batch=args.batch,
                       masks=masks, device=dev)
    losses = [m.metrics["loss"] for m in out["metrics"]]
    print(f"arch={cfg.name} steps={len(losses)} "
          f"loss: first={losses[0]:.4f} last={losses[-1]:.4f}")
    return out


if __name__ == "__main__":
    main()
