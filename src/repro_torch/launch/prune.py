"""The system designer's pruning service, on the card (mirrors
``repro/launch/prune.py``; the paper's Fig. 2b, left box).

Input: the client's pre-trained checkpoint, never her data. Output: the
pruned checkpoint and the mask function for her masked retraining, and
with ``--artifact-out`` a packed ``PrunedArtifact`` that
``launch/serve.py --artifact DIR --packed`` serves.

    PYTHONPATH=src python -m repro_torch.launch.prune --arch qwen2-1.5b \
        --reduced --scheme tile_pattern --rate 2 --iters 60 \
        --tile-block 32 --out /tmp/pruned_qwen2 \
        --artifact-out /tmp/pruned_qwen2/artifact [--device cpu]

The privacy property is structural: the only inputs are the checkpoint,
the run's key and the config. ``<out>/pruned`` and ``<out>/masks`` are in
the reference's stacked layout, so either package reads them.
``main(argv)`` returns the ``PruneResult``, so it can be driven in
process. ``--chaos-kill-at N`` (a test seam) SIGKILLs the process once
ADMM iteration N has committed (``testing.chaos.kill_at_iteration``);
with ``--save-every`` a later ``--resume`` finishes the run bit-identical
to one never killed.
"""

from __future__ import annotations

import argparse
import logging
import os
import time
from typing import Optional, Sequence

import torch

from repro_torch.checkpoint import load_pytree, save_pytree
from repro_torch.configs import get_config, reduced_config
from repro_torch.convert import params_from_jax, tree_to_jax
from repro_torch.core import (
    DEFAULT_EXCLUDE,
    LMAdapter,
    PrivacyPreservingPruner,
    PruneConfig,
    PruneResult,
    as_key,
    compression_rate,
    sparsity,
)
from repro_torch.device import resolve_device
from repro_torch.models import LM
from repro_torch.testing.chaos import kill_at_iteration
from repro_torch.utils.tree import tree_map

log = logging.getLogger(__name__)


def prune_config_for(*, scheme: str, rate: float, iters: int,
                     batch: int = 16, tile_block: int = 128,
                     layerwise: bool = True, exclude=None) -> PruneConfig:
    """The service's PruneConfig policy: tile_pattern lanes quantize the
    rate to keep-of-8, rho steps three times over the run."""
    overrides = {}
    if scheme == "tile_pattern":
        keep = max(1, min(7, round(8 / rate)))
        if abs(8 / keep - rate) > 1e-9:
            log.warning(
                "tile_pattern lanes quantize to keep %d-of-8 (%.2fx), not "
                "the requested %.2fx", keep, 8 / keep, rate)
        overrides = {".*": {"tile_block_p": tile_block, "tile_keep": keep}}
    return PruneConfig(
        scheme=scheme, alpha=1.0 / rate,
        exclude=tuple(DEFAULT_EXCLUDE) if exclude is None else tuple(exclude),
        iterations=iters, batch_size=batch, lr=1e-3,
        rho_every_iters=max(iters // 3, 1), layerwise=layerwise,
        overrides=overrides)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--scheme", default="irregular",
                    choices=["irregular", "filter", "column", "tile_pattern"])
    ap.add_argument("--rate", type=float, default=4.0)
    ap.add_argument("--iters", type=int, default=60)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--teacher-ckpt", default=None,
                    help="client checkpoint dir, reference stacked layout "
                         "(else random init, demo mode)")
    ap.add_argument("--out", required=True)
    ap.add_argument("--artifact-out", default=None,
                    help="also save a PACKED PrunedArtifact here (servable "
                         "by launch/serve.py --artifact ... --packed)")
    ap.add_argument("--layerwise", action=argparse.BooleanOptionalAction,
                    default=True, help="problem (3) vs problem (2)")
    ap.add_argument("--tile-block", type=int, default=128,
                    help="tile_pattern block_p; must divide every GEMM "
                         "output dim (reduced configs want 32)")
    ap.add_argument("--save-every", type=int, default=0,
                    help="checkpoint the ADMM run state every N iterations "
                         "(0 = off); a killed run resumed with --resume "
                         "is bit-identical to an uninterrupted one")
    ap.add_argument("--resume", action="store_true",
                    help="resume from the latest run-state checkpoint "
                         "under --ckpt-dir (fresh start if none or stale)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="run-state checkpoint directory "
                         "(default <out>/prune_ckpt)")
    ap.add_argument("--chaos-kill-at", type=int, default=None,
                    help="TEST SEAM: SIGKILL this process once ADMM "
                         "iteration N has committed")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> PruneResult:
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    dev = resolve_device(args.device)
    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    model = LM(cfg, device=dev)
    if args.teacher_ckpt:
        params = params_from_jax(load_pytree(args.teacher_ckpt, device="cpu"),
                                 cfg, dev)
        log.info("restored client checkpoint from %s", args.teacher_ckpt)
    else:
        params = model.init(torch.Generator(dev).manual_seed(0))
        log.warning("no --teacher-ckpt: using random init (demo mode)")

    config = prune_config_for(
        scheme=args.scheme, rate=args.rate, iters=args.iters,
        batch=args.batch, tile_block=args.tile_block,
        layerwise=args.layerwise)
    ckpt_dir = None
    if args.save_every > 0 or args.resume:
        ckpt_dir = args.ckpt_dir or os.path.join(args.out, "prune_ckpt")
    callback = None
    if args.chaos_kill_at is not None:
        callback = kill_at_iteration(args.chaos_kill_at, hard=True)
    t0 = time.time()
    result = PrivacyPreservingPruner(
        LMAdapter(model, seq_len=args.seq), config).run(
            as_key(1), params, checkpoint_dir=ckpt_dir,
            save_every=args.save_every, resume=args.resume,
            callback=callback)
    log.info("pruned %.2fx (sparsity %.1f%%) in %.1fs; client data never "
             "touched", compression_rate(result.masks),
             100 * sparsity(result.masks), time.time() - t0)

    save_pytree(os.path.join(args.out, "pruned"), tree_to_jax(result.params),
                extra={"arch": args.arch, "scheme": args.scheme,
                       "rate": args.rate})
    # None (an unpruned leaf) -> an all-ones mask: the client restores the
    # masks with a params-congruent template
    dense_masks = tree_map(
        lambda m, p: (torch.ones(p.shape, dtype=torch.bfloat16,
                                 device=p.device) if m is None
                      else m.to(torch.bfloat16)),
        result.masks, result.params)
    save_pytree(os.path.join(args.out, "masks"), tree_to_jax(dense_masks),
                extra={"arch": args.arch})
    if args.artifact_out:
        artifact = result.to_artifact(arch=args.arch, scheme=args.scheme,
                                      rate=args.rate).pack(device=dev)
        artifact.save(args.artifact_out)
        s = artifact.summary()
        log.info("packed artifact -> %s (%d/%d leaves, %.2fx weight bytes)",
                 args.artifact_out, s["packed_leaves"], s["total_leaves"],
                 s["bytes_ratio"])
    print(f"pruned model -> {args.out}/pruned ; mask function -> "
          f"{args.out}/masks")
    print(f"compression {compression_rate(result.masks):.2f}x "
          f"({config.scheme} @ alpha={config.alpha:.3f}, "
          f"{'layer-wise (3)' if config.layerwise else 'whole-model (2)'}, "
          f"{dev})")
    return result


if __name__ == "__main__":
    main()
