"""Distributed masked retraining + fault tolerance + elastic reshard on
``torch.distributed`` (the PyTorch port's counterpart of
``examples/distributed_masked_retraining.py``).

    PYTHONPATH=src python examples/torch_distributed_masked_retraining.py \
        [--device cpu --world 8] [--steps 6 --resume-steps 4]

By default one rank per card (NCCL); ``--device cpu --world N`` runs N
gloo processes on the CPU (``--world 8`` is the reference's 2 × 4 -> 4 × 2
run; one card is 1 × 1 -> 1 × 1):

  1. the designer prunes a reduced LM with the privacy-preserving pruner
     (irregular 2x, 4 ADMM iterations) on one process,
  2. the client masked-retrains it data + tensor parallel on a
     (data, model) mesh with int8 gradient compression,
  3. checkpoint, SIMULATE A CRASH, resume from the checkpoint on the
     same mesh,
  4. elastic reshard: ``replan_mesh`` picks a reshaped mesh, the same
     checkpoint restores onto it and training goes on; the logical-axis
     rules place every tensor for the new mesh.
"""

from __future__ import annotations

import argparse
import os
import shutil
import tempfile
from typing import Any, Dict, List, Optional, Sequence

import torch

from repro_torch.configs import reduced_config
from repro_torch.configs.base import TrainConfig
from repro_torch.core import LMAdapter, PruneConfig, PrivacyPreservingPruner
from repro_torch.core import as_key, compression_rate
from repro_torch.models import build_model
from repro_torch.runtime.elastic import replan_mesh


def config():
    return reduced_config("granite-3-2b", num_layers=2, d_model=128,
                          d_ff=256, vocab_size=512)


def mesh_shapes(world: int):
    """The first (data, model) mesh and the elastic one ``replan_mesh``
    picks for the same cards with the model axis and data axis swapped:
    2 × 4 -> 4 × 2 on 8 ranks, 1 × 4 -> 4 × 1 on 4, 1 × 1 on one."""
    model = next(m for m in (4, 2, 1) if world % m == 0)
    first = (world // model, model)
    plan = replan_mesh(world, model_parallel=world // model, pod_size=world)
    return first, plan.shape


def prune(device: torch.device) -> Any:
    """The designer's side: the mask function of a 2x irregular prune."""
    cfg = config()
    model = build_model(cfg, device=device)
    params = model.init(torch.Generator(device).manual_seed(0))
    pruner = PrivacyPreservingPruner(
        LMAdapter(model, seq_len=32),
        PruneConfig(scheme="irregular", alpha=0.5, iterations=4,
                    batch_size=8, rho_init=1e-3, rho_every_iters=2))
    result = pruner.run(as_key(1), params)
    print(f"[designer] pruned {compression_rate(result.masks):.2f}x "
          "(irregular)", flush=True)
    return result.masks


def _to(tree: Any, device) -> Any:
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return None if tree is None else tree.to(device)


def rank_main(rank: int, world: int, device_type: str, store_path: str,
              ckpt: str, masks: Any, steps: int, resume_steps: int,
              out: Optional[List] = None) -> None:
    """One rank: the three training phases on the meshes of ``world``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch.train import run_training

    if device_type == "cpu":
        torch.set_num_threads(1)
        device = torch.device("cpu")
    else:
        torch.cuda.set_device(rank)
        device = torch.device("cuda", rank)
    dist.init_process_group("gloo" if device_type == "cpu" else "nccl",
                            store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    try:
        masks = _to(masks, device)
        first, elastic = mesh_shapes(world)

        def train(shape, n):
            mesh = init_device_mesh(device_type, shape,
                                    mesh_dim_names=("data", "model"))
            tcfg = TrainConfig(steps=n, learning_rate=1e-3,
                               warmup_steps=1, grad_compression=True,
                               checkpoint_every=steps, checkpoint_dir=ckpt,
                               seed=13)
            res = run_training(config(), tcfg, seq_len=64, global_batch=16,
                               mesh=mesh, masks=masks, device=device)
            return [m.metrics["loss"] for m in res["metrics"]]

        name = lambda s: "x".join(map(str, s))
        loss1 = train(first, steps)
        say = rank == 0
        if say:
            print(f"[train {name(first)}] {steps} steps, loss path "
                  f"{[round(x, 4) for x in loss1]}", flush=True)
            print(f"[ckpt] saved step {steps} -> {ckpt}", flush=True)
        # CRASH: the state is gone; a new run resumes from the checkpoint
        loss2 = train(first, resume_steps)
        if say:
            print(f"[resume {name(first)}] +{resume_steps} steps after "
                  f"restart, loss path {[round(x, 4) for x in loss2]}",
                  flush=True)
        # ELASTIC: the same checkpoint onto the re-planned mesh
        loss3 = train(elastic, resume_steps)
        if say:
            print(f"[elastic {name(elastic)}] +{resume_steps} steps on "
                  f"the reshaped mesh, loss path "
                  f"{[round(x, 4) for x in loss3]}", flush=True)
            diff = max(abs(a - b) for a, b in zip(loss2, loss3))
            print(f"[check] same-checkpoint losses on {name(first)} vs "
                  f"{name(elastic)}: {loss2[-1]:.4f} vs {loss3[-1]:.4f} "
                  f"(largest difference {diff:.2e}: a pure function of "
                  "(seed, step))", flush=True)
            if out is not None:
                out.append({"train": loss1, "resume": loss2,
                            "elastic": loss3})
    finally:
        dist.destroy_process_group()


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, List[float]]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--world", type=int, default=None,
                    help="ranks (default: every card; 8 on the CPU)")
    ap.add_argument("--steps", type=int, default=6,
                    help="steps before the checkpoint")
    ap.add_argument("--resume-steps", type=int, default=4,
                    help="steps after each restore")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu")
    world = args.world or (torch.cuda.device_count()
                           if args.device == "cuda" else 8)
    first, elastic = mesh_shapes(world)
    print(f"[mesh] {world} rank(s) on {args.device}: "
          f"{first[0]}x{first[1]} -> {elastic[0]}x{elastic[1]} "
          "(data x model)", flush=True)
    masks = _to(prune(torch.device(args.device)), "cpu")
    work = tempfile.mkdtemp(prefix="repro_torch_example_")
    ckpt = os.path.join(work, "ckpt")
    store = os.path.join(work, "store")
    out: List[Dict[str, List[float]]] = []
    try:
        if world == 1:
            rank_main(0, 1, args.device, store, ckpt, masks, args.steps,
                      args.resume_steps, out)
        else:
            import torch.multiprocessing as mp

            mp.start_processes(rank_main, args=(
                world, args.device, store, ckpt, masks, args.steps,
                args.resume_steps), nprocs=world, start_method="spawn")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out[0] if out else {}


if __name__ == "__main__":
    main()
