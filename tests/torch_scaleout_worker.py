"""Multi-process workers of the port's scale-out tests (no jax, no repro).

    python tests/torch_scaleout_worker.py train OUT_DIR
    python tests/torch_scaleout_worker.py dense OUT_DIR
    python tests/torch_scaleout_worker.py collectives OUT_DIR
    python tests/torch_scaleout_worker.py fake OUT_DIR [MESH ...]

Each spawns WORLD gloo ranks on the CPU that rendezvous through a
``FileStore`` under OUT_DIR (no port), pins each rank to one intra-op
thread, joins every rank within ``JOIN_S`` seconds and exits non-zero
with each failing rank's traceback. ``train`` runs ``run_training`` on
the 2×2 and 1×4 meshes, saves on 2×2, restores that checkpoint onto 4×1
and trains on; ``dense`` runs each ``DENSE`` config on 2×2;
``collectives`` records one train step's collectives on a 2×2 mesh.
Rank 0 writes what it saw to OUT_DIR as JSON (and the gathered params
as a checkpoint). ``fake`` traces dry-run cells on fake process groups
in one process and writes one JSON per cell. The test files load this
module for its configs and for the helpers at its end.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import traceback
from typing import Sequence

import torch
import torch.multiprocessing as mp

WORLD = 4
JOIN_S = 120
STEPS = 2
SEQ, BATCH = 16, 4
ARCH = "qwen2-1.5b"
DRY_ARCH = "h2o-danube-1.8b"     # a window: every shape applies, long_500k too


# the four dense configs, reduced, each keeping what takes it down a path
# of its own under the axis rules
DENSE = {
    # 6 heads over 2 KV heads: on a 4-way model axis the attention
    # repeats k/v to 6 heads and pads to 8
    "qwen2-1.5b": dict(num_heads=6),
    # its own vocab, 3 * 5 * 29 * 113: no model axis divides it, so the
    # table and the logits stay replicated on it
    "granite-3-2b": dict(vocab_size=49155),
    # its own 24 heads over 8 KV heads
    "phi4-mini-3.8b": dict(num_heads=24, num_kv_heads=8),
    # a window shorter than the sequence
    "h2o-danube-1.8b": dict(sliding_window=8),
}


def config(arch: str = ARCH):
    """The reduced ``arch`` with its ``DENSE`` overrides."""
    from repro_torch.configs import reduced_config

    return reduced_config(arch, **DENSE[arch])


def train_config(ckpt: str, save_every: int = STEPS):
    """``STEPS`` steps, a checkpoint every ``save_every``."""
    from repro_torch.configs.base import TrainConfig

    return TrainConfig(steps=STEPS, learning_rate=1e-3, warmup_steps=1,
                       grad_compression=True, checkpoint_every=save_every,
                       checkpoint_dir=ckpt, seed=3)


def masks_for(cfg, device="cpu"):
    """A seeded 50% irregular mask of every 2-D block weight (None
    elsewhere), the same in every process."""
    from repro_torch.models import build_model
    from repro_torch.utils.tree import unflatten

    g = torch.Generator().manual_seed(11)

    def mask(path, shape):
        if not path.startswith("blocks/") or len(shape) != 2:
            return None
        return (torch.rand(shape, generator=g) < 0.5).to(
            torch.bfloat16).to(device)

    shapes = build_model(cfg, device=device).param_shapes()
    return unflatten({p: mask(p, s) for p, s in shapes.items()})


def _mesh(shape):
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))


def _train_rank(rank: int, out: str) -> None:
    from repro_torch.checkpoint import CheckpointManager, save_pytree
    from repro_torch.launch.train import init_state, run_training
    from repro_torch.models import build_model
    from repro_torch.optim import adamw
    from repro_torch.parallel.sharding import (
        axis_rules, default_rules, gather_full, shardings_of)
    from repro_torch.utils.tree import tree_leaves, tree_map

    cfg = config()
    masks = masks_for(cfg)
    record = {}
    for shape in ((2, 2), (1, 4)):
        name = "x".join(map(str, shape))
        ckpt = os.path.join(out, f"ckpt_{name}")
        res = run_training(cfg, train_config(ckpt), seq_len=SEQ,
                           global_batch=BATCH, mesh=_mesh(shape),
                           masks=masks, device="cpu")
        params = tree_map(gather_full, res["state"]["params"])
        record[name] = [r.metrics for r in res["metrics"]]
        if rank == 0:
            save_pytree(os.path.join(out, f"params_{name}"), params)
    # the 2x2 checkpoint restored onto 4x1, each leaf sharded there, then
    # gathered whole again
    mesh = _mesh((4, 1))
    with axis_rules(default_rules(mesh)):
        like = init_state(build_model(cfg, device="cpu"), adamw(1e-3),
                          torch.Generator().manual_seed(0), masks=masks,
                          grad_compression=True)
    restored = CheckpointManager(os.path.join(out, "ckpt_2x2")).restore(
        like, shardings=shardings_of(like))
    placed = {str(tuple(x.placements)) for x in
              tree_leaves(restored["params"])}
    whole = tree_map(gather_full, restored["params"])
    if rank == 0:
        save_pytree(os.path.join(out, "params_2x2_on_4x1"), whole)
        record["placements_4x1"] = sorted(placed)
    # restore the whole train state onto 4x1 and train on from it
    res = run_training(cfg, train_config(os.path.join(out, "ckpt_2x2"),
                                         save_every=10 * STEPS),
                       seq_len=SEQ, global_batch=BATCH, mesh=mesh,
                       masks=masks, device="cpu")
    record["4x1_resumed"] = [r.metrics for r in res["metrics"]]
    whole = tree_map(gather_full, res["state"]["params"])
    if rank == 0:
        save_pytree(os.path.join(out, "params_4x1_resumed"), whole)
        with open(os.path.join(out, "train.json"), "w") as f:
            json.dump(record, f)


def _dense_rank(rank: int, out: str) -> None:
    from repro_torch.checkpoint import save_pytree
    from repro_torch.launch.train import run_training
    from repro_torch.parallel.sharding import gather_full
    from repro_torch.utils.tree import tree_map

    record = {}
    for arch in DENSE:
        cfg = config(arch)
        ckpt = os.path.join(out, f"ckpt_{arch}")
        res = run_training(cfg, train_config(ckpt), seq_len=SEQ,
                           global_batch=BATCH, mesh=_mesh((2, 2)),
                           masks=masks_for(cfg), device="cpu")
        record[arch] = [r.metrics for r in res["metrics"]]
        params = tree_map(gather_full, res["state"]["params"])
        if rank == 0:
            save_pytree(os.path.join(out, f"params_{arch}"), params)
    if rank == 0:
        with open(os.path.join(out, "dense.json"), "w") as f:
            json.dump(record, f)


def _collectives_rank(rank: int, out: str) -> None:
    from repro_torch.launch.train import init_state, make_train_step
    from repro_torch.models import build_model
    from repro_torch.optim import adamw
    from repro_torch.parallel.sharding import (
        axis_rules, batch_spec, default_rules, shard)
    from repro_torch.roofline.step_costs import op_rows, record_step

    cfg = config()
    mesh = _mesh((2, 2))
    rules = default_rules(mesh)
    model = build_model(cfg, device="cpu")
    optimizer = adamw(1e-4, weight_decay=0.0)
    with axis_rules(rules):
        state = init_state(model, optimizer,
                           torch.Generator().manual_seed(0))
        g = torch.Generator().manual_seed(1)
        batch = {k: shard(torch.randint(0, cfg.vocab_size, (BATCH, SEQ),
                                        generator=g, dtype=torch.int32),
                          batch_spec(rules, 2, shape=(BATCH, SEQ)))
                 for k in ("inputs", "labels")}
        step = make_train_step(model, optimizer)
        with record_step() as rec:
            step(state, batch)
    if rank == 0:
        counts = {}
        for r in rec.ops.values():
            if r.kind == "collective":
                counts[r.op] = counts.get(r.op, 0) + r.count
        with open(os.path.join(out, "collectives.json"), "w") as f:
            json.dump({"counts": counts,
                       "bytes": dict(rec.costs.collective_bytes),
                       "rows": [r for r in op_rows(rec)
                                if r["kind"] == "collective"]}, f)


WORKERS = {"train": _train_rank, "dense": _dense_rank,
           "collectives": _collectives_rank}

FAKE_MESHES = {"4x4": ((4, 4), ("data", "model")),
               "2x4x4": ((2, 4, 4), ("pod", "data", "model")),
               "2x2": ((2, 2), ("data", "model"))}


def fake(out: str, meshes: Sequence[str] = ()) -> None:
    """Every shape of a reduced dense config on fake 4×4 and 2×4×4
    groups, the same cells traced at every tile, and the small train
    step of ``collectives`` on a fake 2×2 one, in this one process (rank 0 of each fake group); only
    those of ``meshes`` (``FAKE_MESHES`` keys) if any are named."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import reduced_config
    from repro_torch.configs.base import SHAPES, ShapeConfig
    from repro_torch.configs.shapes import skip_reason
    from repro_torch.launch.dryrun import fake_process_group, lower_cell

    torch.set_num_threads(1)
    small = ShapeConfig("train_small", SEQ, BATCH, "train")
    for mesh_name, (shape, names) in FAKE_MESHES.items():
        if meshes and mesh_name not in meshes:
            continue
        world = 1
        for n in shape:
            world *= n
        fake_process_group(world)
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
        cells = ([(ARCH, small)] if mesh_name == "2x2" else
                 [(DRY_ARCH, s) for s in SHAPES.values()])
        for arch, cell in cells:
            cfg = config() if arch == ARCH else reduced_config(arch)
            reason = skip_reason(cfg, cell)
            t0 = time.time()
            rec = ({"status": "skipped", "reason": reason} if reason else
                   dict(lower_cell(cfg, cell, mesh), status="ok"))
            rec.update(arch=arch, shape=cell.name, mesh=mesh_name,
                       trace_seconds=time.time() - t0)
            with open(os.path.join(
                    out, f"{arch}__{cell.name}__{mesh_name}.json"), "w") as f:
                json.dump(rec, f)
        if mesh_name == "4x4":
            # the same cells traced tile by tile
            for name in ("train_4k", "prefill_32k", "decode_32k"):
                rec = dict(lower_cell(reduced_config(DRY_ARCH), SHAPES[name],
                                      mesh, replay=False), status="ok",
                           arch=DRY_ARCH, shape=name + "_full",
                           mesh=mesh_name)
                with open(os.path.join(out, f"full__{name}.json"), "w") as f:
                    json.dump(rec, f)


def _rank(rank: int, mode: str, out: str) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(
        os.path.join(out, "store"), WORLD), rank=rank, world_size=WORLD)
    try:
        WORKERS[mode](rank, out)
    finally:
        dist.destroy_process_group()


def run(mode: str, out: str) -> None:
    """Spawn WORLD ranks of ``mode`` and join them within ``JOIN_S``."""
    ctx = mp.start_processes(_rank, args=(mode, out), nprocs=WORLD,
                             start_method="spawn", join=False)
    deadline = time.time() + JOIN_S
    try:
        while not ctx.join(timeout=1):
            if time.time() > deadline:
                raise TimeoutError(f"{mode}: ranks still running after "
                                   f"{JOIN_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()


# -- the test side: spawns and tolerances of the scale-out test files ----

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 2e-5


def start(args):
    """``python args...`` from the repo root on one intra-op thread."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src") + os.pathsep + env.get(
        "PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    return subprocess.Popen([sys.executable] + args, cwd=ROOT, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def wait(proc, timeout=240):
    """``proc``'s output; fails with its tail unless it exits 0."""
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
    assert proc.returncode == 0, out[-4000:] + err[-8000:]
    return out


def close(got, want):
    """Loss and grad norm within ``RTOL`` relative at every step."""
    for a, b in zip(got, want):
        for k in ("loss", "grad_norm"):
            assert abs(a[k] - b[k]) <= RTOL * abs(b[k]), (k, a[k], b[k])


def params_close(got, want):
    """Within 1e-4 relative, but for the few elements where an int8 code
    rounds the other way at a near-tie (the sharded fp32 gradient differs
    in its last bits): at most 0.1% of a leaf, each off by less than two
    AdamW steps of the learning rate."""
    from repro_torch.utils.tree import tree_items

    lr = train_config("unused").learning_rate
    for path, w in tree_items(got):
        off = ~torch.isclose(w, want[path], rtol=1e-4, atol=1e-6)
        assert off.float().mean() <= 1e-3, path
        assert (w - want[path]).abs().max() < 2 * lr, path


if __name__ == "__main__":
    try:
        if sys.argv[1] == "fake":
            fake(sys.argv[2], sys.argv[3:])
        else:
            run(sys.argv[1], sys.argv[2])
    except Exception:  # noqa: BLE001 — report every rank's failure
        traceback.print_exc()
        sys.exit(1)
