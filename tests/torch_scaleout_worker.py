"""Multi-process workers of the port's scale-out tests (no jax, no repro).

    python tests/torch_scaleout_worker.py train OUT_DIR
    python tests/torch_scaleout_worker.py dense OUT_DIR
    python tests/torch_scaleout_worker.py collectives OUT_DIR
    python tests/torch_scaleout_worker.py families OUT_DIR ARCH [ARCH ...]
    python tests/torch_scaleout_worker.py fake OUT_DIR [MESH ...]
    python tests/torch_scaleout_worker.py fake_families OUT_DIR MESH NAME ...

Each spawns WORLD gloo ranks on the CPU that rendezvous through a
``FileStore`` under OUT_DIR (no port), pins each rank to one intra-op
thread, joins every rank within ``JOIN_S`` seconds and exits non-zero
with each failing rank's traceback. ``train`` runs ``run_training`` on
the 2×2 and 1×4 meshes, saves on 2×2, restores that checkpoint onto 4×1
and trains on; ``dense`` runs each ``DENSE`` config on 2×2;
``collectives`` records one train step's collectives on a 2×2 mesh;
``families`` trains and serves (``serve``) each named ``FAMILIES``
config on 2×2. Rank 0 writes what it saw to OUT_DIR as JSON (and the
gathered params as a checkpoint). ``fake`` and ``fake_families`` trace
dry-run cells on fake process groups in one process and write one JSON
per cell. The test files load this module for its configs and for the
helpers at its end.
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


# the MoE, hybrid and ssm configs, reduced, each with overrides that take
# it down the path its full config takes on the production meshes
FAMILIES = {
    # 4 experts of capacity 8 at top-2 over 16-token groups: tokens past
    # an expert's capacity are dropped
    "qwen2-moe-a2.7b": dict(num_experts=4, capacity_factor=0.25),
    "deepseek-moe-16b": dict(),
    # 5 heads over 1 KV head (hymba's 25 over 5 on 16): on a 2-way model
    # axis k/v repeat to 5 heads and pad to 6; a window shorter than the
    # sequence
    "hymba-1.5b": dict(num_heads=5, num_kv_heads=1, sliding_window=8),
    # 3 heads (xlstm's 4 on 16) on a 2-way model axis: the mLSTM keeps
    # heads whole and splits the batch
    "xlstm-1.3b": dict(d_model=48, num_heads=3, num_kv_heads=3),
}


def config(arch: str = ARCH):
    """The reduced ``arch`` with its ``DENSE`` or ``FAMILIES``
    overrides."""
    from repro_torch.configs import reduced_config

    return reduced_config(arch, **{**DENSE, **FAMILIES}[arch])


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


SERVE_NEW = 4


def serve(cfg, mesh=None, device="cpu"):
    """A seeded init of ``cfg`` serving ``BATCH`` seeded ``SEQ``-token
    prompts: the prefill and ``SERVE_NEW`` greedy decode steps, sharded
    under ``default_rules(mesh)`` when a mesh is given -> (fp32 logits of
    each step, gathered whole, stacked; the greedy tokens)."""
    from repro_torch.models import build_model
    from repro_torch.parallel.sharding import (
        axis_rules, batch_spec, default_rules, gather_full, param_shardings,
        shard, shard_tree)

    model = build_model(cfg, device=device)
    params = model.init(torch.Generator(device).manual_seed(0))
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, SEQ),
                            generator=torch.Generator().manual_seed(5),
                            dtype=torch.int32).to(device)
    rules = None if mesh is None else default_rules(mesh)
    place = lambda t: t
    with axis_rules(rules):
        if rules is not None:
            params = shard_tree(params, param_shardings(
                rules, model.param_logical_axes(), params))
            place = lambda t: shard(t, batch_spec(rules, 2, shape=t.shape))
        cache, logits = model.prefill(params, place(prompts),
                                      SEQ + SERVE_NEW)
        steps = [gather_full(logits).float()]
        toks = []
        for _ in range(SERVE_NEW):
            tok = steps[-1].argmax(-1).to(torch.int32)
            toks.append(tok)
            cache, logits = model.decode_step(params, cache, place(tok))
            steps.append(gather_full(logits).float())
    return torch.cat(steps, dim=1), torch.cat(toks, dim=1)


def _families_rank(rank: int, out: str, archs: Sequence[str]) -> None:
    from repro_torch.checkpoint import save_pytree
    from repro_torch.launch.train import run_training
    from repro_torch.parallel.sharding import gather_full
    from repro_torch.utils.tree import tree_map

    record = {}
    for arch in archs:
        cfg = config(arch)
        ckpt = os.path.join(out, f"ckpt_{arch}")
        res = run_training(cfg, train_config(ckpt), seq_len=SEQ,
                           global_batch=BATCH, mesh=_mesh((2, 2)),
                           masks=masks_for(cfg), device="cpu")
        record[arch] = [r.metrics for r in res["metrics"]]
        params = tree_map(gather_full, res["state"]["params"])
        logits, tokens = serve(cfg, _mesh((2, 2)))
        if rank == 0:
            save_pytree(os.path.join(out, f"params_{arch}"), params)
            save_pytree(os.path.join(out, f"serve_{arch}"),
                        {"logits": logits, "tokens": tokens})
    if rank == 0:
        with open(os.path.join(out, "families.json"), "w") as f:
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
           "collectives": _collectives_rank, "families": _families_rank}

FAKE_MESHES = {"4x4": ((4, 4), ("data", "model")),
               "2x4x4": ((2, 4, 4), ("pod", "data", "model")),
               "2x2": ((2, 2), ("data", "model"))}


# the family cells traced with and without replay (``fake_families``):
# a train step of four chunks of the recurrent cells' loops (a chunk's
# first, middle and last backward differ in which inputs need a
# gradient), a prefill of two, a MoE layer's groups routed in every layer
SMALL_CELLS = {"hymba-1.5b": ("train", "prefill"),
               "xlstm-1.3b": ("train", "prefill"),
               "qwen2-moe-a2.7b": ("train", "prefill")}
SMALL_SEQ = {"train": 1024, "prefill": 512}
# xlstm's train cell at one group (3 mLSTM + 1 sLSTM): traced in full,
# its sLSTM loop steps 1 024 times a group forward and again backward
SMALL_CUT = {("xlstm-1.3b", "train"): {"num_layers": 4}}


def _fake_mesh(mesh_name: str):
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch.dryrun import fake_process_group

    shape, names = FAKE_MESHES[mesh_name]
    world = 1
    for n in shape:
        world *= n
    fake_process_group(world)
    return init_device_mesh("cpu", shape, mesh_dim_names=names)


def _write_cell(out: str, cfg, arch: str, cell, mesh, mesh_name: str,
                tag: str = "", **kw) -> None:
    """Trace (or skip, with the reference's reason) one cell and write
    its record to OUT as ``<arch>__<shape>__<mesh><tag>.json``."""
    from repro_torch.configs.shapes import skip_reason
    from repro_torch.launch.dryrun import lower_cell

    reason = skip_reason(cfg, cell)
    t0 = time.time()
    rec = ({"status": "skipped", "reason": reason} if reason else
           dict(lower_cell(cfg, cell, mesh, **kw), status="ok"))
    rec.update(arch=arch, shape=cell.name, mesh=mesh_name,
               trace_seconds=time.time() - t0)
    with open(os.path.join(
            out, f"{arch}__{cell.name}__{mesh_name}{tag}.json"), "w") as f:
        json.dump(rec, f)


def fake_families(out: str, mesh_name: str, names: Sequence[str]) -> None:
    """On the fake ``mesh_name`` group, for each name ``ARCH``: every
    shape of the reduced config; for ``ARCH:small``: its ``SMALL_CELLS``
    traced with replay (tag ``_replay``) and without (``_full``); for
    ``ARCH:KIND`` that one of them."""
    import dataclasses

    from repro_torch.configs import reduced_config
    from repro_torch.configs.base import SHAPES, ShapeConfig

    torch.set_num_threads(1)
    mesh = _fake_mesh(mesh_name)
    for name in names:
        arch, _, what = name.partition(":")
        cfg = reduced_config(arch)
        if not what:
            for cell in SHAPES.values():
                _write_cell(out, cfg, arch, cell, mesh, mesh_name)
            continue
        for kind in SMALL_CELLS[arch] if what == "small" else (what,):
            cell = ShapeConfig(kind + "_small", SMALL_SEQ[kind], 4, kind)
            cut = dataclasses.replace(cfg, **SMALL_CUT.get((arch, kind), {}))
            for replay in (True, False):
                _write_cell(out, cut, arch, cell, mesh, mesh_name,
                            "_replay" if replay else "_full", replay=replay)


def fake(out: str, meshes: Sequence[str] = ()) -> None:
    """Every shape of a reduced dense config on fake 4×4 and 2×4×4
    groups, the same cells traced at every tile, and the small train
    step of ``collectives`` on a fake 2×2 one, in this one process (rank
    0 of each fake group); only those of ``meshes`` (``FAKE_MESHES``
    keys) if any are named."""
    from repro_torch.configs import reduced_config
    from repro_torch.configs.base import SHAPES, ShapeConfig
    from repro_torch.launch.dryrun import lower_cell

    torch.set_num_threads(1)
    small = ShapeConfig("train_small", SEQ, BATCH, "train")
    for mesh_name in FAKE_MESHES:
        if meshes and mesh_name not in meshes:
            continue
        mesh = _fake_mesh(mesh_name)
        cells = ([(ARCH, small)] if mesh_name == "2x2" else
                 [(DRY_ARCH, s) for s in SHAPES.values()])
        for arch, cell in cells:
            cfg = config() if arch == ARCH else reduced_config(arch)
            _write_cell(out, cfg, arch, cell, mesh, mesh_name)
        if mesh_name == "4x4":
            # the same cells traced tile by tile
            for name in ("train_4k", "prefill_32k", "decode_32k"):
                rec = dict(lower_cell(reduced_config(DRY_ARCH), SHAPES[name],
                                      mesh, replay=False), status="ok",
                           arch=DRY_ARCH, shape=name + "_full",
                           mesh=mesh_name)
                with open(os.path.join(out, f"full__{name}.json"), "w") as f:
                    json.dump(rec, f)


def _rank(rank: int, mode: str, out: str, names: Sequence[str]) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(
        os.path.join(out, "store"), WORLD), rank=rank, world_size=WORLD)
    try:
        WORKERS[mode](rank, out, *([names] if names else []))
    finally:
        dist.destroy_process_group()


def run(mode: str, out: str, names: Sequence[str] = ()) -> None:
    """Spawn WORLD ranks of ``mode`` (given ``names``, the archs of
    ``families``) and join them within ``JOIN_S``."""
    ctx = mp.start_processes(_rank, args=(mode, out, tuple(names)),
                             nprocs=WORLD, start_method="spawn", join=False)
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
        elif sys.argv[1] == "fake_families":
            fake_families(sys.argv[2], sys.argv[3], sys.argv[4:])
        else:
            run(sys.argv[1], sys.argv[2], sys.argv[3:])
    except Exception:  # noqa: BLE001 — report every rank's failure
        traceback.print_exc()
        sys.exit(1)
