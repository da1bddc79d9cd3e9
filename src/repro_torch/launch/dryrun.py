"""Multi-pod dry-run on a fake process group (mirrors
``repro/launch/dryrun.py``).

Traces every (architecture × input shape) cell on the production meshes
— 16×16 (single pod, 256 cards) and 2×16×16 (two pods, 512 cards) — and
records per-device memory, FLOPs, bytes and collective bytes for the
roofline report (``roofline/report.py``).

Where the reference lowers and compiles through XLA on 512 host devices,
the port runs one step on rank 0 of torch's FAKE process group (its
collectives return at once and move nothing) with the model, the state
and the inputs on the meta device as DTensors of their placements (no
storage anywhere), under ``roofline.step_costs.record_step``: so every
number is what rank 0 of the real mesh would run, from the ops DTensor's
sharding propagation issues. ``memory.argument_bytes`` is exact (rank 0's
local shard bytes of every input); ``temp_bytes`` is the peak of the
bytes the traced step's own outputs hold alive.

The prefill cells trace the plain ``blockwise_attention``, as the
reference's lowering does off-TPU (its ``use_flash`` is on only on a TPU
backend); that is not the served route, which on the card runs the flash
kernel: the ctypes kernels cannot take meta tensors. Each tile of the
blockwise attention's loops is traced once per shape and its recorded
costs replayed for the other tiles of that shape, and so are a
prefill's whole attention call for the layers after the first, each
chunk of the recurrent cells' time loops (forward and recomputed
backward) and the MoE's routing of a batch of groups (the model marks
these regions ``roofline.step_costs.replayable``; ``_Replay`` handles
them here), as the
reference's cost parser multiplies a loop body by its trip count: costs
that do not depend on values come out the same, traced in seconds in
place of minutes (a mamba prefill_32k steps 32 768 times a layer).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
        --shape all --mesh both --out experiments/dryrun_torch
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-1.5b \\
        --shape train_4k --mesh single --masked
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.base import SHAPES
from repro_torch.configs.shapes import input_specs, skip_reason
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.train import make_train_step, train_state_specs
from repro_torch.models import build_model
from repro_torch.optim import adamw
from repro_torch.parallel.sharding import (
    axis_rules,
    default_rules,
    is_dtensor,
    param_shardings,
    shard_tree,
)
from repro_torch.roofline.step_costs import (
    cost_scope,
    op_rows,
    record_step,
    replay_regions,
)
from repro_torch.utils.tree import tree_leaves, tree_map

MESH_NAMES = {False: "16x16", True: "2x16x16"}


def fake_process_group(world_size: int) -> None:
    """The default process group as rank 0 of ``world_size`` fake ranks
    (torch's test backend: no process, no transport). Raises if this
    torch has none."""
    import torch.distributed as dist

    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError(
            "this torch has no fake process group "
            "(torch.testing._internal.distributed.fake_pg); the dry-run "
            "needs it to plan a mesh larger than the host") from e
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def _key(x):
    """A hashable stand-in of a call's argument: a tensor's shape and
    dtype, a sequence's items' keys, any other value as it is."""
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), x.dtype)
    if isinstance(x, (list, tuple)):
        return tuple(_key(v) for v in x)
    return x


def _flat(x) -> list:
    """The tensors of a (nested) argument or result, None kept."""
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _flat(v)]
    return [x]


class _Out(NamedTuple):
    shape: tuple
    dtype: torch.dtype


class _Replay:
    """The handler of the model's ``replayable`` regions (the blockwise
    attention's tiles and the model's whole attention call, replayed per
    layer where nothing needs a gradient, as in a prefill cell; the
    recurrent cells' chunks, forward and recomputed backward, each
    chunk's inputs detached; the MoE's routing of a batch of groups):
    each call is recorded under its scope and, with ``replay``, traced
    once per function and argument shapes: a later call of the same
    shapes replays the first one's recorded costs and returns empty
    (meta) outputs of its shapes. A call with an input that needs a
    gradient runs for real: its backward has to be traced too (the
    regions within it are then replayed)."""

    def __init__(self, mode, replay: bool):
        self.mode, self.replay = mode, replay
        self.seen: Dict[Any, Any] = {}

    def __call__(self, scope: str, fn, args: tuple, kwargs: dict):
        with cost_scope(scope):
            return self._call(fn, args, kwargs)

    def _call(self, fn, args: tuple, kwargs: dict):
        tensors = [a for a in _flat(args) if isinstance(a, torch.Tensor)]
        if not self.replay or any(t.requires_grad for t in tensors):
            return fn(*args, **kwargs)
        key = (fn,) + _key(args) + tuple(sorted(kwargs.items()))
        if key in self.seen:
            delta, outs = self.seen[key]
            made = self._make(outs, tensors[0].device)
            ts = [t for t in _flat(made) if t is not None]
            self.mode.replay(delta, holder=ts[0] if ts else None,
                             outputs=ts)
            return made
        snap = self.mode.snapshot()
        out = fn(*args, **kwargs)
        self.seen[key] = (self.mode.delta(snap), self._spec(out))
        return out

    @classmethod
    def _spec(cls, out):
        """The shapes and dtypes of a result (tuples and None kept)."""
        if isinstance(out, tuple):
            return tuple(cls._spec(o) for o in out)
        return None if out is None else _Out(tuple(out.shape), out.dtype)

    @classmethod
    def _make(cls, spec, device):
        """Empty tensors of a result's ``_spec``."""
        if isinstance(spec, _Out):
            return torch.empty(spec.shape, dtype=spec.dtype, device=device)
        return None if spec is None else tuple(cls._make(s, device)
                                               for s in spec)


def _local_bytes(tree: Any) -> int:
    total = 0
    for x in tree_leaves(tree):
        if isinstance(x, torch.Tensor):
            t = x.to_local() if is_dtensor(x) else x
            total += t.numel() * t.element_size()
    return total


def lower_cell(cfg, shape, mesh, *, masked: bool = False,
               grad_compression: bool = False,
               replay: bool = True) -> Dict[str, Any]:
    """Trace one (arch, shape, mesh) cell on rank 0 of the mesh's fake
    group. Returns the result dict. ``replay=False`` traces every tile
    and layer of the attention (the same numbers, minutes for a
    prefill_32k cell)."""
    rules = default_rules(mesh)
    model = build_model(cfg, device="cpu").on_meta()
    specs = input_specs(cfg, shape, rules=rules)
    with axis_rules(rules), record_step("meta") as rec, \
            replay_regions(_Replay(rec, replay)):
        if specs["kind"] == "train":
            optimizer = adamw(1e-4, weight_decay=0.0)
            shapes, shardings = train_state_specs(
                model, optimizer, rules, grad_compression=grad_compression)
            state = shard_tree(shapes, shardings)
            args: Sequence[Any] = (state, specs["batch"])
            masks = None
            if masked:
                # the paper's masked-retraining variant: a mask tree shaped
                # (and sharded) like the params
                masks = shard_tree(tree_map(
                    lambda w: w.to(torch.bfloat16), model.abstract_params()),
                    shardings["params"])
                args = (state, specs["batch"], masks)
            step = make_train_step(model, optimizer, masks=masks,
                                   grad_compression=grad_compression)
            out = step(state, specs["batch"])
        else:
            abstract = model.abstract_params()
            params = shard_tree(abstract, param_shardings(
                rules, model.param_logical_axes(), abstract))
            if specs["kind"] == "prefill":
                args = (params, specs["inputs"])
                with torch.no_grad():
                    if cfg.encoder_only:
                        h, _ = model.hidden_states(params, specs["inputs"])
                        out = model.lm_logits(params, h)
                    else:
                        out = model.prefill(params, specs["inputs"],
                                            specs["seq_len"])
            else:
                args = (params, specs["cache"], specs["tokens"])
                out = model.decode_step(params, specs["cache"],
                                        specs["tokens"])
    coll = dict(rec.costs.collective_bytes)
    coll["total"] = rec.costs.collective_total
    return {
        "memory": {
            "argument_bytes": _local_bytes(args),
            "output_bytes": _local_bytes(out),
            "temp_bytes": rec.peak_bytes,
        },
        "flops": rec.costs.flops,
        "bytes_accessed": rec.costs.bytes,
        "collectives": coll,
        "ops": op_rows(rec),
    }


_MESHES: Dict[bool, Any] = {}


def _mesh(multi: bool):
    """The production mesh on a fake group of its size (one at a time in
    a process: a new size re-initialises the group)."""
    if multi not in _MESHES:
        _MESHES.clear()
        fake_process_group(512 if multi else 256)
        _MESHES[multi] = make_production_mesh(multi, device_type="cpu")
    return _MESHES[multi]


def _cell(multi: bool, arch: str, shape_name: str, out_dir: str,
          masked: bool) -> Tuple[str, str]:
    """Trace one cell, write its JSON -> (the line to print, status)."""
    torch.set_num_threads(1)
    mesh_name = MESH_NAMES[multi]
    cfg, shape = get_config(arch), SHAPES[shape_name]
    tag = f"{arch}__{shape_name}__{mesh_name}"
    reason = skip_reason(cfg, shape)
    if reason is not None:
        line = f"SKIP {tag}: {reason}"
        rec: Dict[str, Any] = {"status": "skipped", "reason": reason}
    else:
        t0 = time.time()
        try:
            rec = lower_cell(cfg, shape, _mesh(multi), masked=masked)
            rec["status"] = "ok"
            rec["trace_seconds"] = time.time() - t0
            line = (f"OK   {tag}: "
                    f"flops={rec['flops']:.3e} "
                    f"bytes={rec['bytes_accessed']:.3e} "
                    f"coll={rec['collectives']['total']:.3e} "
                    f"args={rec['memory']['argument_bytes']/2**30:.2f}GiB "
                    f"temp={rec['memory']['temp_bytes']/2**30:.2f}GiB "
                    f"({rec['trace_seconds']:.1f}s)")
        except Exception as e:  # noqa: BLE001
            rec = {"status": "failed", "error": str(e),
                   "traceback": traceback.format_exc()}
            line = f"FAIL {tag}: {e}"
    rec["arch"] = arch
    rec["shape"] = shape_name
    rec["mesh"] = mesh_name
    with open(os.path.join(out_dir, tag + ".json"), "w") as f:
        json.dump(rec, f, indent=1)
    return line, rec["status"]


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--masked", action="store_true",
                    help="include the pruning-mask train variant")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells traced at once, each in a process of its own")
    args = ap.parse_args(argv)
    archs = sorted(ARCHS) if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    os.makedirs(args.out, exist_ok=True)
    cells = [(multi, arch, shape) for multi in meshes for arch in archs
             for shape in shapes]
    counts = {"ok": 0, "skipped": 0, "failed": 0}
    if args.jobs > 1:
        import multiprocessing as mp
        from concurrent.futures import ProcessPoolExecutor

        with ProcessPoolExecutor(args.jobs,
                                 mp_context=mp.get_context("spawn")) as ex:
            futs = [ex.submit(_cell, *c, args.out, args.masked)
                    for c in cells]
            for fut in futs:
                line, status = fut.result()
                print(line, flush=True)
                counts[status] += 1
    else:
        import torch.distributed as dist

        for c in cells:
            line, status = _cell(*c, args.out, args.masked)
            print(line, flush=True)
            counts[status] += 1
        _MESHES.clear()
        if dist.is_initialized():
            dist.destroy_process_group()
    print(f"\ndry-run complete: {counts['ok']} ok, {counts['skipped']} "
          f"skipped, {counts['failed']} failed")
    if counts["failed"]:
        raise SystemExit(1)
    return 0


if __name__ == "__main__":
    main()
