"""The four dense configs trained sharded on ``torch.distributed`` (gloo,
4 ranks on the CPU, a 2×2 ("data", "model") mesh) against their
one-process runs and against the reference's sharded step.

Each config is reduced and keeps what takes it down a path of its own
under the axis rules (``torch_scaleout_worker.DENSE``): qwen2's 6 heads
over 2 KV heads, granite's own vocab (no model axis divides it: the
table and the logits stay replicated there), phi4's 24 heads over 8 and
danube's window (shorter than the sequence, under head-parallel
attention). ``tests/jax_sharded_reference.py`` runs the reference's
``make_train_step`` jitted on a 2×2 mesh of 4 host devices from the
port's init, masks and batches. Losses and grad norms agree within 2e-5
relative at every step, params as ``params_close`` allows, and pruned
weights stay exactly 0. On a 1×1 mesh of one rank (in this process) each
config is its one-process run bit for bit.

Two spawns, run at once: ``tests/torch_scaleout_worker.py dense`` and
the reference.
"""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import load_pytree
from repro_torch.convert import tree_to_jax
from repro_torch.launch.train import run_training
from repro_torch.parallel.sharding import gather_full
from repro_torch.utils.tree import tree_items, tree_map

HERE = os.path.dirname(os.path.abspath(__file__))


def _load_worker():
    spec = importlib.util.spec_from_file_location(
        "torch_scaleout_worker",
        os.path.join(HERE, "torch_scaleout_worker.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


W = _load_worker()
ARCHS = list(W.DENSE)


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """The port's 2×2 runs (4 gloo ranks) and the reference's (4 host
    devices), started at once."""
    out = str(tmp_path_factory.mktemp("dense"))
    procs = (W.start([os.path.join(HERE, "torch_scaleout_worker.py"),
                      "dense", out]),
             W.start([os.path.join(HERE, "jax_sharded_reference.py"),
                      "train", out] + ARCHS))
    yield out, procs
    for p in procs:
        if p.poll() is None:
            p.kill()


@pytest.fixture(scope="module")
def singles(tmp_path_factory, spawned):
    """arch -> its one-process run (while the spawns run)."""
    torch.set_num_threads(1)
    runs = {}
    for arch in ARCHS:
        cfg = W.config(arch)
        ckpt = str(tmp_path_factory.mktemp("single"))
        runs[arch] = run_training(cfg, W.train_config(ckpt), seq_len=W.SEQ,
                                  global_batch=W.BATCH,
                                  masks=W.masks_for(cfg), device="cpu")
    return runs


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory, singles):
    """arch -> its run on a 1×1 mesh of one gloo rank in this process."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    tmp = tmp_path_factory.mktemp("one_rank")
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp / "store"), 1), rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1, 1),
                                mesh_dim_names=("data", "model"))
        runs = {}
        for arch in ARCHS:
            cfg = W.config(arch)
            runs[arch] = run_training(
                cfg, W.train_config(str(tmp / arch)), seq_len=W.SEQ,
                global_batch=W.BATCH, mesh=mesh, masks=W.masks_for(cfg),
                device="cpu")
            runs[arch]["state"]["params"] = tree_map(
                gather_full, runs[arch]["state"]["params"])
    finally:
        dist.destroy_process_group()
    return runs


@pytest.fixture(scope="module")
def sharded(spawned):
    """arch -> (the port's 2×2 metrics, its final params, whole)."""
    out, (port, _) = spawned
    W.wait(port)
    with open(os.path.join(out, "dense.json")) as f:
        rec = json.load(f)
    return {a: (rec[a], load_pytree(os.path.join(out, f"params_{a}"),
                                    device="cpu")) for a in ARCHS}


@pytest.fixture(scope="module")
def reference(spawned):
    """arch -> (the reference's 2×2 metrics, its final params in its own
    stacked layout)."""
    out, (_, ref) = spawned
    W.wait(ref)
    got = {}
    for arch in ARCHS:
        with open(os.path.join(out, f"ref_{arch}.json")) as f:
            metrics = json.load(f)
        with np.load(os.path.join(out, f"ref_{arch}.npz")) as z:
            got[arch] = metrics, {k: torch.from_numpy(z[k]) for k in z.files}
    return got


@pytest.mark.parametrize("arch", ARCHS)
def test_one_rank_mesh_is_bit_equal_to_no_mesh(one_rank, singles, arch):
    """Every axis of extent 1 places ``Replicate()``, so each op runs on
    the whole tensor, and the gradients' sums meet in the same order:
    metrics and params equal bit for bit, fp32 params included."""
    got, want = one_rank[arch], singles[arch]
    assert [r.metrics for r in got["metrics"]] == [
        r.metrics for r in want["metrics"]]
    a = dict(tree_items(got["state"]["params"]))
    b = dict(tree_items(want["state"]["params"]))
    assert set(a) == set(b)
    for path in b:
        assert torch.equal(a[path], b[path]), path


@pytest.mark.parametrize("arch", ARCHS)
def test_2x2_run_matches_one_process(sharded, singles, arch):
    metrics, params = sharded[arch]
    want = singles[arch]
    assert len(metrics) == len(want["metrics"]) == W.STEPS
    W.close(metrics, [r.metrics for r in want["metrics"]])
    W.params_close(params, dict(tree_items(want["state"]["params"])))


@pytest.mark.parametrize("arch", ARCHS)
def test_2x2_run_matches_the_reference(sharded, reference, arch):
    metrics, params = sharded[arch]
    want, want_params = reference[arch]
    assert len(want) == len(metrics) == W.STEPS
    W.close(metrics, want)
    got = tree_to_jax(params)
    assert {p for p, _ in tree_items(got)} == set(want_params)
    W.params_close(got, want_params)


@pytest.mark.parametrize("arch", ARCHS)
def test_pruned_weights_stay_exactly_zero(sharded, arch):
    params = dict(tree_items(sharded[arch][1]))
    n = 0
    for path, m in tree_items(W.masks_for(W.config(arch))):
        if m is None:
            continue
        assert torch.all(params[path][m == 0] == 0), path
        n += 1
    assert n > 0
