"""Sharded masked training on ``torch.distributed`` (gloo, 4 ranks on the
CPU) against the one-process run: ``run_training`` on 2×2 and 1×4
meshes (fp32 reduced qwen2, masks, int8 compression) matches the
unsharded run within 2e-5 relative at every step with pruned weights
exactly 0; the 2×2 checkpoint restores bit-equal on 4×1 and on no mesh,
and training goes on from it within the same tolerance; the distributed
example runs on 4 gloo ranks.

Two spawns, run at once: ``tests/torch_scaleout_worker.py train`` and
the example. The one-process runs are the port's ``mesh=None`` path,
which ``tests/test_torch_train_driver.py`` holds to the reference;
``tests/test_torch_scaleout_dense.py`` holds the sharded runs of the
four dense configs to the reference's sharded step.
"""

import importlib.util
import json
import os
import shutil

import pytest
import torch

from repro_torch.checkpoint import CheckpointManager, load_pytree
from repro_torch.launch.train import init_state, run_training
from repro_torch.models import build_model
from repro_torch.optim import adamw
from repro_torch.utils.tree import tree_items

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _load_worker():
    spec = importlib.util.spec_from_file_location(
        "torch_scaleout_worker",
        os.path.join(HERE, "torch_scaleout_worker.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


W = _load_worker()


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """The file's two spawns, started at once: the training worker and
    the example, each on 4 gloo ranks."""
    out = str(tmp_path_factory.mktemp("scaleout"))
    procs = (W.start([os.path.join(HERE, "torch_scaleout_worker.py"),
                     "train", out]),
             W.start([os.path.join(ROOT, "examples",
                                  "torch_distributed_masked_retraining.py"),
                     "--device", "cpu", "--world", "4", "--steps", "2",
                     "--resume-steps", "1"]))
    yield out, procs
    for p in procs:
        if p.poll() is None:
            p.kill()


@pytest.fixture(scope="module")
def sharded(spawned):
    out, (train, _) = spawned
    W.wait(train)
    with open(os.path.join(out, "train.json")) as f:
        return out, json.load(f)


@pytest.fixture(scope="module")
def single(tmp_path_factory, spawned):
    """The one-process run of the same config, masks and data (while the
    spawned ranks run)."""
    torch.set_num_threads(1)
    cfg = W.config()
    ckpt = str(tmp_path_factory.mktemp("single"))
    res = run_training(cfg, W.train_config(ckpt), seq_len=W.SEQ,
                       global_batch=W.BATCH, masks=W.masks_for(cfg),
                       device="cpu")
    return res


@pytest.mark.parametrize("mesh", ["2x2", "1x4"])
def test_sharded_run_matches_one_process(sharded, single, mesh):
    out, rec = sharded
    want = [r.metrics for r in single["metrics"]]
    assert len(rec[mesh]) == len(want) == W.STEPS
    W.close(rec[mesh], want)
    W.params_close(load_pytree(os.path.join(out, f"params_{mesh}"),
                              device="cpu"),
                  dict(tree_items(single["state"]["params"])))


@pytest.mark.parametrize("mesh", ["2x2", "1x4"])
def test_pruned_weights_stay_exactly_zero(sharded, mesh):
    out, _ = sharded
    params = dict(tree_items(load_pytree(os.path.join(out, f"params_{mesh}"),
                                         device="cpu")))
    n = 0
    for path, m in tree_items(W.masks_for(W.config())):
        if m is None:
            continue
        assert torch.all(params[path][m == 0] == 0), path
        n += 1
    assert n > 0


def test_checkpoint_restores_bit_equal_on_4x1_and_unsharded(sharded):
    """Saved on 2×2 (gathered, written whole by rank 0), restored onto
    4×1 as DTensors (gathered again) and onto no mesh: every leaf is
    the 2×2 run's final params, bit for bit."""
    out, rec = sharded
    # 4x1 restore shards the embed dim 4 ways and replicates the rest
    assert "(Shard(dim=0), Replicate())" in rec["placements_4x1"]
    final = dict(tree_items(load_pytree(os.path.join(out, "params_2x2"),
                                        device="cpu")))
    on_4x1 = dict(tree_items(load_pytree(
        os.path.join(out, "params_2x2_on_4x1"), device="cpu")))
    cfg = W.config()
    like = init_state(build_model(cfg, device="cpu"), adamw(1e-3),
                      torch.Generator().manual_seed(0),
                      masks=W.masks_for(cfg), grad_compression=True)
    manager = CheckpointManager(os.path.join(out, "ckpt_2x2"))
    assert manager.latest_step() == W.STEPS
    unsharded = dict(tree_items(manager.restore(like)["params"]))
    assert set(final) == set(on_4x1) == set(unsharded)
    for path in final:
        assert torch.equal(on_4x1[path], final[path]), path
        assert torch.equal(unsharded[path], final[path]), path


def test_training_goes_on_after_the_4x1_restore(sharded, tmp_path):
    """4×1 resumed from the 2×2 checkpoint = one process resumed from
    it, step for step within the tolerance."""
    out, rec = sharded
    ckpt = str(tmp_path / "ckpt")
    shutil.copytree(os.path.join(out, "ckpt_2x2"), ckpt)
    cfg = W.config()
    res = run_training(cfg, W.train_config(ckpt, save_every=10 * W.STEPS),
                       seq_len=W.SEQ, global_batch=W.BATCH,
                       masks=W.masks_for(cfg), device="cpu")
    want = [r.metrics for r in res["metrics"]]
    assert [r.step for r in res["metrics"]] == [W.STEPS, W.STEPS + 1]
    W.close(rec["4x1_resumed"], want)
    W.params_close(load_pytree(os.path.join(out, "params_4x1_resumed"),
                              device="cpu"),
                  dict(tree_items(res["state"]["params"])))


def test_distributed_example_on_four_gloo_ranks(spawned):
    text = W.wait(spawned[1][1])
    assert "[mesh] 4 rank(s) on cpu: 1x4 -> 4x1" in text
    assert "[designer] pruned 2.00x" in text
    for tag in ("[train 1x4] 2 steps", "[resume 1x4] +1 steps",
                "[elastic 4x1] +1 steps", "[check]"):
        assert tag in text, text
    line = next(l for l in text.splitlines() if l.startswith("[check]"))
    diff = float(line.split("largest difference ")[1].split(":")[0])
    assert diff < 1e-4
