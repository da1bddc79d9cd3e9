"""The MoE, hybrid and ssm families trained and served sharded on
``torch.distributed`` (gloo, 4 ranks on the CPU, a 2×2 ("data", "model")
mesh), shared by the ``test_torch_scaleout_families*.py`` files: each
sets ``ARCH`` (a key of ``torch_scaleout_worker.FAMILIES``) and takes
this module's fixtures and tests, so each arch's spawns run in a file of
their own.

The config is reduced, with the overrides that take it down the path its
full config takes on the production meshes (``FAMILIES``). Two spawns,
started at once: ``tests/torch_scaleout_worker.py families`` (the 2×2
run: ``run_training`` with masks and int8 compression, then a sharded
prefill and greedy decode steps) and ``tests/jax_sharded_reference.py
train`` (the reference's step jitted on a 2×2 mesh of 4 host devices,
from the port's init, masks and batches). Losses and grad norms agree
within 2e-5 relative at every step, with one process and with the
reference; params as ``params_close`` allows; pruned weights stay
exactly 0; the sharded fp32 logits are within 2e-5 of one process's and
the greedy tokens the same. On a 1×1 mesh of one rank (in this process)
training and serving are the one-process run bit for bit, and the 2×2
run's checkpoint restores bit-equal onto that mesh and onto none.
"""

import dataclasses
import importlib.util
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JModelConfig
from repro.models import build_model as ref_build_model

from repro_torch.checkpoint import CheckpointManager, load_pytree
from repro_torch.convert import tree_to_jax
from repro_torch.launch.train import init_state, run_training
from repro_torch.models import build_model
from repro_torch.models.moe import route_local
from repro_torch.optim import adamw
from repro_torch.parallel import sharding as sh
from repro_torch.utils.tree import tree_items, tree_map

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "torch_scaleout_worker.py")


def _load_worker():
    spec = importlib.util.spec_from_file_location("torch_scaleout_worker",
                                                  WORKER)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


W = _load_worker()

__all__ = ["arch", "spawned", "single", "one_rank", "sharded", "reference",
           "restored", "test_config_takes_its_path_in_both_packages",
           "test_one_rank_mesh_is_bit_equal_to_no_mesh",
           "test_one_rank_serving_is_bit_equal_to_no_mesh",
           "test_2x2_run_matches_one_process",
           "test_2x2_run_matches_the_reference",
           "test_pruned_weights_stay_exactly_zero",
           "test_2x2_serving_matches_one_process",
           "test_2x2_checkpoint_restores_bit_equal_on_one_rank_and_unsharded"]


@pytest.fixture(scope="module")
def arch(request):
    return request.module.ARCH


@pytest.fixture(scope="module")
def spawned(tmp_path_factory, arch):
    """The port's 2×2 run (4 gloo ranks) and the reference's (4 host
    devices), started at once."""
    out = str(tmp_path_factory.mktemp("families"))
    procs = (W.start([WORKER, "families", out, arch]),
             W.start([os.path.join(HERE, "jax_sharded_reference.py"),
                      "train", out, arch]))
    yield out, procs
    for p in procs:
        if p.poll() is None:
            p.kill()


@pytest.fixture(scope="module")
def single(tmp_path_factory, spawned, arch):
    """The one-process run and serving (while the spawns run)."""
    torch.set_num_threads(1)
    cfg = W.config(arch)
    res = run_training(cfg, W.train_config(str(tmp_path_factory.mktemp(
        "single"))), seq_len=W.SEQ, global_batch=W.BATCH,
        masks=W.masks_for(cfg), device="cpu")
    res["serve"] = W.serve(cfg)
    return res


def _one_rank_group(tmp):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp / "store"), 1), rank=0, world_size=1)
    return init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory, single, arch):
    """The run and serving on a 1×1 mesh of one gloo rank in this
    process."""
    import torch.distributed as dist

    tmp = tmp_path_factory.mktemp("one_rank")
    try:
        mesh = _one_rank_group(tmp)
        cfg = W.config(arch)
        res = run_training(cfg, W.train_config(str(tmp / "ckpt")),
                           seq_len=W.SEQ, global_batch=W.BATCH, mesh=mesh,
                           masks=W.masks_for(cfg), device="cpu")
        res["state"]["params"] = tree_map(sh.gather_full,
                                          res["state"]["params"])
        res["serve"] = W.serve(cfg, mesh)
    finally:
        dist.destroy_process_group()
    return res


@pytest.fixture(scope="module")
def sharded(spawned, arch):
    """(the port's 2×2 metrics, its final params whole, its serving)."""
    out, (port, _) = spawned
    W.wait(port)
    with open(os.path.join(out, "families.json")) as f:
        metrics = json.load(f)[arch]
    served = load_pytree(os.path.join(out, f"serve_{arch}"), device="cpu")
    return (metrics, load_pytree(os.path.join(out, f"params_{arch}"),
                                 device="cpu"),
            (served["logits"], served["tokens"]))


@pytest.fixture(scope="module")
def reference(spawned, arch):
    """(the reference's 2×2 metrics, its final params in its own stacked
    layout)."""
    out, (_, ref) = spawned
    W.wait(ref)
    with open(os.path.join(out, f"ref_{arch}.json")) as f:
        metrics = json.load(f)
    with np.load(os.path.join(out, f"ref_{arch}.npz")) as z:
        return metrics, {k: torch.from_numpy(z[k]) for k in z.files}


@pytest.fixture(scope="module")
def restored(tmp_path_factory, spawned, sharded, arch):
    """The 2×2 run's step-``STEPS`` checkpoint restored onto a 1×1 mesh
    (gathered again) and onto no mesh: (on the mesh, unsharded)."""
    import torch.distributed as dist

    out, _ = spawned
    cfg = W.config(arch)
    manager = CheckpointManager(os.path.join(out, f"ckpt_{arch}"))
    assert manager.latest_step() == W.STEPS
    make = lambda: init_state(build_model(cfg, device="cpu"), adamw(1e-3),
                              torch.Generator().manual_seed(0),
                              masks=W.masks_for(cfg), grad_compression=True)
    plain = manager.restore(make())["params"]
    try:
        mesh = _one_rank_group(tmp_path_factory.mktemp("restore"))
        with sh.axis_rules(sh.default_rules(mesh)):
            like = make()
        on_mesh = manager.restore(like, shardings=sh.shardings_of(like))
        on_mesh = tree_map(sh.gather_full, on_mesh["params"])
    finally:
        dist.destroy_process_group()
    return on_mesh, plain


class _Mesh:
    """A stand-in 2×2 ("data", "model") mesh for the rules."""
    mesh_dim_names, shape, ndim = ("data", "model"), (2, 2), 2


def test_config_takes_its_path_in_both_packages(arch):
    """The override builds in both packages, to the same leaf shapes, and
    takes its config down the path this file is for."""
    cfg = W.config(arch)
    model = build_model(cfg, device="cpu")
    ref = ref_build_model(JModelConfig(**dataclasses.asdict(cfg)))
    ref_shapes = jax.eval_shape(ref.init, jax.random.PRNGKey(0))
    port = tree_to_jax(model.init(torch.Generator().manual_seed(0)))
    got = {p: tuple(t.shape) for p, t in tree_items(port)}
    want = {"/".join(str(getattr(k, "key", k)) for k in path): tuple(x.shape)
            for path, x in jax.tree_util.tree_leaves_with_path(ref_shapes)}
    assert got == want
    rules = sh.default_rules(_Mesh())
    if cfg.num_experts:
        g = torch.Generator().manual_seed(0)
        router = torch.randn((cfg.d_model, cfg.num_experts), generator=g)
        xt = torch.randn((8, W.SEQ, cfg.d_model), generator=g)
        _, dispatch, _, sel = route_local(router / cfg.d_model ** 0.5, xt,
                                          cfg.moe_top_k, cfg.capacity_factor)
        kept, chosen = int(dispatch.sum()), int(sel.sum())
        if arch == "qwen2-moe-a2.7b":
            assert kept < chosen        # assignments past capacity dropped
        else:
            assert kept == chosen and cfg.num_shared_experts
    elif cfg.family == "hybrid":
        # k/v repeated to 5 heads and padded to 6 on the 2-way model axis
        with sh.axis_rules(rules):
            q, k, _, H = model._expand_heads_for_tp(
                torch.zeros(1, 2, cfg.num_heads, cfg.head_dim),
                torch.zeros(1, 2, cfg.num_kv_heads, cfg.head_dim),
                torch.zeros(1, 2, cfg.num_kv_heads, cfg.head_dim))
        assert (H, q.shape[2], k.shape[2]) == (5, 6, 6)
        assert cfg.sliding_window < W.SEQ
    else:
        # the mLSTM's 3 heads do not split on the 2-way model axis
        assert rules.spec(("batch", None, "heads", None),
                          (W.BATCH, W.SEQ, cfg.num_heads, cfg.head_dim)
                          ) == ("data", None, None, None)


def test_one_rank_mesh_is_bit_equal_to_no_mesh(one_rank, single):
    """Every axis of extent 1 places ``Replicate()``, so each op runs on
    the whole tensor, and the gradients' sums meet in the same order:
    metrics and params equal bit for bit."""
    assert [r.metrics for r in one_rank["metrics"]] == [
        r.metrics for r in single["metrics"]]
    a = dict(tree_items(one_rank["state"]["params"]))
    b = dict(tree_items(single["state"]["params"]))
    assert set(a) == set(b)
    for path in b:
        assert torch.equal(a[path], b[path]), path


def test_one_rank_serving_is_bit_equal_to_no_mesh(one_rank, single):
    (la, ta), (lb, tb) = one_rank["serve"], single["serve"]
    assert torch.equal(la, lb) and torch.equal(ta, tb)


def test_2x2_run_matches_one_process(sharded, single):
    metrics, params, _ = sharded
    want = single["metrics"]
    assert len(metrics) == len(want) == W.STEPS
    W.close(metrics, [r.metrics for r in want])
    W.params_close(params, dict(tree_items(single["state"]["params"])))


def test_2x2_run_matches_the_reference(sharded, reference):
    metrics, params, _ = sharded
    want, want_params = reference
    assert len(want) == len(metrics) == W.STEPS
    W.close(metrics, want)
    got = tree_to_jax(params)
    assert {p for p, _ in tree_items(got)} == set(want_params)
    W.params_close(got, want_params)


def test_pruned_weights_stay_exactly_zero(sharded, arch):
    params = dict(tree_items(sharded[1]))
    n = 0
    for path, m in tree_items(W.masks_for(W.config(arch))):
        if m is None:
            continue
        assert torch.all(params[path][m == 0] == 0), path
        n += 1
    assert n > 0


def test_2x2_serving_matches_one_process(sharded, single):
    """A sharded prefill of ``BATCH`` × ``SEQ`` prompts and greedy decode
    steps: fp32 logits within 2e-5 of one process's, the same tokens."""
    logits, tokens = sharded[2]
    want_logits, want_tokens = single["serve"]
    assert logits.shape == want_logits.shape
    assert (logits - want_logits).abs().max() <= W.RTOL
    assert torch.equal(tokens, want_tokens)


def test_2x2_checkpoint_restores_bit_equal_on_one_rank_and_unsharded(
        restored, sharded):
    final = dict(tree_items(sharded[1]))
    on_mesh, plain = (dict(tree_items(t)) for t in restored)
    assert set(on_mesh) == set(plain) == set(final)
    for path, w in final.items():
        assert torch.equal(on_mesh[path], w), path
        assert torch.equal(plain[path], w), path
