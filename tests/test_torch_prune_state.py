"""The port's resumable ADMM run state (``core/prune_state.py``) and
``CheckpointManager``, against the JAX reference and against itself.

Against the reference, on the same inputs and exactly: ``rho_schedule``,
``adaptive_rho``, the health checks' decisions, ``_recover``'s rollback
and the loop's history under a scripted divergence. Within the port, on
the CPU at the reduced qwen2-1.5b (2 layers, fp32): a run killed by its
callback and resumed is bit-identical to an uninterrupted one (layer-wise
and whole-model); a stale fingerprint starts fresh; a corrupt newest step
falls back to the older one. Across packages: ``CheckpointManager`` step
directories written by either are read by the other with the same
rotation, and an ADMM artifact saved by the port loads in the reference
with equal masks, packed buffers and ``privacy`` block.
"""

import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.core import PruneConfig as JPruneConfig
from repro.core import prune_state as jps
from repro.core.pruner import rho_schedule as j_rho_schedule
from repro.sparse import PrunedArtifact as JPrunedArtifact
from repro.sparse.packed import is_packed as j_is_packed
from repro.utils.tree import tree_paths
from repro_torch.checkpoint import (
    ArtifactError,
    CheckpointManager,
    load_pytree,
)
from repro_torch.configs import reduced_config
from repro_torch.convert import tree_to_jax
from repro_torch.core import (
    LMAdapter,
    PrivacyPreservingPruner,
    PruneConfig,
    as_key,
    rho_schedule,
)
from repro_torch.core import prune_state as tps
from repro_torch.models import LM
from repro_torch.sparse import is_packed
from repro_torch.utils.tree import tree_items


# ------------------------------------------------ schedules and decisions


@pytest.mark.parametrize("kw", [
    {}, dict(rho_init=1e-3, rho_every_iters=1, rho_max=1e-1),
    dict(rho_init=2e-4, rho_mult=3.0, rho_every_iters=7, rho_max=0.5),
    dict(rho_mult=1.0, rho_every_iters=0),
], ids=["paper", "fast", "odd", "flat"])
def test_rho_schedule_matches_reference(kw):
    jc, tc = JPruneConfig(**kw), PruneConfig(**kw)
    for it in list(range(0, 400, 3)) + [10 ** 6, 10 ** 12]:
        assert rho_schedule(tc, it) == j_rho_schedule(jc, it), it


def test_adaptive_rho_matches_reference():
    vals = (0.0, 1e-4, 0.3, 1.0, 7.5, 1e3)
    for rho in (1e-4, 0.01, 0.5):
        for primal in vals:
            for dual in vals:
                for mu, tau in ((10.0, 2.0), (2.0, 1.5), (1.0, 1.0)):
                    for bounds in ((0.0, math.inf), (1e-3, 0.1)):
                        kw = dict(mu=mu, tau=tau, rho_min=bounds[0],
                                  rho_max=bounds[1])
                        assert tps.adaptive_rho(rho, primal, dual, **kw) == \
                            jps.adaptive_rho(rho, primal, dual, **kw)
    for bad in (dict(tau=0.5), dict(mu=0.0)):
        for mod in (tps, jps):
            with pytest.raises(ValueError):
                mod.adaptive_rho(1.0, 1.0, 1.0, **bad)


SEQUENCES = {
    "healthy": [(5.0, 0.5, 0.1), (4.0, 0.4, 0.1), (3.0, 0.3, 0.1),
                (2.5, 0.3, 0.1), (2.0, 0.2, 0.1)],
    "nan_loss": [(5.0, 0.5, 0.1), (float("nan"), 0.5, 0.1)],
    "inf_dual": [(5.0, 0.5, 0.1), (4.0, 0.5, float("inf"))],
    "residual_cap": [(5.0, 0.5, 0.1), (4.0, 11.0, 0.1)],
    "explodes": [(1.0, 0.5, 0.1), (1.2, 0.5, 0.1), (0.9, 0.5, 0.1),
                 (70.0, 0.5, 0.1)],
    "jump_in_warmup": [(1.0, 0.5, 0.1), (500.0, 0.5, 0.1)],
}


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_check_health_decisions_match_reference(name):
    policies = [dict(), dict(warmup_iters=1, explode_factor=5.0)]
    for kw in policies:
        decisions = []
        for mod in (tps, jps):
            history, out = {"loss": []}, []
            for it, (loss, res, dual) in enumerate(SEQUENCES[name]):
                m = {"loss": loss, "residual": res, "dual_residual": dual}
                try:
                    mod.check_health(it, m, history, mod.HealthPolicy(**kw),
                                     recoveries=1)
                    out.append(None)
                except mod.PruneDivergence as e:
                    out.append((e.iteration, e.metric, e.recoveries,
                                str(e)))
                history["loss"].append(loss)
            decisions.append(out)
        assert decisions[0] == decisions[1]


def _anchor(mod, key):
    return mod.PruneRunState(params=0, av=None, key=key, iteration=3,
                             history={k: [1.0] * 3
                                      for k in mod.HISTORY_KEYS})


def test_recover_matches_reference():
    policy_kw = dict(max_recoveries=2, lr_backoff=0.25, rho_tau=3.0)
    got = []
    for mod, key in ((tps, as_key(0)), (jps, jax.random.PRNGKey(0))):
        anchor = _anchor(mod, key)
        state = anchor.snapshot()
        state.iteration, state.lr_scale, state.recoveries = 5, 0.5, 1
        err = mod.PruneDivergence("boom", iteration=5, metric="loss",
                                  value=1e9)
        rolled = mod._recover(state, err, mod.HealthPolicy(**policy_kw),
                              None, anchor, 0.05, (1e-3, 1e-1))
        state.recoveries = 2
        with pytest.raises(mod.PruneDivergence) as exc:
            mod._recover(state, err, mod.HealthPolicy(**policy_kw), None,
                         anchor, 0.05, (1e-3, 1e-1))
        got.append((rolled.iteration, rolled.lr_scale, rolled.rho_override,
                    rolled.recoveries, rolled.history, exc.value.recoveries,
                    exc.value.iteration))
        assert anchor.history["loss"] == [1.0] * 3      # left intact
    assert got[0] == got[1]


def _scripted_loop(mod, key):
    """``run_admm_loop`` over a scripted iter_fn: iteration 3 returns a
    NaN loss at the base lr and a residual over the cap at half of it,
    so the loop rolls back twice, then runs on with adaptive rho."""
    calls = []

    def iter_fn(params, av, bkey, it, *, lr, rho):
        calls.append((it, lr, rho))
        loss, res = 10.0 / (it + 1), 0.5 + 0.01 * it
        if it == 3 and lr == 1e-2:
            loss = float("nan")
        if it == 3 and lr == 5e-3:
            res = 20.0
        return params + 1, av, {"loss": loss, "residual": res,
                                "dual_residual": 0.02 * (it + 1) * rho}

    state = mod.PruneRunState(params=0, av=[], key=key)
    cfg = (PruneConfig if mod is tps else JPruneConfig)(
        rho_init=1e-3, rho_every_iters=2, rho_max=0.1)
    sched = rho_schedule if mod is tps else j_rho_schedule
    out = mod.run_admm_loop(state, iter_fn, iterations=6, lr=1e-2,
                            rho_fn=lambda it: sched(cfg, it),
                            rho_bounds=(1e-3, 0.1),
                            policy=mod.HealthPolicy(max_recoveries=3))
    return calls, out.history, out.recoveries, out.lr_scale, out.params


def test_admm_loop_recovery_matches_reference():
    got = _scripted_loop(tps, as_key(0))
    assert got == _scripted_loop(jps, jax.random.PRNGKey(0))
    assert got[2] == 2 and got[3] == 0.25


def test_split_key_is_pure_and_distinct():
    k = as_key(1)
    a, b = tps.split_key(k)
    assert torch.equal(a, tps.split_key(k)[0]) and int(a) != int(b)
    g1, g2 = tps.key_generator(b, "cpu"), tps.key_generator(b, "cpu")
    assert torch.equal(torch.rand(4, generator=g1), torch.rand(4,
                                                               generator=g2))


# -------------------------------------------------- kill and resume (port)


class Killed(Exception):
    pass


def _kill_after(n):
    def callback(it, metrics):
        if it == n:
            raise Killed(it)
    return callback


@pytest.fixture(scope="module")
def teacher():
    cfg = reduced_config("qwen2-1.5b")
    model = LM(cfg, device="cpu")
    return model, model.init(torch.Generator().manual_seed(0))


def _pruner(model, **kw):
    base = dict(scheme="tile_pattern", overrides={".*": {"tile_block_p": 32}},
                iterations=3, batch_size=2, rho_init=1e-3, rho_every_iters=1)
    base.update(kw)
    return PrivacyPreservingPruner(LMAdapter(model, seq_len=8),
                                   PruneConfig(**base))


def _assert_results_equal(a, b):
    assert a.history == b.history
    for tree in ("params", "masks"):
        pa, pb = dict(tree_items(getattr(a, tree))), dict(
            tree_items(getattr(b, tree)))
        assert pa.keys() == pb.keys()
        for p in pa:
            assert (pa[p] is None) == (pb[p] is None), p
            if pa[p] is not None:
                assert pa[p].dtype == pb[p].dtype and torch.equal(
                    pa[p], pb[p]), p


def _assert_dirs_equal(a, b):
    ta, tb = load_pytree(a, device="cpu"), load_pytree(b, device="cpu")
    fa, fb = dict(tree_items(ta)), dict(tree_items(tb))
    assert fa.keys() == fb.keys()
    for p in fa:
        assert torch.equal(fa[p], fb[p]), p
    ea = json.load(open(os.path.join(a, "manifest.json")))["extra"]
    eb = json.load(open(os.path.join(b, "manifest.json")))["extra"]
    assert ea == eb


@pytest.mark.parametrize("formulation", ["run_layerwise", "run_whole_model"])
def test_killed_and_resumed_run_is_bit_identical(teacher, formulation,
                                                 tmp_path):
    model, params = teacher
    whole = getattr(_pruner(model), formulation)(
        as_key(7), params, checkpoint_dir=str(tmp_path / "a"), save_every=1)
    with pytest.raises(Killed):
        getattr(_pruner(model), formulation)(
            as_key(7), params, checkpoint_dir=str(tmp_path / "b"),
            save_every=1, callback=_kill_after(1))
    ckpt = tps.PruneCheckpointer(str(tmp_path / "b"))
    assert ckpt.steps() == [1, 2]
    resumed = getattr(_pruner(model), formulation)(
        as_key(7), params, checkpoint_dir=str(tmp_path / "b"), save_every=1,
        resume=True)
    _assert_results_equal(resumed, whole)
    _assert_dirs_equal(str(tmp_path / "a" / "step_000000003"),
                       str(tmp_path / "b" / "step_000000003"))
    events = [json.loads(line).get("event") for line in
              open(tmp_path / "b" / tps.TRACE_FILE)]
    assert events.count("resume") == 1 and events[-1] == "done"


def test_stale_fingerprint_starts_fresh(teacher, tmp_path):
    model, params = teacher
    d = str(tmp_path / "run")
    _pruner(model, iterations=2).run(as_key(7), params, checkpoint_dir=d,
                                     save_every=1)
    other = _pruner(model, iterations=2, lr=5e-3)
    got = other.run(as_key(7), params, checkpoint_dir=d, save_every=1,
                    resume=True)
    _assert_results_equal(got, other.run(as_key(7), params))
    events = [json.loads(line).get("event") for line in
              open(os.path.join(d, tps.TRACE_FILE))]
    assert "stale_checkpoint" in events


def _flip_a_buffer(step_dir):
    name = sorted(f for f in os.listdir(step_dir) if f.endswith(".npy"))[0]
    path = os.path.join(step_dir, name)
    data = bytearray(open(path, "rb").read())
    data[-1] ^= 0xFF
    open(path, "wb").write(bytes(data))


def test_corrupt_newest_step_falls_back_to_older(teacher, tmp_path):
    model, params = teacher
    pr = _pruner(model)
    d = str(tmp_path / "run")
    whole = pr.run(as_key(7), params, checkpoint_dir=d, save_every=1)
    ckpt = tps.PruneCheckpointer(d, fingerprint=tps.run_fingerprint(
        params, pr.config, 3, "layerwise"))
    assert ckpt.steps() == [1, 2, 3]
    _flip_a_buffer(os.path.join(d, "step_000000003"))
    template = tps.PruneRunState(params=params, av=None, key=as_key(7))
    template.av = [tps.admm.admm_init(b) for b in params["blocks"]]
    state = ckpt.load_latest(template)
    assert state.iteration == 2 and len(state.history["loss"]) == 2
    # resuming from the older step ends where the uninterrupted run did
    _assert_results_equal(pr.run(as_key(7), params, checkpoint_dir=d,
                                 save_every=1, resume=True), whole)
    for step in ckpt.steps():
        _flip_a_buffer(os.path.join(d, f"step_{step:09d}"))
    with pytest.raises(ArtifactError):
        ckpt.load_latest(template)


# ------------------------------------------------- across the two packages


def _step_tree(step):
    base = np.arange(12, dtype=np.float32).reshape(3, 4) * step
    return {"w": base, "n": {"b": np.full((5,), step, np.int32)}}


def test_checkpoint_manager_steps_cross_packages(tmp_path):
    root = str(tmp_path / "mgr")
    tm = CheckpointManager(root, keep=3)
    assert tm.latest_step() is None
    with pytest.raises(FileNotFoundError):
        tm.restore(_step_tree(0))
    for step in range(1, 6):
        tree = _step_tree(step)
        tm.save(step, {"w": torch.from_numpy(tree["w"]),
                       "n": {"b": torch.from_numpy(tree["n"]["b"])}},
                extra={"step": step})
    jm = JCheckpointManager(root, keep=3)
    assert jm.steps() == tm.steps() == [3, 4, 5]
    got = jm.restore(jax.tree.map(jnp.asarray, _step_tree(0)), step=4)
    np.testing.assert_array_equal(np.asarray(got["w"]), _step_tree(4)["w"])
    assert jm.extra() == tm.extra() == {"step": 5}
    for step in (6, 7):
        jm.save(step, jax.tree.map(jnp.asarray, _step_tree(step)),
                extra={"step": step})
    assert tm.steps() == jm.steps() == [5, 6, 7]
    like = {"w": torch.zeros(3, 4),
            "n": {"b": torch.zeros(5, dtype=torch.int32)}}
    back = tm.restore(like)
    assert torch.equal(back["w"], torch.from_numpy(_step_tree(7)["w"]))
    assert torch.equal(back["n"]["b"], torch.from_numpy(
        _step_tree(7)["n"]["b"]))
    # the same saves under the same keep leave the same steps
    dirs = {}
    for name, cls, conv in (("port", CheckpointManager, torch.from_numpy),
                            ("ref", JCheckpointManager, jnp.asarray)):
        m = cls(str(tmp_path / name), keep=2)
        for step in (3, 1, 4, 10, 9):
            m.save(step, {"w": conv(_step_tree(step)["w"])})
        dirs[name] = (m.steps(), sorted(os.listdir(tmp_path / name)))
    assert dirs["port"] == dirs["ref"]


def test_admm_artifact_loads_in_reference(teacher, tmp_path):
    model, params = teacher
    art = _pruner(model, iterations=1).run(as_key(7), params).to_artifact(
        arch="qwen2-1.5b").pack(device="cpu")
    art.save(str(tmp_path / "art"))
    jart = JPrunedArtifact.load(str(tmp_path / "art"))
    assert jart.privacy == art.privacy == {
        "data": "synthetic", "generator": "uniform_tokens",
        "method": "privacy_preserving_admm", "formulation": "layerwise"}
    assert jart.meta["history"] == art.meta["history"]
    for port_tree, ref_tree in ((art.masks, jart.masks),
                                (art.packed, jart.packed)):
        ref = dict(zip(tree_paths(ref_tree, is_leaf=j_is_packed),
                       jax.tree.leaves(ref_tree, is_leaf=j_is_packed)))
        port = {p: x for p, x in tree_items(tree_to_jax(port_tree))
                if x is not None}
        packed = [p for p in port if is_packed(port[p])]
        assert port.keys() == ref.keys() and (ref_tree is jart.masks
                                              or packed)
        for p, x in port.items():
            bufs = x.buffers if is_packed(x) else (x,)
            rbufs = ref[p].buffers if j_is_packed(ref[p]) else (ref[p],)
            for a, b in zip(bufs, rbufs):
                np.testing.assert_array_equal(
                    a.to(torch.float32).numpy(),
                    np.asarray(b, dtype=np.float32), err_msg=p)


@pytest.mark.parametrize("scheme", ["tile_pattern", "column"])
def test_prune_then_serve_launchers_on_cpu(scheme, tmp_path):
    """``launch.prune`` (ADMM, 2 iterations) writes a packed artifact that
    ``launch.serve --packed`` serves (on the CPU the packed GEMMs run
    their plain versions: ``pattern_gemm_ref`` / ``column_gemm_ref``) to
    the same greedy tokens as the dense-pruned weights (fp32)."""
    from repro_torch.launch import prune, serve

    art = str(tmp_path / "artifact")
    result = prune.main(["--arch", "qwen2-1.5b", "--reduced", "--scheme",
                         scheme, "--rate", "2", "--iters", "2", "--batch",
                         "2", "--seq", "8", "--tile-block", "32", "--out",
                         str(tmp_path / "out"), "--artifact-out", art,
                         "--device", "cpu"])
    assert len(result.history["loss"]) == 2
    assert json.load(open(os.path.join(art, "artifact.json")))["meta"][
        "privacy"]["data"] == "synthetic"
    argv = ["--arch", "qwen2-1.5b", "--reduced", "--artifact", art,
            "--requests", "3", "--max-new", "5", "--device", "cpu"]
    packed = serve.main(argv + ["--packed"])
    dense = serve.main(argv)
    assert [r.tokens for r in packed] == [r.tokens for r in dense]
    assert all(len(r.tokens) == 5 for r in packed)
