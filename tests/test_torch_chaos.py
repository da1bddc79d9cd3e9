"""Chaos suite of the port: every injected fault ends typed.

The port's counterpart of ``tests/test_chaos.py`` (serving, artifact and
checkpoint cases) and of the reference's ADMM kill / poison cases. A fault
anywhere (a flipped bit on disk, a NaN in a weight leaf, a corrupt packed
index table, poison in one slot's live KV rows, a request flood, a
deadline, a cancel, a slow chunk, a killed prune) ends in an
``ArtifactError``, a ``Result.status`` in {shed, timeout, cancelled,
failed}, or a recorded degradation with the output unchanged; never a
hang, and never a change to co-batched healthy requests' tokens, which
stay bit-identical to solo serving. Every fault comes from
``repro_torch.testing.chaos`` and is a pure function of its seed. The
on-disk injectors damage the same byte of the same file as the
reference's, since both packages write one format.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.checkpoint import ArtifactError as JArtifactError
from repro.checkpoint import load_pytree as j_load_pytree
from repro.testing import corrupt_buffer as j_corrupt_buffer
from repro.testing import corrupt_manifest as j_corrupt_manifest
from repro_torch.checkpoint import (
    ArtifactError,
    load_pytree,
    save_pytree,
    verify_checkpoint,
)
from repro_torch.configs import reduced_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core import (
    DEFAULT_EXCLUDE,
    LMAdapter,
    PrivacyPreservingPruner,
    PruneConfig,
    as_key,
    greedy_prune,
)
from repro_torch.core.prune_state import (
    TRACE_FILE,
    HealthPolicy,
    PruneDivergence,
)
from repro_torch.models import LM
from repro_torch.runtime import StragglerMonitor
from repro_torch.serve import ContinuousEngine, Request, Scheduler, ServeEngine
from repro_torch.sparse import PrunedArtifact, is_packed
from repro_torch.sparse.packed import validate_packed
from repro_torch.testing import (
    ChaosKill,
    ScriptedClock,
    chunk_action_hook,
    corrupt_admm_checkpoint,
    corrupt_buffer,
    corrupt_manifest,
    corrupt_packed_index,
    kill_at_iteration,
    kv_poison_hook,
    nan_grad_poison,
    nan_poison_leaf,
)
from repro_torch.utils.tree import tree_items, tree_map_with_path

ROOT = Path(__file__).resolve().parents[1]
CFG = ModelConfig(name="tiny", family="dense", num_layers=2, d_model=128,
                  num_heads=4, num_kv_heads=2, head_dim=32, d_ff=256,
                  vocab_size=512, param_dtype="float32")


@pytest.fixture(scope="module")
def lm():
    model = LM(CFG, device="cpu")
    return model, model.init(torch.Generator().manual_seed(0))


@pytest.fixture(scope="module")
def artifact(lm):
    model, params = lm
    pcfg = PruneConfig(scheme="tile_pattern", exclude=DEFAULT_EXCLUDE,
                       overrides={".*": {"tile_block_p": 64,
                                         "tile_group_q": 8,
                                         "tile_keep": 4}})
    return greedy_prune(params, pcfg, device="cpu").pack(device="cpu")


def _engine(lm_or_model, params, **kw):
    base = dict(batch_size=2, max_seq_len=64, chunk_steps=4, device="cpu")
    base.update(kw)
    return ContinuousEngine(lm_or_model, params, **base)


def _reqs(n=2, max_new=8, **kw):
    return [Request(uid=i, prompt=(torch.arange(6) + i) % CFG.vocab_size,
                    max_new_tokens=max_new, **kw) for i in range(n)]


def _solo(model, params, requests, max_seq_len=64):
    eng = ServeEngine(model, params, batch_size=1, max_seq_len=max_seq_len,
                      device="cpu")
    return [eng.generate([Request(uid=r.uid, prompt=r.prompt,
                                  max_new_tokens=r.max_new_tokens)])[0].tokens
            for r in requests]


# ------------------------------------------------------------ on disk


def _save_small(tmp_path, name="ckpt"):
    tree = {"w": torch.arange(64, dtype=torch.float32).reshape(8, 8),
            "b": torch.ones((8,), dtype=torch.float32)}
    d = str(tmp_path / name)
    save_pytree(d, tree)
    return d, tree


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bitflip_raises_artifact_error_as_in_reference(tmp_path, seed):
    """One flipped bit: ``ArtifactError`` naming the file; the reference's
    injector with the same seed damages the same bit of the same file."""
    d, _ = _save_small(tmp_path)
    twin, _ = _save_small(tmp_path, "twin")
    hit = corrupt_buffer(d, seed=seed)
    assert j_corrupt_buffer(twin, seed=seed) == hit
    with pytest.raises(ArtifactError) as ei:
        load_pytree(d, device="cpu")
    assert hit["file"] in str(ei.value) or "crc" in str(ei.value).lower()
    with pytest.raises(ArtifactError):
        verify_checkpoint(d)
    with pytest.raises(JArtifactError):
        j_load_pytree(twin)


def test_clean_checkpoint_verifies(tmp_path):
    d, tree = _save_small(tmp_path)
    assert verify_checkpoint(d)["leaves"] >= 2
    assert torch.equal(load_pytree(d, device="cpu")["w"], tree["w"])


@pytest.mark.parametrize("mode", ["truncate", "drop_field",
                                  "future_version"])
def test_manifest_damage_raises_in_both_packages(tmp_path, mode):
    d, _ = _save_small(tmp_path)
    twin, _ = _save_small(tmp_path, "twin")
    assert corrupt_manifest(d, seed=3, mode=mode)["mode"] == mode
    j_corrupt_manifest(twin, seed=3, mode=mode)
    if mode != "truncate":            # the same damage, bar the save time
        docs = [json.load(open(os.path.join(x, "manifest.json")))
                for x in (d, twin)]
        for doc in docs:
            doc.pop("time")
        assert docs[0] == docs[1]
    with pytest.raises(ArtifactError):
        load_pytree(d, device="cpu")
    with pytest.raises(JArtifactError):
        j_load_pytree(twin)


def test_corrupt_artifact_dir_fails_on_load(tmp_path, artifact):
    d = str(tmp_path / "art")
    artifact.save(d)
    clean = PrunedArtifact.load(d, cfg=CFG, device="cpu")
    rep = clean.verify_integrity()
    assert rep["packed_bad"] == {} and "params" in rep["disk"]
    corrupt_buffer(os.path.join(d, "params"), seed=5)
    with pytest.raises(ArtifactError):
        PrunedArtifact.load(d, cfg=CFG, device="cpu")


def test_verify_integrity_catches_post_load_bitflip(tmp_path, artifact):
    d = str(tmp_path / "art2")
    artifact.save(d)
    loaded = PrunedArtifact.load(d, cfg=CFG, device="cpu")
    corrupt_buffer(os.path.join(d, "packed"), seed=7)
    with pytest.raises(ArtifactError):
        loaded.verify_integrity()


# ------------------------------------------------- NaN in the weights


def test_poisoned_weights_fail_typed_and_drain(lm):
    """A NaN on the residual stream makes every admission's first logits
    non-finite: each admitted request fails, its lane is quarantined, and
    once every lane is gone the queued backlog drains typed."""
    model, params = lm
    bad = nan_poison_leaf(params, seed=11, path_contains="blocks")
    eng = _engine(model, bad)
    out = eng.generate(_reqs(n=4))
    assert [r.status for r in out] == ["failed"] * 4
    assert all(r.tokens == [] for r in out)
    assert sorted(eng.stats["quarantined_slots"]) == [0, 1]
    assert eng.stats["statuses"]["failed"] == 4


def test_poison_touches_one_element(lm):
    _, params = lm
    bad = nan_poison_leaf(params, seed=11, path_contains="blocks")
    items, ref = dict(tree_items(bad)), dict(tree_items(params))
    assert items.keys() == ref.keys()
    assert sum(int(torch.isnan(x).sum()) for x in items.values()) == 1
    changed = [p for p in ref if items[p] is not ref[p]]
    assert len(changed) == 1 and changed[0].startswith("blocks")


# ------------------------------------------- corrupt packed index tables


def _corrupted(artifact, seed=13):
    path = next(p for p, x in tree_items(artifact.packed) if is_packed(x))
    packed = tree_map_with_path(
        lambda p, x: corrupt_packed_index(x, seed=seed) if p == path else x,
        artifact.packed)
    assert validate_packed(dict(tree_items(packed))[path]) is not None
    return dataclasses.replace(artifact, packed=packed), path


def test_bind_serves_a_corrupt_leaf_dense(lm, artifact):
    model, _ = lm
    bad_art, bad_path = _corrupted(artifact)
    reqs = _reqs(n=2, max_new=6)
    ref = _solo(model, bad_art.params, reqs)
    eng = _engine(model, bad_art, packed=True)
    assert bad_path in eng.bind_report["fallbacks"]
    out = eng.generate(reqs)
    assert [r.status for r in out] == ["ok", "ok"]
    assert [r.tokens for r in out] == ref
    assert bad_path in eng.stats["bind_fallbacks"]
    rep = bad_art.verify_integrity()
    assert bad_path in rep["packed_bad"] and rep["packed_ok"] >= 1


# ------------------------------------------------ in-flight KV poison


def test_poisoned_slot_quarantined_mates_bit_identical(lm):
    """NaN written in place into slot 0's live KV rows at its second chunk
    edge: that request fails with a strict prefix of its solo tokens, its
    lane is quarantined, and its mate's tokens equal solo serving."""
    model, params = lm
    reqs = _reqs(n=2, max_new=16)
    ref = _solo(model, params, reqs)
    eng = _engine(model, params, fault_hook=kv_poison_hook(0, at_chunk=1))
    out = eng.generate(reqs)
    assert out[0].status == "failed"
    assert 0 < len(out[0].tokens) < len(ref[0])
    assert out[0].tokens == ref[0][: len(out[0].tokens)]
    assert out[1].status == "ok" and out[1].tokens == ref[1]
    assert eng.stats["quarantined_slots"] == [0]
    # the poison stays in its row of the live cache
    assert bool(torch.isnan(eng.cache["v"][-1][0]).any())
    assert all(bool(torch.isfinite(t[1]).all())
               for t in eng.cache["k"] + eng.cache["v"])


def test_quarantined_lane_never_readmitted_then_cleared_next_run(lm):
    """Later arrivals admit into the surviving lane only; the next run
    starts from a clean cache, so the lane serves again."""
    model, params = lm
    reqs = _reqs(n=3, max_new=8)
    ref = _solo(model, params, reqs)
    eng = _engine(model, params, fault_hook=kv_poison_hook(0, at_chunk=0))
    out = eng.generate(reqs)
    assert out[0].status == "failed"
    assert [r.status for r in out[1:]] == ["ok", "ok"]
    assert [r.tokens for r in out[1:]] == ref[1:]
    assert eng.stats["quarantined_slots"] == [0]
    eng.fault_hook = None
    assert [r.tokens for r in eng.generate(reqs)] == ref


def test_a_hook_that_returns_a_cache_raises(lm):
    """The hook contract is in place only: a hook that returns a cache
    (which the captured graphs would never read) raises instead of being
    ignored."""
    model, params = lm
    reqs = _reqs(n=2, max_new=12)

    def hook(cache, sched):
        return {k: v for k, v in cache.items()}

    eng = _engine(model, params, fault_hook=hook)
    with pytest.raises(TypeError, match="in place"):
        eng.generate(reqs)


# ------------------------------------------------------ load shedding


def test_bounded_queue_sheds_typed(lm):
    model, params = lm
    reqs = _reqs(n=4, max_new=6)
    ref = _solo(model, params, reqs)
    eng = _engine(model, params, batch_size=1, max_queue=2)
    out = eng.generate(reqs)
    assert [r.status for r in out] == ["ok", "ok", "shed", "shed"]
    assert all(r.tokens == [] for r in out[2:])
    assert [r.tokens for r in out[:2]] == ref[:2]
    assert eng.stats["statuses"]["shed"] == 2


def test_oversized_shed_nonstrict_raises_strict(lm):
    model, params = lm
    good = Request(uid=0, prompt=torch.arange(6), max_new_tokens=6)
    huge = Request(uid=1, prompt=torch.arange(6), max_new_tokens=10_000)
    ref = _solo(model, params, [good], max_seq_len=32)
    eng = _engine(model, params, max_seq_len=32, strict=False)
    out = eng.generate([good, huge])
    assert [r.status for r in out] == ["ok", "shed"]
    assert out[0].tokens == ref[0]
    strict = _engine(model, params, max_seq_len=32)
    with pytest.raises(ValueError, match="exceeds cache capacity"):
        strict.generate([good, huge])


# ------------------------------------------------ deadlines and cancels


def test_queued_deadline_expires_before_prefill(lm):
    model, params = lm
    late = Request(uid=0, prompt=torch.arange(6), max_new_tokens=8,
                   deadline=0.5)
    ok = Request(uid=1, prompt=torch.arange(6) + 1, max_new_tokens=8)
    ref = _solo(model, params, [ok])
    eng = _engine(model, params, batch_size=1)
    out = eng.generate([late, ok], clock=ScriptedClock([1.0]))
    assert out[0].status == "timeout" and out[0].tokens == []
    assert out[1].status == "ok" and out[1].tokens == ref[0]


def test_midstream_deadline_keeps_partial_prefix(lm):
    model, params = lm
    req = Request(uid=0, prompt=torch.arange(6), max_new_tokens=32,
                  deadline=0.3)
    ref = _solo(model, params, [req])[0]
    eng = _engine(model, params, batch_size=1)
    out = eng.generate([req], clock=ScriptedClock([], tail_step=0.05))
    assert out[0].status == "timeout"
    assert 0 < len(out[0].tokens) < len(ref)
    assert out[0].tokens == ref[: len(out[0].tokens)]


def test_cancel_midstream_partial_mate_unaffected(lm):
    model, params = lm
    reqs = _reqs(n=2, max_new=24)
    ref = _solo(model, params, reqs)
    eng = _engine(model, params,
                  fault_hook=chunk_action_hook({2: reqs[0].cancel}))
    out = eng.generate(reqs)
    assert out[0].status == "cancelled"
    assert 0 < len(out[0].tokens) < len(ref[0])
    assert out[0].tokens == ref[0][: len(out[0].tokens)]
    assert out[1].status == "ok" and out[1].tokens == ref[1]


def test_cancel_before_admission(lm):
    model, params = lm
    reqs = _reqs(n=2, max_new=6)
    reqs[1].cancel()
    ref = _solo(model, params, [reqs[0]])
    out = _engine(model, params, batch_size=1).generate(reqs)
    assert out[1].status == "cancelled" and out[1].tokens == []
    assert out[0].status == "ok" and out[0].tokens == ref[0]


# ------------------------------------------------------------ stragglers


class _SpikingClock:
    """Advances a fixed step per call; ``spike_after(n, dt)`` adds ``dt``
    on the n-th next call, so the jump lands between one chunk's start and
    end timestamps."""

    def __init__(self, step=0.01):
        self.t, self.step = 0.0, step
        self._pending, self._spike = 0, 0.0

    def spike_after(self, calls, amount):
        self._pending, self._spike = calls, amount

    def __call__(self):
        self.t += self.step
        if self._pending > 0:
            self._pending -= 1
            if self._pending == 0:
                self.t += self._spike
        return self.t


def test_slow_chunk_flagged(lm):
    model, params = lm
    mon = StragglerMonitor(window=50, threshold=3.0)
    clk = _SpikingClock(step=0.01)
    eng = _engine(model, params, batch_size=1, max_seq_len=128,
                  straggler=mon, fault_hook=chunk_action_hook(
                      {12: lambda: clk.spike_after(2, 0.5)}))
    out = eng.generate([Request(uid=0, prompt=torch.arange(6),
                                max_new_tokens=64)], clock=clk)
    assert out[0].status == "ok"
    assert eng.stats["straggler_events"] >= 1
    assert any(e.seconds > 0.4 for e in mon.events)


# --------------------------------------------------- scheduler edges


def test_zero_requests(lm):
    model, params = lm
    eng = _engine(model, params, max_seq_len=32)
    assert eng.generate([]) == []
    assert eng.stats["chunks"] == 0


def test_arrival_after_all_slots_retired(lm):
    model, params = lm
    reqs = _reqs(n=2, max_new=4)
    ref = _solo(model, params, reqs)
    out = _engine(model, params, batch_size=1).generate(
        reqs, arrivals=[0.0, 50.0], clock=ScriptedClock([], tail_step=1.0))
    assert [r.status for r in out] == ["ok", "ok"]
    assert [r.tokens for r in out] == ref


def test_occupancy_accounts_retire_and_admit_same_chunk(lm):
    model, params = lm
    eng = _engine(model, params, batch_size=1)
    out = eng.generate(_reqs(n=3, max_new=5))
    assert all(r.status == "ok" for r in out)
    chunk_tokens = sum(len(r.tokens) - 1 for r in out)
    assert eng.stats["busy_slot_steps"] == chunk_tokens
    assert eng.stats["total_slot_steps"] >= chunk_tokens
    assert 0.0 < eng.stats["occupancy"] <= 1.0


def test_submit_rejects_when_bounded_queue_full():
    sched = Scheduler(batch_size=1, chunk_steps=4, max_queue=1)
    assert sched.submit(0, object()) is True
    assert sched.submit(1, object()) is False
    assert sched.pending == 1


# --------------------------------------------------------- in pruning


@pytest.fixture(scope="module")
def teacher():
    model = LM(reduced_config("qwen2-1.5b"), device="cpu")
    return model, model.init(torch.Generator().manual_seed(0))


def _pruner(model, **kw):
    base = dict(scheme="tile_pattern", overrides={".*": {"tile_block_p": 32}},
                iterations=3, batch_size=2, rho_init=1e-3, rho_every_iters=1)
    base.update(kw)
    return PrivacyPreservingPruner(LMAdapter(model, seq_len=8),
                                   PruneConfig(**base))


def _same_result(a, b):
    assert a.history == b.history
    for tree in ("params", "masks"):
        pa, pb = dict(tree_items(getattr(a, tree))), dict(
            tree_items(getattr(b, tree)))
        assert pa.keys() == pb.keys()
        for p in pa:
            assert (pa[p] is None) == (pb[p] is None), p
            if pa[p] is not None:
                assert torch.equal(pa[p], pb[p]), p


def test_chaos_kill_then_resume_bit_identical(teacher, tmp_path):
    model, params = teacher
    whole = _pruner(model).run(as_key(7), params)
    d = str(tmp_path / "run")
    with pytest.raises(ChaosKill):
        _pruner(model).run(as_key(7), params, checkpoint_dir=d,
                           save_every=1, callback=kill_at_iteration(2))
    _same_result(_pruner(model).run(as_key(7), params, checkpoint_dir=d,
                                    save_every=1, resume=True), whole)


def test_corrupt_admm_checkpoint_falls_back_to_older_step(teacher,
                                                          tmp_path):
    model, params = teacher
    d = str(tmp_path / "run")
    whole = _pruner(model).run(as_key(7), params, checkpoint_dir=d,
                               save_every=1)
    hit = corrupt_admm_checkpoint(d, seed=3)
    assert hit["step"] == 3
    _same_result(_pruner(model).run(as_key(7), params, checkpoint_dir=d,
                                    save_every=1, resume=True), whole)
    events = [l for l in open(os.path.join(d, TRACE_FILE))]
    assert any('"corrupt_checkpoint"' in e for e in events)


def test_nan_grad_poison_recovers_or_fails_typed(teacher, tmp_path):
    """One-shot poison before iteration 2: the health monitor rolls back
    and the run completes finite; with no recoveries allowed it raises
    ``PruneDivergence`` at that iteration."""
    model, params = teacher
    d = str(tmp_path / "run")
    result = _pruner(model).run(as_key(7), params, checkpoint_dir=d,
                                save_every=1,
                                fault_hook=nan_grad_poison(2, seed=0))
    assert len(result.history["loss"]) == 3
    assert all(np.isfinite(v) for vs in result.history.values() for v in vs)
    assert any('"rollback"' in line
               for line in open(os.path.join(d, TRACE_FILE)))
    with pytest.raises(PruneDivergence) as e:
        _pruner(model).run(as_key(7), params, health=HealthPolicy(
            max_recoveries=0), fault_hook=nan_grad_poison(2, seed=0))
    assert e.value.iteration == 2 and e.value.recoveries == 0


def test_prune_launcher_chaos_kill_and_resume(tmp_path):
    """``launch.prune --chaos-kill-at 2`` dies by SIGKILL once iteration 2
    has committed; ``--resume`` finishes the run with the same pruned
    weights and masks as a run never killed."""
    from repro_torch.launch import prune

    argv = ["--arch", "qwen2-1.5b", "--reduced", "--scheme", "tile_pattern",
            "--rate", "2", "--iters", "3", "--batch", "2", "--seq", "8",
            "--tile-block", "32", "--device", "cpu"]
    killed = str(tmp_path / "killed")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.prune", *argv, "--out",
         killed, "--save-every", "1", "--chaos-kill-at", "2"],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == -9, proc.stderr[-2000:]
    assert not os.path.exists(os.path.join(killed, "pruned"))
    resumed = prune.main(argv + ["--out", killed, "--save-every", "1",
                                 "--resume"])
    whole = prune.main(argv + ["--out", str(tmp_path / "whole")])
    _same_result(resumed, whole)
    a = load_pytree(os.path.join(killed, "pruned"), device="cpu")
    b = load_pytree(str(tmp_path / "whole" / "pruned"), device="cpu")
    assert all(torch.equal(x, y) for (_, x), (_, y) in zip(
        tree_items(a), tree_items(b)))
