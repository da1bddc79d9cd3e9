"""The port's runtime (``repro_torch.runtime``) against the JAX reference
(``repro.runtime``).

The registry, its exporters, the straggler monitor and ``StagedRun`` are
the reference's pure-Python code copied, so the same operations must give
the same results in both packages: snapshots equal (the exporters'
wall-clock stamp aside), ledgers equal. ``FaultTolerantLoop`` runs over the
port's ``CheckpointManager`` with torch tensors. The ADMM loop's
``prune.*`` series are checked against its own history rows and against
the reference's loop on the same scripted iterations. Every comparison
here is exact.
"""

import dataclasses
import json

import jax
import pytest
import torch

from repro.core import prune_state as jps
from repro.core.pruner import rho_schedule as j_rho_schedule
from repro.core.schemes import PruneConfig as JPruneConfig
from repro.runtime import fault_tolerance as jft
from repro.runtime import straggler as jstraggler
from repro.runtime import telemetry as jtel
from repro.runtime import telemetry_export as jexport
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import reduced_config
from repro_torch.core import LMAdapter, PrivacyPreservingPruner, PruneConfig
from repro_torch.core import as_key, rho_schedule
from repro_torch.core import prune_state as tps
from repro_torch.models import LM
from repro_torch.runtime import (
    FaultTolerantLoop,
    MetricsRegistry,
    StagedRun,
    StageError,
    StragglerMonitor,
    registry_scope,
    telemetry_export,
)
from repro_torch.runtime import fault_tolerance as tft
from repro_torch.runtime import telemetry as ttel

PACKAGES = {"port": (tft, ttel, telemetry_export, StragglerMonitor),
            "reference": (jft, jtel, jexport, jstraggler.StragglerMonitor)}


# ----------------------------------------------------------- StagedRun


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_transient_fault_retries_stage_only(pkg, tmp_path):
    ft = PACKAGES[pkg][0]
    calls = {"a": 0, "b": 0}

    def stage_a(c):
        calls["a"] += 1
        return c + ["a"]

    def stage_b(c):
        calls["b"] += 1
        if calls["b"] == 1:
            raise RuntimeError("transient")
        return c + ["b"]

    prog = str(tmp_path / "progress.json")
    runner = ft.StagedRun("unit", max_retries=1, progress_path=prog)
    assert runner.run([], [("a", stage_a), ("b", stage_b)]) == ["a", "b"]
    assert calls == {"a": 1, "b": 2}              # a never re-ran
    recs = {r.name: r for r in runner.records}
    assert recs["a"].attempts == 1 and recs["b"].attempts == 2
    assert ft.StagedRun.completed_stages(prog) == ["a", "b"]


def test_exhausted_retries_raise_stage_error(tmp_path):
    def boom(c):
        raise ValueError("persistent")

    prog = str(tmp_path / "progress.json")
    runner = StagedRun("unit", max_retries=1, progress_path=prog)
    with registry_scope() as reg:
        with pytest.raises(StageError) as ei:
            runner.run(None, [("boom", boom)])
    assert ei.value.stage == "boom" and ei.value.attempts == 2
    assert isinstance(ei.value.cause, ValueError)
    # the failure is on the ledger for the post-mortem
    assert StagedRun.completed_stages(prog) == []
    assert runner.records[-1].status == "failed"
    assert "persistent" in runner.records[-1].error
    assert reg.value("pipeline.stage_retries_total", pipeline="unit",
                     stage="boom") == 2
    assert reg.histogram("pipeline.stage_seconds", stage="boom",
                         status="failed").count == 2


def test_skip_resumes_completed_stages_and_rerecords_them(tmp_path):
    prog = str(tmp_path / "progress.json")
    ran = []
    stages = [("a", lambda c: ran.append("a") or c),
              ("b", lambda c: ran.append("b") or c)]
    StagedRun("unit", progress_path=prog).run(None, stages)
    done = StagedRun.completed_stages(prog)
    assert done == ["a", "b"] and ran == ["a", "b"]
    ran.clear()
    runner = StagedRun("unit", progress_path=prog)
    runner.run(None, stages, skip=["a"])
    assert ran == ["b"]
    assert [(r.name, r.attempts) for r in runner.records] == [("a", 0),
                                                              ("b", 1)]
    # the rewritten ledger still marks the skipped stage complete
    assert StagedRun.completed_stages(prog) == ["a", "b"]


def test_completed_stages_tolerates_garbage(tmp_path):
    p = str(tmp_path / "nope.json")
    assert StagedRun.completed_stages(p) == []
    with open(p, "w") as f:
        f.write("{not json")
    assert StagedRun.completed_stages(p) == []
    assert StagedRun.invalidate_stage(p, "a") == []


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_invalidate_stage_drops_the_tail(pkg, tmp_path):
    ft = PACKAGES[pkg][0]
    p = str(tmp_path / "progress.json")
    doc = {"name": "t", "stages": [
        dataclasses.asdict(ft.StageRecord(n, "ok", 1, 0.1))
        for n in ("teacher", "prune", "retrain", "pack")]}
    with open(p, "w") as f:
        json.dump(doc, f)
    assert ft.StagedRun.invalidate_stage(p, "prune") == ["teacher"]
    assert [r["name"] for r in json.load(open(p))["stages"]] == ["teacher"]
    assert ft.StagedRun.invalidate_stage(str(tmp_path / "none.json"),
                                         "prune") == []


def test_ledgers_equal_across_packages(tmp_path):
    """The same stages, one failing once, leave the same progress.json in
    both packages (seconds aside)."""
    docs = []
    for pkg in sorted(PACKAGES):
        ft = PACKAGES[pkg][0]
        fails = {"b": 1}

        def b(c):
            if fails["b"]:
                fails["b"] -= 1
                raise RuntimeError("once")
            return c

        p = str(tmp_path / f"{pkg}.json")
        ft.StagedRun("t", max_retries=2, progress_path=p).run(
            0, [("a", lambda c: c), ("b", b)])
        doc = json.load(open(p))
        for r in doc["stages"]:
            r.pop("seconds")
        docs.append(doc)
    assert docs[0] == docs[1]


# ------------------------------------------------------ FaultTolerantLoop


def test_loop_restarts_from_checkpoint_after_failure(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    loop = FaultTolerantLoop(manager=mgr, save_every=5, max_restarts=2)
    fail_at = {12}           # one injected failure
    executed = []

    def step_fn(state, step):
        if step in fail_at:
            fail_at.discard(step)
            raise RuntimeError("injected device failure")
        executed.append(step)
        return {"x": state["x"] + 1}, {"loss": 0.0}

    out = loop.run({"x": torch.tensor(0, dtype=torch.int32)}, step_fn,
                   start_step=0, num_steps=20,
                   restore_fn=lambda t, s: mgr.restore(t, step=s))
    # steps 10 and 11 re-ran after the restore from the step-10 checkpoint
    assert executed.count(10) == 2 and executed.count(11) == 2
    assert int(out["x"]) == 20 and out["x"].dtype == torch.int32
    assert mgr.extra()["step"] == 20


def test_loop_gives_up_after_max_restarts(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    loop = FaultTolerantLoop(manager=mgr, save_every=2, max_restarts=1)

    def step_fn(state, step):
        if step == 5:
            raise RuntimeError("persistent failure")
        return state, {}

    with pytest.raises(RuntimeError, match="persistent"):
        loop.run({"x": torch.zeros(())}, step_fn, num_steps=10,
                 restore_fn=lambda t, s: mgr.restore(t, step=s))


# --------------------------------------------------- registry and export


def _drive(tel, clock):
    """One fixed sequence of registry operations."""
    reg = tel.MetricsRegistry(clock=clock)
    reg.counter("serve.requests_total", engine="x", status="ok").inc(3)
    reg.counter("pipeline.stage_retries_total", stage="prune").inc()
    reg.gauge("prune.loss").set(0.125)
    reg.gauge("prune.rho").set(1e-3)
    h = reg.histogram("serve.ttft_seconds", edges=(0.1, 1.0))
    for v in (0.05, 0.1, 5.0):
        h.observe(v)
    with reg.timer("pipeline.stage_seconds", stage="mia", status="ok"):
        pass
    reg.histogram("never.observed")
    with tel.registry_scope() as inner:
        inner.counter("scoped.only").inc()
    tel.get_registry()          # the scope restored the default
    return reg


def test_registry_snapshots_equal_across_packages():
    ticks = iter(range(100))
    reg_t = _drive(ttel, lambda: float(next(ticks)))
    ticks = iter(range(100))
    reg_j = _drive(jtel, lambda: float(next(ticks)))
    assert reg_t.snapshot() == reg_j.snapshot()
    assert reg_t.value("serve.requests_total", engine="x",
                       status="ok") == 3
    assert reg_t.histogram("serve.ttft_seconds").quantile(0.5) == 0.1
    assert "scoped.only" not in json.dumps(reg_t.snapshot())


def test_exports_equal_across_packages(tmp_path):
    ticks = iter(range(100))
    reg_t = _drive(ttel, lambda: float(next(ticks)))
    ticks = iter(range(100))
    reg_j = _drive(jtel, lambda: float(next(ticks)))
    jt = telemetry_export.to_json(reg_t, arch="tiny")
    jj = jexport.to_json(reg_j, arch="tiny")
    assert jt.pop("written_at") > 0 and jj.pop("written_at") > 0
    assert jt == jj
    # the help line of an unregistered family points at each package's
    # own taxonomy; everything else is the same text
    pt = telemetry_export.to_prometheus(reg_t)
    pj = jexport.to_prometheus(reg_j)
    assert pt == pj.replace("repro/runtime/telemetry.py",
                            "repro_torch/runtime/telemetry.py")
    assert 'serve_ttft_seconds_bucket{le="+Inf"} 3' in pt
    path = str(tmp_path / "m.json")
    telemetry_export.write_json(path, reg_t, arch="tiny")
    snap = json.load(open(path))
    assert snap["arch"] == "tiny"
    assert telemetry_export.to_prometheus(snap["metrics"]) == pt


def test_straggler_monitor_matches_reference():
    steps = ([0.010 + 0.001 * (i % 3) for i in range(20)] + [0.100] * 5
             + [0.011, 0.5, 0.012])
    results = []
    for pkg in sorted(PACKAGES):
        _, tel, _, Monitor = PACKAGES[pkg]
        with tel.registry_scope() as reg:
            mon = Monitor(window=50, threshold=3.0)
            events = [mon.record(i, s) for i, s in enumerate(steps)]
            results.append(([dataclasses.asdict(e) if e else None
                             for e in events], mon.snapshot(),
                            reg.snapshot()))
    assert results[0] == results[1]
    events, snap, _ = results[0]
    assert sum(e is not None for e in events) == 6
    assert snap["samples"] == len(steps) and snap["events"] == 6
    assert snap["median"] == pytest.approx(0.011)


# ------------------------------------------------ the ADMM loop's series


def _scripted_loop(mod, tel, key):
    """``run_admm_loop`` over a scripted iter_fn that diverges twice at
    iteration 3 (a NaN loss, then a residual over the cap), under a fresh
    registry."""
    def iter_fn(params, av, bkey, it, *, lr, rho):
        loss, res = 10.0 / (it + 1), 0.5 + 0.01 * it
        if it == 3 and lr == 1e-2:
            loss = float("nan")
        if it == 3 and lr == 5e-3:
            res = 20.0
        return params + 1, av, {"loss": loss, "residual": res,
                                "dual_residual": 0.02 * (it + 1) * rho}

    cfg = (PruneConfig if mod is tps else JPruneConfig)(
        rho_init=1e-3, rho_every_iters=2, rho_max=0.1)
    sched = rho_schedule if mod is tps else j_rho_schedule
    with tel.registry_scope() as reg:
        out = mod.run_admm_loop(
            mod.PruneRunState(params=0, av=[], key=key), iter_fn,
            iterations=6, lr=1e-2, rho_fn=lambda it: sched(cfg, it),
            rho_bounds=(1e-3, 0.1),
            policy=mod.HealthPolicy(max_recoveries=3))
    return out.history, reg.snapshot()


def test_admm_loop_series_match_reference():
    history, snap = _scripted_loop(tps, ttel, as_key(0))
    assert (history, snap) == _scripted_loop(jps, jtel,
                                             jax.random.PRNGKey(0))
    # each rollback went back to iteration 0: 3 + 3 + 6 committed
    counters = {c["name"]: c["value"] for c in snap["counters"]}
    assert counters == {"prune.iterations_total": 12.0,
                        "prune.recoveries_total": 2.0}
    gauges = {g["name"]: g["value"] for g in snap["gauges"]}
    assert gauges == {f"prune.{k}": history[k][-1]
                      for k in ("loss", "residual", "dual_residual", "rho")}


def test_pruner_gauges_equal_last_history_row():
    model = LM(reduced_config("qwen2-1.5b"), device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    pruner = PrivacyPreservingPruner(
        LMAdapter(model, seq_len=8),
        PruneConfig(scheme="tile_pattern",
                    overrides={".*": {"tile_block_p": 32}}, iterations=2,
                    batch_size=2, rho_every_iters=1))
    with registry_scope() as reg:
        result = pruner.run_layerwise(as_key(1), params)
    assert reg.value("prune.iterations_total") == 2
    assert reg.value("prune.recoveries_total") == 0
    for k in ("loss", "residual", "dual_residual", "rho"):
        assert reg.value(f"prune.{k}") == result.history[k][-1], k
    assert isinstance(reg, MetricsRegistry)
