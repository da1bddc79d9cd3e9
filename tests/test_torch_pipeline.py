"""The port's privacy-preserving pruning service (``repro_torch.launch
.pipeline``) end to end on the CPU, at the reference's reduced geometry
with budgets cut further (``TINY``, patched into ``ReportConfig``).

Checked: the six stages on the ledger, the per-arch telemetry, the
manifest's privacy block, the saved artifact loading in the reference and
serving there (VGG-16: packed logits within fp32 ``rtol = 1e-4`` of the
port's and the same top-1; the LM: the same greedy tokens), a run killed
at ``retrain`` and resumed ending bit-equal to an uninterrupted one,
``--restart-stage prune``, and ``--arch all`` reporting a failed arch.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as j_reduced_config
from repro.models import build_model
from repro.models.cnn import vgg16 as j_vgg16
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro.sparse.artifact import PrunedArtifact as JPrunedArtifact
from repro_torch.checkpoint import load_pytree
from repro_torch.configs import ARCHS, reduced_config
from repro_torch.launch import pipeline
from repro_torch.models import LM, vgg16
from repro_torch.privacy import report
from repro_torch.runtime import StageError
from repro_torch.serve import Request, ServeEngine
from repro_torch.sparse import PrunedArtifact
from repro_torch.utils.tree import tree_items

TINY = dict(teacher_steps=2, retrain_steps=2, shadows=1, member_batches=1,
            cnn_batch=16, lm_batch=4, seq_len=16, n_boot=20)
HWC = (16, 16, 3)


class _TinyConfig:
    @staticmethod
    def for_mode(quick, **overrides):
        return report.ReportConfig.for_mode(quick, **{**TINY, **overrides})


@pytest.fixture(autouse=True)
def tiny(monkeypatch):
    monkeypatch.setattr(pipeline, "ReportConfig", _TinyConfig)


def _main(arch, out, *extra):
    return pipeline.main(["--arch", arch, "--reduced", "--quick", "--iters",
                          "2", "--device", "cpu", "--out", str(out),
                          "--bench-path", str(out / "bench.json"), *extra])


def _progress(out, arch):
    return json.load(open(out / arch / "progress.json"))["stages"]


def _params(artifact_dir):
    return dict(tree_items(load_pytree(os.path.join(artifact_dir, "params"),
                                       device="cpu")))


@pytest.fixture(scope="module")
def vgg_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("pipe")
    mp = pytest.MonkeyPatch()
    mp.setattr(pipeline, "ReportConfig", _TinyConfig)
    try:
        assert _main("vgg16", out) == 0
    finally:
        mp.undo()
    return out


def test_stages_telemetry_and_privacy_block(vgg_run):
    out = vgg_run
    stages = _progress(out, "vgg16")
    assert [(s["name"], s["status"], s["attempts"]) for s in stages] == [
        (n, "ok", 1) for n in pipeline.STAGES]
    tele = json.load(open(out / "vgg16" / "telemetry.json"))
    assert tele["arch"] == "vgg16"
    hists = {(h["name"], h["labels"]["stage"]) for h in
             tele["metrics"]["histograms"]}
    assert hists == {("pipeline.stage_seconds", n) for n in pipeline.STAGES}
    counters = {c["name"]: c["value"] for c in tele["metrics"]["counters"]}
    # two ADMM iterations on each of the two pruned arms
    assert counters["prune.iterations_total"] == 4
    doc = json.load(open(out / "vgg16" / "artifact" / "artifact.json"))
    priv = doc["meta"]["privacy"]
    assert priv["data"] == "synthetic"
    assert priv["method"] == "privacy_preserving_admm"
    assert priv["retrained_on"] == "client_confidential"
    assert priv["pipeline"] == "repro_torch.launch.pipeline"
    rows = {r["method"]: r for r in json.load(open(out / "bench.json"))}
    syn = rows["admm_synthetic"]
    assert priv["mia"] == {
        "attack_auc": syn["mia_auc"], "attack_acc": syn["mia_acc"],
        "attack_auc_shadow": syn["mia_auc_shadow"],
        "auc_delta_vs_real": round(
            syn["mia_auc"] - rows["admm_real"]["mia_auc"], 4),
        "auc_delta_vs_dense": round(
            syn["mia_auc"] - rows["dense"]["mia_auc"], 4),
        "n_member": 16, "n_nonmember": 16}
    summary = json.load(open(out / "pipeline_summary.json"))
    assert summary[0]["privacy"] == priv and summary[0]["mia_rows"] == 3
    assert summary[0]["packed_leaves"] == 13


def test_vgg_artifact_serves_in_reference(vgg_run):
    art_dir = str(vgg_run / "vgg16" / "artifact")
    jmodel = j_vgg16(10, width_mult=0.125, image_hwc=HWC)
    jart = JPrunedArtifact.load(art_dir)
    assert jart.privacy["retrained_on"] == "client_confidential"
    tmodel = vgg16(10, width_mult=0.125, image_hwc=HWC, device="cpu")
    tart = PrunedArtifact.load(art_dir, device="cpu")
    assert tart.privacy == jart.privacy
    x = np.random.default_rng(4).random((8, *HWC)).astype(np.float32)
    want = np.asarray(jmodel.apply(jart.bind(jmodel, packed=True),
                                   jnp.asarray(x)))
    got = tmodel.apply(tart.bind(tmodel, packed=True),
                       torch.from_numpy(x)).numpy()
    assert tart.bind_report["fallbacks"] == {}
    atol = 1e-4 * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=atol)
    assert (got.argmax(1) == want.argmax(1)).all()


def test_lm_artifact_serves_in_reference_to_the_same_tokens(tmp_path):
    assert _main("qwen2-1.5b", tmp_path) == 0
    art_dir = str(tmp_path / "qwen2-1.5b" / "artifact")
    jart = JPrunedArtifact.load(art_dir)
    assert jart.privacy["data"] == "synthetic"
    assert set(jart.privacy["mia"]) >= {"attack_auc", "auc_delta_vs_real"}
    jmodel = build_model(j_reduced_config("qwen2-1.5b"))
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 512, n).astype(np.int32) for n in (7, 4, 9)]
    want = [r.tokens for r in JServeEngine(
        jmodel, jart, batch_size=2, max_seq_len=32, packed=True).generate(
        [JRequest(uid=i, prompt=jnp.asarray(p), max_new_tokens=5)
         for i, p in enumerate(prompts)])]
    cfg = reduced_config("qwen2-1.5b")
    tart = PrunedArtifact.load(art_dir, cfg=cfg, device="cpu")
    got = [r.tokens for r in ServeEngine(
        LM(cfg, device="cpu"), tart, batch_size=2, max_seq_len=32,
        packed=True, device="cpu").generate(
        [Request(uid=i, prompt=torch.from_numpy(p), max_new_tokens=5)
         for i, p in enumerate(prompts)])]
    assert tart.bind_report["fallbacks"] == {}
    assert got == want


def _failing_retrain(monkeypatch, fails):
    """``make_ops`` whose ``retrain`` raises on its first ``fails`` calls."""
    real = report.make_ops

    def make_ops(*a, **k):
        ops = real(*a, **k)
        inner = ops.retrain

        def retrain(params, masks):
            if fails:
                fails.pop()
                raise RuntimeError("injected fault in retrain")
            return inner(params, masks)

        ops.retrain = retrain
        return ops

    monkeypatch.setattr(report, "make_ops", make_ops)


def test_killed_at_retrain_and_resumed_is_bit_equal(vgg_run, tmp_path,
                                                    monkeypatch):
    _failing_retrain(monkeypatch, [1])
    out = tmp_path / "b"
    with pytest.raises(StageError) as err:
        _main("vgg16", out, "--stage-retries", "0")
    assert err.value.stage == "retrain" and err.value.attempts == 1
    assert [(s["name"], s["status"]) for s in _progress(out, "vgg16")] == [
        ("teacher", "ok"), ("prune", "ok"), ("retrain", "failed")]
    assert _main("vgg16", out, "--resume") == 0
    stages = _progress(out, "vgg16")
    assert [(s["name"], s["attempts"]) for s in stages[:3]] == [
        ("teacher", 0), ("prune", 0), ("retrain", 1)]
    want = _params(vgg_run / "vgg16" / "artifact")
    got = _params(out / "vgg16" / "artifact")
    assert want.keys() == got.keys()
    for path in want:
        assert torch.equal(got[path], want[path]), path


def test_restart_stage_prune_drops_its_checkpoints(tmp_path):
    assert _main("vgg16", tmp_path, "--no-mia") == 0
    marker = tmp_path / "vgg16" / "prune_ckpt" / "stale"
    marker.write_text("from the invalidated attempt")
    assert _main("vgg16", tmp_path, "--no-mia", "--restart-stage",
                 "prune") == 0
    assert not marker.exists()
    assert [(s["name"], s["attempts"]) for s in _progress(
        tmp_path, "vgg16")] == [("teacher", 0)] + [
        (n, 1) for n in pipeline.STAGES[1:]]


def test_arch_all_reports_a_failed_arch(tmp_path, monkeypatch):
    real = report.make_ops

    def make_ops(*a, **k):
        ops = real(*a, **k)

        def train(window, seed):
            raise RuntimeError("injected fault in teacher")

        ops.train = train
        return ops

    monkeypatch.setattr(report, "make_ops", make_ops)
    assert pipeline.main(["--arch", "all", "--reduced", "--quick",
                          "--device", "cpu", "--stage-retries", "1",
                          "--out", str(tmp_path)]) == 1
    summary = json.load(open(tmp_path / "pipeline_summary.json"))
    assert summary == [{"arch": arch, "error": True,
                        "failed_stage": "teacher", "attempts": 2}
                       for arch in sorted(ARCHS)]
    tele = json.load(open(tmp_path / "qwen2-1.5b" / "telemetry.json"))
    assert {c["name"]: c["value"] for c in tele["metrics"]["counters"]} == {
        "pipeline.stage_retries_total": 2}
