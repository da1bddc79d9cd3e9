"""Serve-side telemetry of the port: the engines' registry series and
lifecycle trace, the offline recompute from a trace, and the serve
launcher's ``--metrics-out`` / ``--trace-out``.

The port's counterpart of ``tests/test_telemetry.py``'s engine cases:
telemetry observes only at the engines' host syncs (tokens bit-identical
with it on or off), ``stats`` is a view over the registry, every request
ends in exactly one ``retire`` event carrying its ``Result.status``, and
TTFT, TPOT, queue wait and occupancy recomputed from the trace equal the
registry's (held to the port's own registry). The reference's
``trace_analysis`` reads the port's trace to the same report as the
port's copy.
"""

import json
import os

import pytest
import torch

from repro.runtime import trace_analysis as j_trace_analysis
from repro_torch.configs.base import ModelConfig
from repro_torch.models import LM
from repro_torch.runtime import StragglerMonitor, trace_analysis
from repro_torch.runtime.telemetry import (
    MetricsRegistry,
    Telemetry,
    read_trace,
)
from repro_torch.serve import ContinuousEngine, Request, ServeEngine
from repro_torch.testing import ScriptedClock

CFG = ModelConfig(name="tiny", family="dense", num_layers=2, d_model=128,
                  num_heads=4, num_kv_heads=2, head_dim=32, d_ff=256,
                  vocab_size=512, param_dtype="float32")
E = {"engine": "continuous"}


@pytest.fixture(scope="module")
def lm():
    model = LM(CFG, device="cpu")
    return model, model.init(torch.Generator().manual_seed(0))


def _reqs(n=5, max_new=6):
    return [Request(uid=i, prompt=(torch.arange(4 + 2 * i) + i)
                    % CFG.vocab_size, max_new_tokens=max_new + i % 3)
            for i in range(n)]


def _engine(model, params, **kw):
    base = dict(batch_size=2, max_seq_len=64, chunk_steps=3, device="cpu")
    base.update(kw)
    return ContinuousEngine(model, params, **base)


def test_tokens_bit_identical_with_telemetry_on_and_off(lm, tmp_path):
    model, params = lm
    off = _engine(model, params)
    tel = Telemetry(trace_path=str(tmp_path / "t.jsonl"))
    on = _engine(model, params, telemetry=tel)
    toks_off = [r.tokens for r in off.generate(_reqs())]
    toks_on = [r.tokens for r in on.generate(_reqs())]
    tel.close()
    assert toks_on == toks_off
    assert on.stats == off.stats


def test_stats_is_a_per_run_view_of_the_registry(lm):
    model, params = lm
    reg = MetricsRegistry()
    eng = _engine(model, params, telemetry=Telemetry(metrics=reg))
    first = None
    for _ in range(2):
        eng.generate(_reqs())
        if first is None:
            first = dict(eng.stats)
    assert eng.stats["chunks"] == first["chunks"]
    assert reg.value("serve.chunks_total", **E) == 2 * first["chunks"]
    assert reg.value("serve.requests_total", status="ok", **E) \
        == 2 * first["statuses"]["ok"]
    assert reg.value("serve.busy_slot_steps_total", **E) \
        == 2 * first["busy_slot_steps"]
    assert reg.histogram("serve.ttft_seconds", **E).count == 2 * 5


def test_chunked_engine_records(lm, tmp_path):
    model, params = lm
    reqs = _reqs(n=4)
    path = str(tmp_path / "chunked.jsonl")
    tel = Telemetry(trace_path=path)
    mon = StragglerMonitor(window=8)
    eng = ServeEngine(model, params, batch_size=2, max_seq_len=64,
                      telemetry=tel, straggler=mon, device="cpu")
    base = ServeEngine(model, params, batch_size=2, max_seq_len=64,
                       device="cpu")
    assert ([r.tokens for r in eng.generate(reqs)]
            == [r.tokens for r in base.generate(reqs)])
    tel.close()
    C = {"engine": "chunked"}
    assert tel.metrics.value("serve.requests_total", status="ok",
                             **C) == len(reqs)
    assert tel.metrics.value("serve.chunks_total", **C) == 2
    assert tel.metrics.histogram("serve.ttft_seconds", **C).count == 4
    assert mon.samples == 2
    trace = read_trace(path)
    retires = [r for r in trace if r["name"] == "retire"]
    assert sorted(r["uid"] for r in retires) == [0, 1, 2, 3]
    assert all(r["status"] == "ok" for r in retires)
    assert [r["steps"] for r in trace if r["name"] == "decode_chunk"] \
        == [7, 8]


def test_terminal_statuses_have_matching_retire_events(lm, tmp_path):
    """Shed, timeout, cancelled, failed and ok requests each end in
    exactly one ``retire`` event carrying their status."""
    from repro_torch.testing import chunk_action_hook, kv_poison_hook

    model, params = lm
    reqs = [Request(uid=0, prompt=torch.arange(4), max_new_tokens=12),
            Request(uid=1, prompt=torch.arange(4), max_new_tokens=4,
                    deadline=0.0),                     # dead on arrival
            Request(uid=2, prompt=torch.arange(5), max_new_tokens=12),
            Request(uid=3, prompt=torch.arange(4), max_new_tokens=4),
            Request(uid=4, prompt=torch.arange(6), max_new_tokens=4),
            Request(uid=5, prompt=torch.arange(6), max_new_tokens=4)]
    poison, cancel = kv_poison_hook(1, at_chunk=1), chunk_action_hook(
        {2: reqs[0].cancel})

    def hook(cache, sched):
        poison(cache, sched)
        cancel(cache, sched)

    path = str(tmp_path / "mix.jsonl")
    tel = Telemetry(trace_path=path)
    eng = _engine(model, params, chunk_steps=2, max_queue=4, strict=False,
                  fault_hook=hook, telemetry=tel)
    results = eng.generate(reqs, clock=ScriptedClock([], tail_step=0.01))
    tel.close()
    statuses = {r.uid: r.status for r in results}
    assert set(statuses.values()) == {"ok", "shed", "timeout", "cancelled",
                                      "failed"}
    retires = [r for r in read_trace(path) if r["name"] == "retire"]
    assert len(retires) == len(reqs)
    assert {r["uid"]: r["status"] for r in retires} == statuses
    assert {s: n for s, n in eng.stats["statuses"].items() if n} == {
        s: list(statuses.values()).count(s) for s in set(statuses.values())}


def _added(values) -> float:
    """Left-to-right float additions, as ``Histogram.observe`` adds (the
    builtin ``sum`` compensates rounding since Python 3.12, so it can
    differ in the last bit)."""
    total = 0.0
    for v in values:
        total += v
    return total


def test_offline_recompute_matches_registry(lm, tmp_path):
    """TTFT, TPOT, queue wait and occupancy recomputed from the trace alone
    equal the registry's (same engine clock, floats through JSON), by
    hand and through ``trace_analysis``; the reference's analyzer reads
    the port's trace to the same report."""
    model, params = lm
    reqs = _reqs()
    path = str(tmp_path / "run.jsonl")
    reg = MetricsRegistry()
    tel = Telemetry(metrics=reg, trace_path=path)
    eng = _engine(model, params, telemetry=tel)
    eng.generate(reqs, arrivals=[0.0, 0.001, 0.002, 0.01, 0.02])
    tel.close()
    by = {}
    for e in read_trace(path):
        by.setdefault(e["name"], []).append(e)

    firsts = by["first_token"]
    h_ttft = reg.histogram("serve.ttft_seconds", **E)
    assert h_ttft.count == len(firsts) == len(reqs)
    assert _added(e["ts"] - e["arrival"] for e in firsts) == h_ttft.sum
    admits = by["admit"]
    h_q = reg.histogram("serve.queue_wait_seconds", **E)
    assert h_q.count == len(admits)
    assert _added(e["ts"] - e["arrival"] for e in admits) == h_q.sum
    t_first = {e["uid"]: e["ts"] for e in firsts}
    off_tpot = sum((e["ts"] - t_first[e["uid"]]) / (e["tokens"] - 1)
                   for e in by["retire"] if e["tokens"] > 1)
    assert off_tpot == pytest.approx(
        reg.histogram("serve.tpot_seconds", **E).sum, abs=1e-12)
    chunks = by["decode_chunk"]
    assert len(chunks) == eng.stats["chunks"]
    busy = sum(e["busy"] for e in chunks)
    total = sum(e["batch"] * e["steps"] for e in chunks)
    assert busy / total == eng.stats["occupancy"]
    assert sum(e["dur"] for e in chunks) == pytest.approx(
        reg.histogram("serve.chunk_seconds", **E).sum)

    analysis = trace_analysis.analyze(path)
    check = analysis.crosscheck(reg)
    assert check["matches"], check
    assert analysis.occupancy == eng.stats["occupancy"]
    assert [p.status for p in analysis.requests] == ["ok"] * len(reqs)
    assert analysis.to_dict() == j_trace_analysis.analyze(path).to_dict()
    text = trace_analysis.render(analysis)
    assert text == j_trace_analysis.render(j_trace_analysis.analyze(path))
    assert "SLO percentiles" in text and "critical paths" in text


@pytest.mark.parametrize("suffix", [".prom", ".json"])
def test_serve_launcher_writes_metrics_and_trace(tmp_path, suffix):
    """``launch.serve --metrics-out --trace-out`` in process: the snapshot
    holds the chunked engine's series; the trace one retire per request."""
    from repro_torch.launch import serve
    from repro_torch.runtime.telemetry import registry_scope

    metrics = str(tmp_path / f"m{suffix}")
    trace = str(tmp_path / "t.jsonl")
    with registry_scope():
        results = serve.main(["--arch", "qwen2-1.5b", "--reduced",
                              "--requests", "3", "--batch", "2",
                              "--max-new", "4", "--metrics-out", metrics,
                              "--trace-out", trace, "--device", "cpu"])
    assert [len(r.tokens) for r in results] == [4, 4, 4]
    text = open(metrics).read()
    if suffix == ".prom":
        assert 'serve_requests_total{engine="chunked",status="ok"} 3' \
            in text
    else:
        doc = json.loads(text)
        assert doc["arch"] == "qwen2-1.5b" and doc["mode"] == "dense"
        assert "serve.requests_total" in json.dumps(doc["metrics"])
    events = read_trace(trace)
    assert [e["uid"] for e in events if e["name"] == "retire"] == [0, 1, 2]
    assert sum(e["name"] == "decode_chunk" for e in events) == 2
    assert os.path.getsize(trace) > 0
