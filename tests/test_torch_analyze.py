"""The port's analysis CLI (``repro_torch/launch/analyze.py``) against the
reference's ``repro/launch/analyze.py`` on the CPU: on one trace written
by the port's ``ContinuousEngine`` (and an attribution report written by
the port's ``roofline.attribution``), both CLIs print the same text and
write the same ``--out`` document, paths aside; a missing or empty trace
exits 2 in both, and the analysis counts every request served. (A
"no report" line's remedy names each package's own tool.)"""

import io
import json
from contextlib import redirect_stdout

import pytest
import torch

from repro.launch import analyze as j_analyze
from repro_torch.configs.base import ModelConfig
from repro_torch.core import DEFAULT_EXCLUDE, PruneConfig, greedy_prune
from repro_torch.launch import analyze
from repro_torch.models import LM
from repro_torch.roofline import attribution as attr
from repro_torch.runtime.telemetry import MetricsRegistry, Telemetry
from repro_torch.serve import ContinuousEngine, Request

CFG = ModelConfig(name="tiny", family="dense", num_layers=2, d_model=128,
                  num_heads=4, num_kv_heads=2, head_dim=32, d_ff=256,
                  vocab_size=512, param_dtype="float32")
N_REQUESTS = 6


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """A traced continuous run of a packed tile artifact, and the
    attribution report of the same artifact."""
    d = tmp_path_factory.mktemp("run")
    model = LM(CFG, device="cpu")
    pcfg = PruneConfig(scheme="tile_pattern", exclude=tuple(DEFAULT_EXCLUDE),
                       overrides={".*": {"tile_block_p": 64}})
    art = greedy_prune(model.init(torch.Generator().manual_seed(0)), pcfg,
                       device="cpu").pack(device="cpu")
    trace = str(d / "trace.jsonl")
    tel = Telemetry(metrics=MetricsRegistry(), trace_path=trace)
    eng = ContinuousEngine(model, art, packed=True, batch_size=2,
                           max_seq_len=64, chunk_steps=3, telemetry=tel,
                           device="cpu")
    reqs = [Request(uid=i, prompt=(torch.arange(4 + 3 * i) + i) % 512,
                    max_new_tokens=4 + i % 3) for i in range(N_REQUESTS)]
    eng.generate(reqs, arrivals=[0.002 * i for i in range(N_REQUESTS)])
    tel.close()
    rows = attr.profile_packed_tree(art.packed, ms=(8,), samples=2,
                                    warmup=1, device="cpu")
    report = str(d / "attribution.json")
    attr.write_report(report, attr.attribute(rows, art.packed), arch="tiny")
    return d, trace, report


def _run(main, argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def _text(text, out):
    """The printed report, paths aside; a "no report" line's remedy names
    each package's own tool."""
    return "\n".join(line.split(" (")[0] if line.startswith("analyze: no")
                     else line for line in text.replace(out, "OUT")
                     .splitlines())


@pytest.mark.parametrize("with_attribution", [True, False])
def test_same_document_and_text_as_reference(artifacts, with_attribution):
    d, trace, report = artifacts
    extra = ["--attribution", report] if with_attribution else [
        "--attribution", str(d / "missing.json")]
    outs = {}
    for name, main in (("port", analyze.main), ("ref", j_analyze.main)):
        out = str(d / f"{name}-{with_attribution}.json")
        rc, text = _run(main, ["--trace", trace, "--out", out, "--width",
                               "60", "--top", "4"] + extra)
        assert rc == 0, text
        with open(out) as f:
            doc = json.load(f)
        outs[name] = (doc, _text(text, out))
    (doc, text), (jdoc, jtext) = outs["port"], outs["ref"]
    assert doc == jdoc and text == jtext
    assert doc["trace_path"] == trace
    assert doc["summary"]["requests"] == N_REQUESTS
    assert doc["summary"]["status_counts"] == {"ok": N_REQUESTS}
    assert ("attribution" in doc) == with_attribution
    if with_attribution:
        assert doc["attribution"]["arch"] == "tiny"
        assert doc["attribution"]["rows"] and "roofline" in text


def test_missing_or_empty_trace_exits_2(tmp_path):
    empty = tmp_path / "empty.jsonl"
    empty.write_text("")
    for path in (str(tmp_path / "nope.jsonl"), str(empty)):
        for main in (analyze.main, j_analyze.main):
            rc, text = _run(main, ["--trace", path, "--out",
                                   str(tmp_path / "o.json")])
            assert rc == 2 and "analyze:" in text
    assert not (tmp_path / "o.json").exists()


def test_default_paths_live_under_bench_torch():
    assert analyze.DEFAULT_TRACE.endswith(
        "experiments/bench_torch/trace_telemetry.jsonl")
    assert analyze.DEFAULT_ATTRIBUTION.endswith(
        "experiments/bench_torch/attribution.json")
