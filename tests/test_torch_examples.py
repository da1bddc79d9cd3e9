"""The port's user examples (``examples/torch_*.py``) on the CPU, their step
counts lowered (the quickstart's module constants, the others' flags),
each keeping its invariant: the quickstart's packed model predicts as the
retrained one does; the LM example serves packed tokens identical to
dense for tile-pattern and column; the CNN example prints one row per
pruning path at the asked rate. Without ``--device cpu`` each wants the
card."""

import importlib.util
import io
import re
import sys
from contextlib import redirect_stdout
from pathlib import Path

import pytest
import torch

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


@pytest.fixture(autouse=True)
def one_thread():
    """The examples' small convs and GEMMs on one intra-op thread: the
    suite runs several workers at once, and a thread pool per worker
    oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(mod, monkeypatch, *argv):
    monkeypatch.setattr(sys, "argv", [mod.__file__, *argv])
    buf = io.StringIO()
    with redirect_stdout(buf):
        mod.main()
    return buf.getvalue()


def test_quickstart_packed_predicts_as_retrained(monkeypatch):
    mod = _load("torch_quickstart")
    assert (mod.TEACHER_STEPS, mod.PRUNE_ITERS, mod.RETRAIN_STEPS) == (
        300, 60, 400)
    monkeypatch.setattr(mod, "TEACHER_STEPS", 8)
    monkeypatch.setattr(mod, "PRUNE_ITERS", 2)
    monkeypatch.setattr(mod, "RETRAIN_STEPS", 4)
    out = _run(mod, monkeypatch, "--device", "cpu")
    retrained = re.search(r"retrained pruned model accuracy: (\d\.\d+)", out)
    packed = re.search(r"\[deploy\] packed (\d+)/(\d+) leaves: .* packed "
                       r"accuracy: (\d\.\d+)", out)
    assert retrained and packed, out
    assert packed.group(3) == retrained.group(1)
    assert packed.group(1) == "13"            # VGG-16's 3x3 convs
    assert "pruned at 4.0x compression (scheme=pattern_shared)" in out


@pytest.mark.parametrize("scheme", ["tile_pattern", "column"])
def test_lm_example_packed_tokens_identical(monkeypatch, tmp_path, scheme):
    mod = _load("torch_prune_then_serve_lm")
    out = _run(mod, monkeypatch, "--scheme", scheme, "--train-steps", "4",
               "--prune-iters", "2", "--retrain-steps", "3", "--requests",
               "3", "--artifact-dir", str(tmp_path / "art"), "--device",
               "cpu")
    assert "[serve] packed tokens identical to dense: True" in out, out
    assert re.search(r"\[serve/packed\] 3 requests, 36 tokens", out)
    assert (tmp_path / "art" / "artifact.json").exists()
    assert "pruned 2.00x" in out


def test_cnn_example_rows(monkeypatch):
    mod = _load("torch_privacy_pruning_cnn")
    out = _run(mod, monkeypatch, "--network", "vgg16", "--rate", "4",
               "--iters", "2", "--teacher-steps", "3", "--retrain-steps",
               "2", "--device", "cpu")
    rows = {m.group(1): m for m in re.finditer(
        r"^\s*(\w+) \|\s+([\d.]+)x \|\s+([\d.]+) \|\s+([\d.]+) \|\s+"
        r"([+-][\d.]+) \|\s+([\d.]+)$", out, re.M)}
    assert set(rows) == {"dense_teacher", "privacy_preserving",
                         "admm_traditional", "greedy_uniform"}, out
    for name, m in rows.items():
        assert 0.0 <= float(m.group(6)) <= 1.0
        if name != "dense_teacher":
            assert float(m.group(2)) == pytest.approx(4.0, abs=0.15)


@pytest.mark.parametrize("name", ["torch_quickstart",
                                  "torch_prune_then_serve_lm",
                                  "torch_privacy_pruning_cnn"])
def test_examples_want_the_card(monkeypatch, name):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError):
        _run(_load(name), monkeypatch)
