"""The launch gate of ``chip_smoke.py`` against torch.profiler traces
(``exact_trace``), with a stub trace source.

The profiler drops device records on the card, so a trace that counts
fewer launches than the wrappers did is retaken, a bounded number of
times; the gate passes only on a trace whose counts are exactly equal,
and fails at once on a trace that counts more (no lost record explains
that) or on a kernel never launched.
"""

import importlib.util
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _source(traces):
    """take() handing out ``traces`` in order, counting its calls."""
    calls = []

    def take():
        calls.append(1)
        counted, traced = traces[len(calls) - 1]
        return counted, traced, len(calls)

    return take, calls


COUNTED = {"pattern_gemm": 1576, "flash_attention": 56}


def test_an_exact_trace_passes_untaken_again(smoke, capsys):
    take, calls = _source([(COUNTED, dict(COUNTED))])
    assert smoke.exact_trace("t", "what", take) == 1
    assert len(calls) == 1
    assert "lost" not in capsys.readouterr().out


def test_a_short_trace_is_retaken_until_exact(smoke, capsys):
    short = dict(COUNTED, pattern_gemm=1566)
    take, calls = _source([(COUNTED, short), (COUNTED, short),
                           (COUNTED, dict(COUNTED))])
    smoke.RETAKE_S.pop("t", None)
    assert smoke.exact_trace("t", "prefill", take) == 3
    assert len(calls) == 3
    out = capsys.readouterr().out
    assert out.count('lost device records of {"pattern_gemm": 10}') == 2
    assert "retake 1 of 3" in out and "retake 2 of 3" in out
    assert smoke.RETAKE_S["t"] >= 0.0


def test_a_trace_already_taken_is_tried_first(smoke):
    take, calls = _source([(COUNTED, dict(COUNTED))])
    first = (COUNTED, dict(COUNTED, flash_attention=55), "first")
    assert smoke.exact_trace("t", "what", take, first=first) == 1
    assert len(calls) == 1
    assert smoke.exact_trace("t", "what", take,
                             first=(COUNTED, dict(COUNTED), "first")) \
        == "first"


def test_a_trace_still_short_after_the_last_retake_fails(smoke, capsys):
    short = dict(COUNTED, flash_attention=50)
    take, calls = _source([(COUNTED, short)] * 4)
    with pytest.raises(SystemExit):
        smoke.exact_trace("t", "what", take, retakes=3)
    assert len(calls) == 4
    out = capsys.readouterr().out
    assert "FAIL" in out and "no trace of 4" in out


@pytest.mark.parametrize("traced", [
    dict(COUNTED, pattern_gemm=1577),                     # more: never lost
    dict(COUNTED, pattern_gemm=1566, flash_attention=57),
])
def test_a_trace_that_counts_more_fails_at_once(smoke, traced, capsys):
    take, calls = _source([(COUNTED, traced), (COUNTED, dict(COUNTED))])
    with pytest.raises(SystemExit):
        smoke.exact_trace("t", "what", take)
    assert len(calls) == 1
    assert "more launches" in capsys.readouterr().out


def test_a_kernel_never_launched_fails(smoke):
    counted = dict(COUNTED, flash_attention=0)
    take, calls = _source([(counted, dict(counted))])
    with pytest.raises(SystemExit):
        smoke.exact_trace("t", "what", take)
