"""Offline performance analysis over a serve trace + attribution report
(the counterpart of ``repro/launch/analyze.py``).

A served run leaves two artifacts behind:

  * ``experiments/bench_torch/trace_telemetry.jsonl`` — the
    request-lifecycle trace (``launch/serve.py --trace-out``, or any
    engine run with a ``Telemetry(trace_path=...)``);
  * ``experiments/bench_torch/attribution.json`` — the measured-vs-modeled
    roofline report (``roofline/attribution.py``'s ``write_report``).

This CLI turns them into the operator's view: per-request critical-path
breakdowns (queue-wait → prefill → decode → stalls), an ASCII engine
timeline with occupancy shading, SLO percentile tables, and the
per-kernel achieved-roofline table — without rerunning anything.

    PYTHONPATH=src python -m repro_torch.launch.analyze
    PYTHONPATH=src python -m repro_torch.launch.analyze \\
        --trace experiments/bench_torch/trace_telemetry.jsonl \\
        --attribution experiments/bench_torch/attribution.json \\
        --out experiments/bench_torch/analysis.json

Exit code 2 when the trace is missing or holds no events (nothing to
analyze — run a traced serve first), else 0. ``--out`` writes the full
machine-readable analysis (``TraceAnalysis.to_dict()`` plus the
attribution rows). Reads files only: no device is touched.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional, Sequence

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))
_BENCH_DIR = os.path.join(_ROOT, "experiments", "bench_torch")
DEFAULT_TRACE = os.path.join(_BENCH_DIR, "trace_telemetry.jsonl")
DEFAULT_ATTRIBUTION = os.path.join(_BENCH_DIR, "attribution.json")


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trace", default=DEFAULT_TRACE,
                    help="trace JSONL (telemetry Tracer output)")
    ap.add_argument("--attribution", default=None,
                    help="attribution.json to render alongside "
                         f"(default {DEFAULT_ATTRIBUTION} when present)")
    ap.add_argument("--out", default=None,
                    help="write the machine-readable analysis JSON here")
    ap.add_argument("--width", type=int, default=72,
                    help="timeline width in columns")
    ap.add_argument("--top", type=int, default=8,
                    help="slowest requests to break down")
    args = ap.parse_args(argv)

    # deferred: keep `--help` fast
    from repro_torch.roofline import attribution as attr_mod
    from repro_torch.runtime import trace_analysis

    if not os.path.exists(args.trace):
        print(f"analyze: no trace at {args.trace} — run a traced serve "
              f"first (e.g. launch/serve.py --trace-out)")
        return 2
    analysis = trace_analysis.analyze(args.trace)
    if not analysis.events:
        print(f"analyze: trace {args.trace} holds no events")
        return 2

    print(trace_analysis.render(analysis, width=args.width,
                                top_requests=args.top))

    attr_path = args.attribution
    if attr_path is None and os.path.exists(DEFAULT_ATTRIBUTION):
        attr_path = DEFAULT_ATTRIBUTION
    attr_report = None
    if attr_path:
        if not os.path.exists(attr_path):
            print(f"analyze: no attribution report at {attr_path} "
                  f"(write one with roofline.attribution.write_report), "
                  f"skipped")
        else:
            attr_report = attr_mod.read_report(attr_path)
            print("\n--- roofline attribution "
                  f"({os.path.relpath(attr_path)}) ---")
            print(attr_mod.render_report(attr_report["rows"]))

    if args.out:
        doc = analysis.to_dict()
        doc["trace_path"] = args.trace
        if attr_report is not None:
            doc["attribution"] = attr_report
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(doc, f, indent=1)
        print(f"\nanalyze: wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
