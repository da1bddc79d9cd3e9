"""Roofline report of a dry-run (mirrors ``repro/roofline/report.py``).

Reads the ``*.json`` records ``launch/dryrun.py`` writes and derives, per
(arch × shape × mesh), with the H100's constants (``roofline/hw.py``):

    compute term    = traced FLOPs / peak bf16 FLOP/s      [per-device step]
    memory term     = traced bytes / HBM bw
    collective term = collective bytes / NVLink bw per direction
    dominant        = argmax of the three
    MODEL_FLOPS     = 6·N·D (train) or 2·N·D (inference), N = active params
    useful ratio    = MODEL_FLOPS / (traced FLOPs × devices)
    roofline frac   = useful compute time / roofline step time

Usage:
    PYTHONPATH=src python -m repro_torch.roofline.report \\
        --dryrun experiments/dryrun_torch --mesh 16x16 --format md
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, List, Optional, Sequence

from repro_torch.configs import get_config
from repro_torch.configs.base import SHAPES
from repro_torch.roofline.hw import (
    PEAK_FLOPS_BF16,
    model_flops_infer,
    model_flops_train,
    roofline_terms,
)

MESH_DEVICES = {"16x16": 256, "2x16x16": 512}


def model_flops_for(arch: str, shape_name: str) -> float:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    n = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return model_flops_train(n, tokens)
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return model_flops_infer(n, tokens)
    # decode: one new token per sequence
    return model_flops_infer(n, shape.global_batch)


def load_cells(dryrun_dir: str, mesh: str) -> List[Dict]:
    cells = []
    for path in sorted(glob.glob(os.path.join(dryrun_dir, f"*__{mesh}.json"))):
        with open(path) as f:
            rec = json.load(f)
        if rec.get("status") != "ok":
            cells.append(rec)
            continue
        terms = roofline_terms(
            rec["flops"], rec["bytes_accessed"], rec["collectives"]["total"]
        )
        mf = model_flops_for(rec["arch"], rec["shape"])
        devices = MESH_DEVICES[mesh]
        useful = mf / max(rec["flops"] * devices, 1e-9)
        # roofline fraction: time the USEFUL flops would take at peak vs the
        # roofline-predicted step time of the traced program
        useful_time = (mf / devices) / PEAK_FLOPS_BF16
        frac = useful_time / max(terms.step_s, 1e-12)
        rec.update(terms.as_dict())
        rec["model_flops"] = mf
        rec["useful_flop_ratio"] = useful
        rec["roofline_fraction"] = frac
        cells.append(rec)
    return cells


def render_md(cells: List[Dict], mesh: str) -> str:
    lines = [
        f"### Roofline — mesh {mesh} ({MESH_DEVICES.get(mesh, '?')} cards, "
        "per-device terms, H100 SXM: 989 TF/s bf16 · 3.35 TB/s HBM · "
        "450 GB/s/direction NVLink)",
        "",
        "| arch | shape | compute (s) | memory (s) | collective (s) | "
        "dominant | useful/traced | roofline frac |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for rec in cells:
        if rec.get("status") != "ok":
            lines.append(
                f"| {rec['arch']} | {rec['shape']} | — | — | — | "
                f"SKIP: {rec.get('reason', rec.get('error', '?'))[:48]} | — | — |"
            )
            continue
        lines.append(
            f"| {rec['arch']} | {rec['shape']} "
            f"| {rec['compute_s']:.3e} | {rec['memory_s']:.3e} "
            f"| {rec['collective_s']:.3e} | **{rec['dominant']}** "
            f"| {rec['useful_flop_ratio']:.2f} "
            f"| {rec['roofline_fraction']:.2%} |"
        )
    return "\n".join(lines)


def main(argv: Optional[Sequence[str]] = None) -> str:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dryrun", default="experiments/dryrun_torch")
    ap.add_argument("--mesh", default="16x16")
    ap.add_argument("--format", default="md", choices=["md", "json"])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    cells = load_cells(args.dryrun, args.mesh)
    if args.format == "json":
        text = json.dumps(cells, indent=1)
    else:
        text = render_md(cells, args.mesh)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)
    return text


if __name__ == "__main__":
    main()
