"""Roofline attribution: measured dispatch time vs modeled kernel cost
(the counterpart of ``repro/roofline/attribution.py``).

The analytic cost model below and ``hw.py`` predict what a packed kernel
SHOULD cost on the card; the sampling profiler (``runtime/profiler.py``)
measures what it DOES cost. This module joins the two into an
achieved-fraction-of-roofline report per (kind, scheme, M-bucket, plan):

    achieved_fraction = modeled_ns / measured_ns

where ``modeled_ns`` is the dominant roofline term (``hw.py``'s H100
constants by default, overridable). Each row is labeled memory- vs
compute-bound from the model and flagged when it achieves less than
``threshold`` of its roofline.

Analytic per-dispatch model (exact for every packed GEMM scheme): each
STORED weight element multiplies once per output row, so

    flops = 2 · M · nnz(w_packed per layer)
    bytes = packed buffers (weights + indices) + M·I activations
            + M·O outputs

which reduces to 2·M·Kp·O for tile_pattern, 2·M·K_kept·O for column and
2·M·I·O for dense. Activations and outputs count ``itemsize`` bytes an
element: 4 (the default) is the reference's fp32 model, 2 models a bf16
run.

The port keeps one leaf per layer where the reference stacks them, so
both halves walk one leaf per reference path (layer 0 of ``blocks/<l>/``,
the reference's ``canonical_slice``): the same leaves, dispatches and
sample counts as the reference's over its stacked tree.

``profile_packed_tree`` is the eager micro-profiler: it dispatches each
packed leaf through the REAL registry seam (``dispatch_matmul`` /
``dispatch_conv``) under a ``profiler_scope``, so the measured half of
the join uses the exact kernels, plans and dispatch bookkeeping the
serve path uses. On the card each dispatch is queued behind an L2 flush
and a device-side sleep that outlasts the host's enqueue, so its event
pair times the kernel reading its operands from HBM, as the model counts
them, and not the host's dispatch.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.roofline import hw
from repro_torch.roofline.costs import Costs
from repro_torch.sparse.packed import PackedTensor, is_packed
from repro_torch.sparse.tune import canonical_slice
from repro_torch.utils.tree import reference_path, tree_items

# fraction below which a kernel is flagged as leaving roofline on the
# table; deliberately low, so the flag only means "look here first"
DEFAULT_THRESHOLD = 0.05

# on the card: bytes zeroed before each walled dispatch (more than the
# H100's 50 MB L2), and the sleep queued after them, in SM cycles (at least
# 0.5 ms at the top clock, ~1.98 GHz; a host enqueues one dispatch in
# under 0.1 ms)
L2_FLUSH_BYTES = 64 << 20
QUEUE_AHEAD_CYCLES = 1_000_000


def packed_leaves(tree: Any) -> List[Tuple[str, PackedTensor]]:
    """(reference path, leaf) of every packed leaf, one per reference path
    (the first layer's of a ``blocks`` list)."""
    seen: Dict[str, PackedTensor] = {}
    for path, leaf in tree_items(tree):
        if is_packed(leaf):
            seen.setdefault(reference_path(path), leaf)
    return list(seen.items())


# ---------------------------------------------------------------------------
# analytic per-dispatch cost model
# ---------------------------------------------------------------------------

def model_packed_costs(pt: PackedTensor, m: int, *,
                       itemsize: int = 4) -> Costs:
    """Modeled flops/bytes for ONE dispatch of ``pt`` at ``m`` rows, with
    ``itemsize`` bytes per activation and output element."""
    canon = canonical_slice(pt)
    wp = canon.buf("w_packed")
    flops = 2.0 * m * float(wp.numel())
    cols_in = int(canon.shape[-2])
    cols_out = int(canon.shape[-1])
    nbytes = (float(canon.packed_bytes())
              + m * cols_in * itemsize        # activations streamed in
              + m * cols_out * itemsize)      # outputs streamed back
    return Costs(flops=flops, bytes=nbytes)


# ---------------------------------------------------------------------------
# eager micro-profiler over a packed tree
# ---------------------------------------------------------------------------

@torch.no_grad()
def profile_packed_tree(packed_tree: Any, ms: Sequence[int] = (8, 256), *,
                        samples: int = 8, warmup: int = 2,
                        sample_rate: float = 1.0, seed: int = 0,
                        device: DeviceLike = None,
                        dtype: torch.dtype = torch.float32
                        ) -> List[Dict[str, Any]]:
    """Measure every packed leaf through the real dispatch seam.

    For each leaf and each M in ``ms``: ``warmup + samples`` eager
    dispatches under a ``profiler_scope``, so the walls land in
    per-(kind, scheme, bucket, plan) reservoirs. GEMM inputs are (M, I)
    draws of ``np.random.RandomState(seed)``; a conv's are one NHWC image
    of side ceil(sqrt(M)). Inputs are made in ``dtype`` on ``device`` (the
    card unless the caller names the CPU), where the leaves must live. On
    the card each dispatch starts with a cold L2 and with the host's
    enqueue hidden (module note), so a wall is the kernel's device time.
    Returns the profiler's ``report()`` rows — the measured input to
    ``attribute``.
    """
    from repro_torch.runtime.profiler import profiler_scope
    from repro_torch.sparse.registry import (
        dispatch_conv,
        dispatch_matmul,
        handler_for,
    )

    dev = resolve_device(device)
    rng = np.random.RandomState(seed)

    def draw(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(
            device=dev, dtype=dtype)

    if dev.type == "cuda":
        flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)

        def queue_ahead():
            flush.zero_()
            torch.cuda._sleep(QUEUE_AHEAD_CYCLES)
    else:
        def queue_ahead():
            pass

    with profiler_scope(sample_rate=sample_rate, warmup=warmup) as prof:
        for _, leaf in packed_leaves(packed_tree):
            pt = canonical_slice(leaf)
            handler = handler_for(pt.scheme)
            for m in ms:
                if handler.plan is not None:
                    x = draw(int(m), int(pt.shape[-2]))
                    for _ in range(warmup + samples):
                        queue_ahead()
                        dispatch_matmul(x, pt)
                elif handler.conv is not None:
                    # conv wants NHWC; pick H=W covering >= m positions
                    side = max(1, int(np.ceil(np.sqrt(m))))
                    x = draw(1, side, side, int(pt.shape[-3]))
                    for _ in range(warmup + samples):
                        queue_ahead()
                        dispatch_conv(x, pt)
        rows = prof.report()
    return rows


# ---------------------------------------------------------------------------
# the measured-vs-modeled join
# ---------------------------------------------------------------------------

def attribute(profile_rows: Sequence[Dict[str, Any]], packed_tree: Any, *,
              threshold: float = DEFAULT_THRESHOLD,
              peak_flops: float = hw.PEAK_FLOPS_BF16,
              hbm_bw: float = hw.HBM_BW,
              itemsize: int = 4) -> List[Dict[str, Any]]:
    """Join profiler report rows with the analytic cost model.

    One output row per measured (kind, scheme, bucket, plan): carries
    ``measured_ns``, ``modeled_ns``, ``achieved_fraction``, the
    memory/compute ``bound`` label, and ``flagged`` when the fraction is
    below ``threshold``. Engine-level walls (scheme ``engine:*``) pass
    through with measured time only — there is no single-kernel model
    for a whole engine call.
    """
    by_scheme: Dict[str, List[PackedTensor]] = {}
    if packed_tree is not None:
        for _, leaf in packed_leaves(packed_tree):
            by_scheme.setdefault(leaf.scheme, []).append(leaf)

    out: List[Dict[str, Any]] = []
    for row in profile_rows:
        scheme = row["scheme"]
        rec = {
            "kind": row["kind"], "scheme": scheme,
            "bucket": int(row["bucket"]), "plan": row["plan"],
            "samples": int(row.get("samples", 0)),
            "measured_ns": float(row["measured_ns"]),
            "bytes_per_call": float(row.get("bytes_per_call", 0.0)),
            "modeled_ns": None, "achieved_fraction": None,
            "bound": None, "flagged": False,
        }
        group = by_scheme.get(scheme)
        if group:
            # mean model over the scheme's distinct leaf geometries —
            # the profiler key blends those same geometries
            m = max(int(row["bucket"]), 1)
            costs = [model_packed_costs(l, m, itemsize=itemsize)
                     for l in group]
            flops = sum(c.flops for c in costs) / len(costs)
            nbytes = sum(c.bytes for c in costs) / len(costs)
            terms = hw.RooflineTerms(
                compute_s=flops / peak_flops,
                memory_s=nbytes / hbm_bw,
                collective_s=0.0)
            modeled_ns = terms.step_s * 1e9
            measured = max(rec["measured_ns"], 1e-9)
            rec.update(
                modeled_ns=modeled_ns,
                achieved_fraction=modeled_ns / measured,
                bound=terms.dominant,
                model_flops=flops, model_bytes=nbytes,
                arithmetic_intensity=flops / max(nbytes, 1.0),
                flagged=bool(modeled_ns / measured < threshold),
            )
        out.append(rec)
    out.sort(key=lambda r: (r["scheme"], r["kind"], r["bucket"], r["plan"]))
    return out


def render_report(rows: Sequence[Dict[str, Any]]) -> str:
    """ASCII attribution table (``launch/analyze.py`` prints this)."""
    lines = [
        f"{'kind':<12s} {'scheme':<18s} {'m':>6s} {'plan':<22s} "
        f"{'measured':>11s} {'modeled':>11s} {'roofline':>9s} "
        f"{'bound':<8s} flag",
    ]
    lines.append("-" * len(lines[0]))
    for r in rows:
        meas = f"{r['measured_ns'] / 1e3:10.1f}u"
        if r["modeled_ns"] is None:
            lines.append(
                f"{r['kind']:<12s} {r['scheme']:<18s} {r['bucket']:>6d} "
                f"{r['plan']:<22.22s} {meas:>11s} {'-':>11s} {'-':>9s} "
                f"{'-':<8s}")
            continue
        frac = r["achieved_fraction"]
        lines.append(
            f"{r['kind']:<12s} {r['scheme']:<18s} {r['bucket']:>6d} "
            f"{r['plan']:<22.22s} {meas:>11s} "
            f"{r['modeled_ns'] / 1e3:10.1f}u {frac:8.4f} "
            f"{r['bound']:<8s} {'<-- LOW' if r['flagged'] else ''}")
    return "\n".join(lines)


def write_report(path: str, rows: Sequence[Dict[str, Any]],
                 **extra: Any) -> None:
    """Persist the attribution report (``launch/analyze.py`` reads it)."""
    with open(path, "w") as f:
        json.dump({"schema": 1, "rows": list(rows), **extra}, f, indent=1,
                  sort_keys=True)
        f.write("\n")


def read_report(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)
