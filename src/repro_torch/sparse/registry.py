"""Scheme -> kernel registry: pack, packed matmul or conv, exact dense form.

Mirrors ``repro/sparse/registry.py`` for the ``dense``, ``tile_pattern``,
``column``, ``pattern`` and ``pattern_shared`` schemes. Every packed GEMM
of a model goes through ``dispatch_matmul`` and every packed conv through
``dispatch_conv``; each calls its scheme's kernel at every M: prefill
(M = B*S) and decode (M = batch) alike, and every conv batch.

Plans (``sparse/tune.py``): the first dispatch of a leaf at a given (M,
dtype, epilogue) resolves its plan once (a plan stamped in the leaf's
meta for this device, an in-process tuned one, a first-dispatch search
under ``REPRO_AUTOTUNE=1``, else the wrappers' own heuristic) and
memoizes the call on the leaf object, so later dispatches hash nothing.
A plan applies only where its route is the one the shapes give at M;
elsewhere the call runs the heuristic. The reference's ``plan:*`` and
``plan_mode`` entries were tuned for a CPU or a TPU and are never read.

``DISPATCH_STATS`` counts ``matmul:<scheme>:m<bucket>`` /
``conv:<scheme>:m<bucket>`` per dispatch, ``plan_build:matmul:<scheme>:
<plan>`` per resolved GEMM plan (the concrete plan, the heuristic's too),
and ``plan_miss:<kind>:<scheme>:m<bucket>`` per dispatch whose tuned plan
names another route; the first two go to the ``sparse.dispatch_total``
and ``sparse.plan_build_total`` counters of the process-wide telemetry
registry as well. The reference counts once per trace site; the port
counts once per eager dispatch and once per dispatch in a CUDA graph
capture's warm-up, never during the capture and never on a replay.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
from typing import Any, Callable, Dict, Iterator, Optional

import torch

from repro_torch.kernels.column_gemm import column_gemm, pack_columns
from repro_torch.kernels.epilogue import check_activation
from repro_torch.kernels.pattern_conv import pattern_conv
from repro_torch.kernels.pattern_gemm import (
    pack_tile_pattern_blocked,
    pattern_gemm,
)
from repro_torch.runtime import profiler as _profiler
from repro_torch.runtime import telemetry as _telemetry
from repro_torch.sparse import tune as _tune
from repro_torch.sparse.packed import PackedTensor


@dataclasses.dataclass(frozen=True)
class SchemeHandler:
    """One scheme's deployment triple, plus its conv for conv schemes and
    its ``plan``: ``plan(pt, M, activation, exec_plan) -> fn(x, pt,
    bias)``, the call of one (leaf, M, epilogue) under a ``tune.Plan``
    (None: the wrappers' heuristic, launched exactly as untuned).
    ``matmul`` keeps the per-scheme signature and goes through the one
    plan-cached ``dispatch_matmul``."""

    name: str
    # pack(w, spec) -> PackedTensor | None (None: stays dense)
    pack: Callable[[torch.Tensor, Any], Optional[PackedTensor]]
    # matmul(x (M, I), pt, bias, activation) -> (M, O)
    matmul: Optional[Callable[..., torch.Tensor]]
    # to_dense(pt) -> the exact dense (pruned) weight the buffers encode
    to_dense: Callable[[PackedTensor], torch.Tensor]
    # conv(x (B, H, W, C), pt, bias, activation, **knobs) -> (B, H, W, A)
    conv: Optional[Callable[..., torch.Tensor]] = None
    plan: Optional[Callable[..., Callable]] = None


def _dense_pack(w: torch.Tensor, spec: Any) -> Optional[PackedTensor]:
    # no compressed form for unstructured sparsity: the leaf stays dense
    return None


# --------------------------------------------------------------- tile_pattern

def _tile_pack(w: torch.Tensor, spec: Any) -> Optional[PackedTensor]:
    """Pack a tile-pattern-pruned (I, O) leaf into the blocked layout."""
    block_p, group_q, keep = spec.tile_block_p, spec.tile_group_q, spec.tile_keep
    if w.ndim != 2:
        return None
    I, O = w.shape
    if I % group_q or O % block_p or keep >= group_q:
        return None
    wpb, lane_idx = pack_tile_pattern_blocked(w, block_p=block_p,
                                              group_q=group_q, keep=keep)
    meta = (("block_p", block_p), ("group_q", group_q), ("keep", keep),
            ("w_ndim", 3))
    return PackedTensor("tile_pattern", (I, O), ("w_packed", "lane_idx"),
                        (wpb, lane_idx), meta)


def _tile_wpb(pt: PackedTensor) -> torch.Tensor:
    """Blocked (nb, Kp, bp) panels; converts the legacy flat (Kp, P)."""
    wp = pt.buf("w_packed")
    if pt.canonical_w_ndim == 3:
        return wp
    nb = pt.buf("lane_idx").shape[0]
    Kp, P = wp.shape
    return wp.reshape(Kp, nb, P // nb).permute(1, 0, 2).contiguous()


def _tile_matmul(x, pt, bias=None, activation=None):
    return dispatch_matmul(x, pt, bias=bias, activation=activation)


def _tile_plan(pt, M, activation, exec_plan=None):
    knobs = _tune.plan_knobs("matmul", exec_plan)

    def fn(x, pt, bias):
        return pattern_gemm(x, _tile_wpb(pt), pt.buf("lane_idx"), bias,
                            activation=activation, **knobs)

    return fn


def _tile_to_dense(pt: PackedTensor) -> torch.Tensor:
    """Exact dense reconstruction: scatter each panel's rows back."""
    wpb, li = _tile_wpb(pt), pt.buf("lane_idx").long()
    nb, Kp, bp = wpb.shape
    Q = pt.shape[-2]
    dense = torch.zeros((nb, Q, bp), dtype=wpb.dtype, device=wpb.device)
    dense.scatter_(1, li[:, :, None].expand(nb, Kp, bp), wpb)
    return dense.permute(1, 0, 2).reshape(Q, nb * bp)


# --------------------------------------------------------------------- column

def _column_pack(w: torch.Tensor, spec: Any) -> Optional[PackedTensor]:
    """Pack a column-pruned (I, O) leaf: keep the surviving contraction
    rows. Nothing pruned, or a leaf that is not 2-D: stays dense."""
    if w.ndim != 2:
        return None
    group = spec.column_group
    wp, kept = pack_columns(w, group=group)
    if kept.shape[0] >= w.shape[0]:
        return None
    return PackedTensor("column", tuple(w.shape), ("w_packed", "kept_idx"),
                        (wp, kept), (("group", group),))


def _column_matmul(x, pt, bias=None, activation=None):
    return dispatch_matmul(x, pt, bias=bias, activation=activation)


def _column_plan(pt, M, activation, exec_plan=None):
    knobs = _tune.plan_knobs("matmul", exec_plan)

    def fn(x, pt, bias):
        return column_gemm(x, pt.buf("w_packed"), pt.buf("kept_idx"), bias,
                           activation=activation, **knobs)

    return fn


def _column_to_dense(pt: PackedTensor) -> torch.Tensor:
    """Exact dense reconstruction. Rows that a stacked reference artifact
    padded (index 0, zero weight) add zeros, so the sum stays exact."""
    wp = pt.buf("w_packed")
    dense = torch.zeros((pt.shape[-2], wp.shape[1]), dtype=wp.dtype,
                        device=wp.device)
    return dense.index_put_((pt.buf("kept_idx").long(),), wp,
                            accumulate=True)


# -------------------------------------------------------------------- pattern

def _pattern_pack(w4: torch.Tensor, spec: Any) -> Optional[PackedTensor]:
    """Pack a pattern-pruned conv (A, C, 3, 3) with channel-shared taps.

    Each channel's taps are the union of its nonzero taps over all
    filters; the leaf packs only when that fits ``pattern_keep`` taps
    (else None: it stays dense). Unused slots of a channel (connectivity
    pruned some of its taps, or all) hold tap 0 with zero weight.
    """
    if w4.ndim != 4 or tuple(w4.shape[-2:]) != (3, 3):
        return None
    keep = spec.pattern_keep
    A, C = w4.shape[0], w4.shape[1]
    nz = (w4 != 0).any(dim=0).reshape(C, 9)
    count = nz.sum(dim=1)
    if bool((count > keep).any()):
        return None
    # each channel's nonzero taps in ascending order, then the others
    order = torch.argsort((~nz).to(torch.int32), dim=1, stable=True)[:, :keep]
    used = torch.arange(keep, device=w4.device)[None, :] < count[:, None]
    taps = torch.where(used, order, torch.zeros_like(order))
    wk = torch.gather(w4.reshape(A, C, 9), 2, taps[None].expand(A, C, keep))
    wk = torch.where(used[None], wk, torch.zeros((), dtype=w4.dtype,
                                                 device=w4.device))
    w_packed = wk.permute(1, 2, 0).reshape(C * keep, A).contiguous()
    return PackedTensor("pattern", tuple(w4.shape), ("w_packed", "taps"),
                        (w_packed, taps.to(torch.int32).contiguous()),
                        (("keep", keep),))


def _pattern_conv(x, pt, bias=None, activation=None, **knobs):
    """Stride-1 SAME 3x3 pattern conv: x (B, H, W, C) -> (B, H, W, A);
    ``knobs``: a plan's ``block_n`` / ``grid_order``."""
    return pattern_conv(x, pt.buf("w_packed"), pt.buf("taps"), bias,
                        activation=activation, **knobs)


def conv_gemm_runner(pt, plan, *, activation: Optional[str] = None
                     ) -> Callable:
    """fn(x, w_packed, taps, bias=None) for one conv plan (the tuner's
    timing unit): ``pattern_conv`` with the plan's channel tile and grid
    order on the wgmma route, as the wrapper picks on any other."""
    knobs = _tune.plan_knobs("conv", plan)

    def fn(x, w_packed, taps, bias=None):
        return pattern_conv(x, w_packed, taps, bias, activation=activation,
                            **knobs)

    return fn


def _pattern_matmul(x, pt, bias=None, activation=None):
    raise TypeError("scheme 'pattern' packs a conv tensor; use conv "
                    "dispatch (models.cnn.conv_apply), not a GEMM matmul")


def _pattern_to_dense(pt: PackedTensor) -> torch.Tensor:
    """Exact dense reconstruction; zero-weight pad slots add zeros."""
    wp, taps = pt.buf("w_packed"), pt.buf("taps").long()
    A, C = pt.shape[0], pt.shape[1]
    keep = taps.shape[1]
    dense = torch.zeros((C, 9, A), dtype=wp.dtype, device=wp.device)
    rows = torch.arange(C, device=wp.device)[:, None].expand(C, keep)
    dense.index_put_((rows, taps), wp.reshape(C, keep, A), accumulate=True)
    return dense.permute(2, 0, 1).reshape(A, C, 3, 3)


_PATTERN = dict(pack=_pattern_pack, matmul=_pattern_matmul,
                to_dense=_pattern_to_dense, conv=_pattern_conv)

SCHEMES = {
    "dense": SchemeHandler("dense", _dense_pack, None, lambda pt: pt.buf(
        "w_packed")),
    "tile_pattern": SchemeHandler("tile_pattern", _tile_pack, _tile_matmul,
                                  _tile_to_dense, plan=_tile_plan),
    "column": SchemeHandler("column", _column_pack, _column_matmul,
                            _column_to_dense, plan=_column_plan),
    # `pattern` (per-kernel top-4) packs only where the taps happen to be
    # channel-shared; `pattern_shared` always packs, its projection makes
    # them so. Both pack into a "pattern" leaf.
    "pattern": SchemeHandler("pattern", **_PATTERN),
    "pattern_shared": SchemeHandler("pattern_shared", **_PATTERN),
}


def handler_for(scheme: str) -> SchemeHandler:
    """Resolve a scheme; schemes without a packed path resolve to dense."""
    return SCHEMES.get(scheme, SCHEMES["dense"])


def _handler_of(pt: PackedTensor) -> SchemeHandler:
    # no fallback: a leaf tagged with an unknown scheme must fail loudly,
    # not have its buffers misread
    handler = SCHEMES.get(pt.scheme)
    if handler is None:
        raise KeyError(f"unknown packed scheme {pt.scheme!r}")
    return handler


# ---------------------------------------------------------- dispatch stats

DISPATCH_STATS: "collections.Counter[str]" = collections.Counter()


def dispatch_stats() -> Dict[str, int]:
    return dict(DISPATCH_STATS)


def reset_dispatch_stats() -> None:
    DISPATCH_STATS.clear()


@contextlib.contextmanager
def dispatch_stats_scope() -> Iterator["collections.Counter[str]"]:
    """Measure dispatches in isolation: snapshot the module counter,
    start the block from zero, and restore the snapshot (plus whatever
    the block added) on exit. Yields the live ``Counter``."""
    snap = collections.Counter(DISPATCH_STATS)
    DISPATCH_STATS.clear()
    try:
        yield DISPATCH_STATS
    finally:
        DISPATCH_STATS.update(snap)


def _count_plan_build(kind: str, pt: PackedTensor, plan: "_tune.Plan"):
    DISPATCH_STATS[f"plan_build:{kind}:{pt.scheme}:{plan.to_str()}"] += 1
    _telemetry.get_registry().counter(
        "sparse.plan_build_total", kind=kind, scheme=pt.scheme,
        plan=plan.to_str()).inc()


def _plan_label(pt: PackedTensor, kind: str, M: int, *, mode: str,
                route: str) -> str:
    """Plan tag for profiler keys: the persisted plan that applies at M
    on this device, else ``heuristic`` (meta only: the profiling hook
    never starts a search)."""
    plan = _tune._meta_plan(pt, kind, M, mode)
    return (plan.to_str() if plan is not None and plan.impl == route
            else "heuristic")


class _Dispatch:
    """One memoized (leaf, M, dtype, epilogue) call: the function with its
    plan bound, its stats keys and its telemetry counter (looked up once
    per registry, not per call)."""

    __slots__ = ("fn", "label", "key", "miss", "labels", "reg", "counter",
                 "deferred")

    def __init__(self, fn, label, key, miss, labels, deferred):
        self.fn, self.label, self.key, self.miss = fn, label, key, miss
        self.labels, self.deferred = labels, deferred
        self.reg = self.counter = None

    def count(self) -> None:
        DISPATCH_STATS[self.key] += 1
        if self.miss is not None:
            DISPATCH_STATS[self.miss] += 1
        reg = _telemetry.get_registry()
        if reg is not self.reg:
            self.reg = reg
            self.counter = reg.counter("sparse.dispatch_total", **self.labels)
        self.counter.inc()


def _resolve(kind: str, pt: PackedTensor, handler: SchemeHandler,
             x: torch.Tensor, M: int, activation: Optional[str],
             capturing: bool) -> _Dispatch:
    """Resolve the plan of a first dispatch and bind it."""
    dev = x.device
    cuda = dev.type == "cuda"
    mode = _tune.device_mode(dev)
    geometry = tuple(x.shape[:3]) if kind == "conv" else None
    plan = _tune.resolve(pt, kind, M, mode=mode, capturing=capturing,
                         geometry=geometry)
    route = _tune.route(pt, kind, M, cuda=cuda)
    bucket = _tune.m_bucket(M, _tune._small_m_of(pt))
    miss = plan is not None and plan.impl != route
    applied = None if plan is None or miss else plan
    if kind == "conv":
        fn = (lambda x, pt, bias, knobs=_tune.plan_knobs("conv", applied):
              handler.conv(x, pt, bias, activation, **knobs))
    else:
        # a resolved GEMM plan build is counted, the heuristic's spelled
        # out (never the tuner's candidate probes)
        _count_plan_build(kind, pt, applied or _tune.heuristic_plan(
            pt, kind, M, cuda=cuda, sms=_tune.sm_count(dev) if cuda else 0))
        fn = handler.plan(pt, M, activation, applied)
    return _Dispatch(
        fn, _plan_label(pt, kind, M, mode=mode, route=route),
        f"{kind}:{pt.scheme}:m{bucket}",
        f"plan_miss:{kind}:{pt.scheme}:m{bucket}" if miss else None,
        dict(kind=kind, scheme=pt.scheme, bucket=bucket),
        _tune.resolution_deferred(pt, kind, M, mode, capturing))


def _dispatch(kind: str, x: torch.Tensor, pt: PackedTensor,
              handler: SchemeHandler, M: int, bias: Optional[torch.Tensor],
              activation: Optional[str]) -> torch.Tensor:
    capturing = x.is_cuda and torch.cuda.is_current_stream_capturing()
    key = (kind, M, x.dtype, bias is not None, activation)
    d = pt._dispatch.get(key)
    if d is None:
        d = _resolve(kind, pt, handler, x, M, activation, capturing)
        if not d.deferred:
            pt._dispatch[key] = d
    if capturing:                  # never counted, never walled
        return d.fn(x, pt, bias)
    d.count()
    prof = _profiler.get_profiler()
    if prof.active:
        return prof.wall_dispatch(kind, pt, M, d.label, d.fn, (x, pt, bias))
    return d.fn(x, pt, bias)


def dispatch_matmul(x: torch.Tensor, pt: PackedTensor, *,
                    bias: Optional[torch.Tensor] = None,
                    activation: Optional[str] = None) -> torch.Tensor:
    """y = act(x @ dense(pt) + bias) through the scheme's packed kernel,
    under the leaf's plan."""
    check_activation(activation)
    handler = _handler_of(pt)
    if handler.plan is None:
        raise TypeError(f"scheme {pt.scheme!r} has no packed matmul")
    x = x.contiguous()
    return _dispatch("matmul", x, pt, handler, x.shape[0], bias, activation)


def dispatch_conv(x: torch.Tensor, pt: PackedTensor, *,
                  bias: Optional[torch.Tensor] = None,
                  activation: Optional[str] = None) -> torch.Tensor:
    """act(conv(x, dense(pt)) + bias) through the scheme's packed conv
    kernel (stride 1, SAME; conv-shaped schemes only), under the leaf's
    plan."""
    check_activation(activation)
    handler = _handler_of(pt)
    if handler.conv is None:
        raise TypeError(f"scheme {pt.scheme!r} has no conv dispatch")
    x = x.contiguous()
    B, H, W = x.shape[:3]
    return _dispatch("conv", x, pt, handler, B * H * W, bias, activation)
