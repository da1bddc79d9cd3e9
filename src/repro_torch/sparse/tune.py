"""Plan tuner and persistent execution-plan cache for packed dispatch (the
port of ``repro/sparse/tune.py``).

The paper's deployment story is compiler-level: the compressed layout
ships with a tuned execution plan (PatDNN's compile-time block search), so
serving never pays a search or a heuristic miss. On the card the search
space is what the Hopper kernels already take:

  * a ``Plan`` names one route of a packed GEMM or conv, as the kernel
    wrappers name them (``skinny`` / ``wgmma`` / ``wmma`` / ``simt``; on
    the CPU the plain version, named as the reference names its
    interpret-mode plan: ``gather`` for a GEMM, ``xla`` for a conv), and
    the knobs of that route that leave every output element's sum as it
    is: the wgmma GEMMs' row tile ``block_m`` (``bm``) and the conv's
    channel tile (``bp``), each with a grid order (``go``: ``mp`` runs the
    output's column tiles fastest, ``pm`` the row tiles). The route and
    the K split stay what the shapes give (``tiled_variant``,
    ``skinny_ksplit``, ``wgmma_plan``): a plan never changes them, so
    every candidate computes the same bits and tuning never changes a
    served token;
  * ``tune_plan`` times the candidates for one (leaf, M-bucket) with CUDA
    event pairs and returns the winner; ``tune_packed_tree`` (behind
    ``PrunedArtifact.tune`` / ``pack(tune_for=...)``) searches once per
    geometry (kind, scheme, buffer shapes and dtypes, bucket, device) and
    writes the winner into the meta of every leaf of that geometry, every
    layer's;
  * plans persist under a meta key prefix of the port's own,
    ``plan_torch:<kind>:m<bucket>``, beside ``plan_torch_mode``: the
    device they were timed on (``cpu``, or the card's compute capability
    as ``cuda:sm_90``). The reference reads ``plan:*`` and ``plan_mode``
    only, so it never sees a port plan; the port never reads a ``plan:*``
    entry, and applies a stored plan only on the device it was stamped
    for;
  * ``resolve`` is the registry's seam: meta plan -> in-process tuned
    cache -> (``REPRO_AUTOTUNE=1``) a first-dispatch search -> ``None``,
    the wrappers' own heuristic.

M-buckets are the reference's: the power-of-two bucket of M, floored at
``small_m`` (32). A bucket can span two routes (M = 4 runs ``skinny``,
M = 24 ``wgmma``, both in ``m32``): a plan applies at an M only when its
route is the one the shapes give there; anywhere else the call takes the
heuristic and the registry counts a ``plan_miss``.

No search ever runs inside a CUDA graph capture (the port's counterpart
of the reference's tracer guard): ``resolve`` returns None there and
``resolution_deferred`` tells the registry not to memoize that answer.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import column_gemm as _cg
from repro_torch.kernels import pattern_conv as _pc
from repro_torch.kernels import pattern_gemm as _pg
from repro_torch.kernels.sm90 import BLOCK_K, BLOCK_MS, GRID_ORDERS, wgmma_plan
from repro_torch.runtime.telemetry import get_registry
from repro_torch.sparse.packed import PackedTensor, is_packed
from repro_torch.utils.tree import tree_items, tree_map_with_path

_MATMUL_SCHEMES = ("tile_pattern", "column")
_CONV_SCHEMES = ("pattern", "pattern_shared")

_DEFAULT_SMALL_M = 32
PLAN_PREFIX = "plan_torch:"
MODE_KEY = "plan_torch_mode"
# the one candidate of each kind on the CPU: the plain version
CPU_PLANS = {"matmul": "gather", "conv": "xla"}


# ---------------------------------------------------------------------------
# Plan: one execution strategy, serializable to a flat meta string
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Plan:
    """One candidate execution plan for a packed GEMM or conv.

    ``impl`` is the route; zero-valued block fields mean "the route's own
    default". Serialized as a flat string (``wgmma:bm=64:go=mp``) because
    it lives inside ``PackedTensor.meta`` and the JSON checkpoint
    manifest; the reference's strings (``pallas:bm=256:go=pm``,
    ``gather``) parse to the same fields as there.
    """

    impl: str
    block_m: int = 0
    block_p: int = 0
    block_k: int = 0
    grid: str = "mp"

    def to_str(self) -> str:
        parts = [self.impl]
        for tag, val in (("bm", self.block_m), ("bp", self.block_p),
                         ("bk", self.block_k)):
            if val:
                parts.append(f"{tag}={val}")
        if self.grid != "mp":
            parts.append(f"go={self.grid}")
        return ":".join(parts)

    @classmethod
    def from_str(cls, s: str) -> "Plan":
        parts = s.split(":")
        kw: Dict[str, Any] = {}
        names = {"bm": "block_m", "bp": "block_p", "bk": "block_k",
                 "go": "grid"}
        for p in parts[1:]:
            tag, val = p.split("=")
            kw[names[tag]] = val if tag == "go" else int(val)
        return cls(parts[0], **kw)


# ---------------------------------------------------------------------------
# M-buckets, meta keys, devices
# ---------------------------------------------------------------------------

def m_bucket(M: int, small_m: int = _DEFAULT_SMALL_M) -> int:
    """Power-of-two bucket of M, floored at the decode threshold."""
    b = max(int(small_m), 1)
    while b < M:
        b <<= 1
    return b


def plan_meta_key(kind: str, bucket: int) -> str:
    return f"{PLAN_PREFIX}{kind}:m{bucket}"


def _small_m_of(pt: PackedTensor) -> int:
    return int(pt.meta_dict.get("small_m", _DEFAULT_SMALL_M))


_MODES: Dict[torch.device, str] = {}
_SMS: Dict[torch.device, int] = {}


def device_mode(device: torch.device) -> str:
    """The mode a plan timed on ``device`` is stamped with: ``cpu``, or
    ``cuda:sm_<major><minor>``."""
    mode = _MODES.get(device)
    if mode is None:
        if device.type == "cuda":
            major, minor = torch.cuda.get_device_capability(device)
            mode = f"cuda:sm_{major}{minor}"
        else:
            mode = device.type
        _MODES[device] = mode
    return mode


def sm_count(device: torch.device) -> int:
    n = _SMS.get(device)
    if n is None:
        n = _SMS[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return n


def plan_mode(pt: PackedTensor) -> Optional[str]:
    """The device the leaf's persisted plans were timed on, if any."""
    return pt.meta_dict.get(MODE_KEY)


def plan_from_meta(pt: PackedTensor, kind: str, M: int) -> Optional[Plan]:
    """The persisted plan for this (kind, M-bucket), if one was tuned."""
    s = pt.meta_dict.get(plan_meta_key(kind, m_bucket(M, _small_m_of(pt))))
    return Plan.from_str(s) if isinstance(s, str) else None


def plans_in_meta(pt: PackedTensor) -> Dict[str, str]:
    """All persisted plan entries of a packed leaf (for reporting)."""
    return {k: v for k, v in pt.meta_dict.items()
            if k.startswith(PLAN_PREFIX)}


# ---------------------------------------------------------------------------
# routes and candidates: plain functions of shapes and dtype
# ---------------------------------------------------------------------------

def _kind_of(pt: PackedTensor) -> Optional[str]:
    if pt.scheme in _MATMUL_SCHEMES:
        return "matmul"
    if pt.scheme in _CONV_SCHEMES:
        return "conv"
    return None


def route(pt: PackedTensor, kind: str, M: int, *, cuda: bool) -> str:
    """The route a call at M takes: the wrappers' own choice on the card
    (16-byte aligned operands), the plain version on the CPU."""
    if not cuda:
        return CPU_PLANS[kind]
    if kind == "conv":
        return _pc.conv_variant(pt.shape[1], pt.shape[0], pt.dtype)
    if pt.scheme == "tile_pattern":
        return _pg.tiled_variant(M, pt.shape[-2],
                                 pt.buf("lane_idx").shape[-1], pt.dtype)
    K, P = pt.buf("w_packed").shape[-2:]
    return _cg.tiled_variant(M, K, P, pt.dtype)


def heuristic_plan(pt: PackedTensor, kind: str, M: int, *, cuda: bool,
                   sms: int = 0,
                   geometry: Optional[Tuple[int, int, int]] = None) -> Plan:
    """The plan the wrappers pick with no plan given, spelled out (the
    ``plan_build`` label and the tuner's "heuristic" column). ``sms``:
    the card's SM count; ``geometry``: a conv call's (B, H, W)."""
    r = route(pt, kind, M, cuda=cuda)
    if r != "wgmma":
        return Plan(r)
    if kind == "conv":
        B, H, W = geometry if geometry is not None else (1, 1, M)
        return Plan("wgmma", block_p=_pc.conv_plan(B, H, W, pt.shape[0],
                                                   sms)[3])
    if pt.scheme == "tile_pattern":
        nb, Kp = pt.buf("lane_idx").shape[-2:]
        n_tiles = nb
    else:
        Kp, P = pt.buf("w_packed").shape[-2:]
        n_tiles = -(-P // 128)
    bm, _ = wgmma_plan(M, n_tiles, -(-Kp // BLOCK_K), sms)
    return Plan("wgmma", block_m=bm, grid="pm")


def candidate_plans(pt: PackedTensor, kind: str, M: int, *,
                    cuda: bool) -> List[Plan]:
    """The search space: the route the shapes give at M, re-tiled only in
    ways that keep each output element's sum (a plan never changes the
    route or a K split). wgmma GEMMs: ``block_m`` 64 or 128 x both grid
    orders; the wgmma conv: the channel tiles up to the one covering A x
    both grid orders; every other route, and the CPU, one candidate."""
    r = route(pt, kind, M, cuda=cuda)
    if r != "wgmma":
        return [Plan(r)]
    if kind == "conv":
        return [Plan("wgmma", block_p=bn, grid=go)
                for bn in _pc.channel_tiles(pt.shape[0]) for go in GRID_ORDERS]
    return [Plan("wgmma", block_m=bm, grid=go)
            for bm in BLOCK_MS for go in GRID_ORDERS]


def plan_knobs(kind: str, plan: Optional[Plan]) -> Dict[str, Any]:
    """The wrapper keywords a plan sets: none for the heuristic (None) or
    a route without knobs, so such a call launches exactly as untuned."""
    if plan is None or plan.impl != "wgmma":
        return {}
    if kind == "conv":
        return {"block_n": plan.block_p, "grid_order": plan.grid}
    return {"block_m": plan.block_m, "grid_order": plan.grid}


# ---------------------------------------------------------------------------
# resolve(): the registry's lookup chain
# ---------------------------------------------------------------------------

# in-process winners of first-dispatch searches (REPRO_AUTOTUNE=1), keyed
# by geometry; persisted plans (PackedTensor.meta) take precedence
_TUNED: Dict[Tuple, str] = {}


def autotune_enabled() -> bool:
    return os.environ.get("REPRO_AUTOTUNE", "0") not in ("", "0", "false")


def _tuned_key(pt: PackedTensor, kind: str, M: int, mode: str) -> Tuple:
    bufs = tuple((n, tuple(b.shape), str(b.dtype))
                 for n, b in zip(pt.names, pt.buffers))
    return (kind, pt.scheme, tuple(pt.shape), bufs,
            m_bucket(M, _small_m_of(pt)), mode)


def _meta_plan(pt: PackedTensor, kind: str, M: int,
               mode: str) -> Optional[Plan]:
    return plan_from_meta(pt, kind, M) if plan_mode(pt) == mode else None


def resolve(pt: PackedTensor, kind: str, M: int, *, mode: str,
            capturing: bool = False,
            geometry: Optional[Tuple[int, int, int]] = None
            ) -> Optional[Plan]:
    """Plan for one dispatch: meta (stamped for ``mode``) -> in-process
    cache -> optional search; None: the wrappers' heuristic applies.

    Never searches while a CUDA graph is being captured (``capturing``):
    the candidates' launches would land in the graph."""
    plan = _meta_plan(pt, kind, M, mode)
    if plan is not None:
        return plan
    key = _tuned_key(pt, kind, M, mode)
    s = _TUNED.get(key)
    if s is not None:
        return Plan.from_str(s)
    if not autotune_enabled() or capturing:
        return None
    plan, _ = tune_plan(pt, kind, M, geometry=geometry)
    if plan is not None:
        _TUNED[key] = plan.to_str()
    return plan


def clear_tuned_cache() -> None:
    _TUNED.clear()


def resolution_deferred(pt: PackedTensor, kind: str, M: int, mode: str,
                        capturing: bool) -> bool:
    """True when a first-dispatch search would run but cannot yet:
    autotune is on, nothing is tuned for this geometry, and the dispatch
    happens inside a capture. The caller must not memoize the heuristic
    then, so a later eager dispatch still gets to search."""
    if not (autotune_enabled() and capturing):
        return False
    if _meta_plan(pt, kind, M, mode) is not None:
        return False
    return _tuned_key(pt, kind, M, mode) not in _TUNED


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def _time_candidates(fns: Dict[str, Callable[[], Any]], iters: int,
                     cuda: bool) -> Dict[str, float]:
    """Median seconds per candidate, timed in interleaved rounds.

    Each candidate is warmed up first, each sample spans enough
    repetitions to clear the launch floor (about a millisecond), and every
    round cycles through all candidates before the next, so a load spike
    hits every candidate alike. On the card each sample is a CUDA event
    pair on the current stream, read once after the last round; on the
    CPU the host clock.
    """
    def one_call(fn) -> float:
        if not cuda:
            t0 = time.perf_counter()
            fn()
            return time.perf_counter() - t0
        s, e = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
        s.record()
        fn()
        e.record()
        e.synchronize()
        return s.elapsed_time(e) * 1e-3

    reps: Dict[str, int] = {}
    for name, fn in fns.items():
        fn()                                     # warm
        reps[name] = max(1, min(64, int(1e-3 / max(one_call(fn), 1e-6))))
    samples: Dict[str, list] = {n: [] for n in fns}
    pairs: List[Tuple[str, Any, Any]] = []
    for _ in range(max(iters, 1)):
        for name, fn in fns.items():
            if cuda:
                s, e = (torch.cuda.Event(enable_timing=True),
                        torch.cuda.Event(enable_timing=True))
                s.record()
                for _ in range(reps[name]):
                    fn()
                e.record()
                pairs.append((name, s, e))
            else:
                t0 = time.perf_counter()
                for _ in range(reps[name]):
                    fn()
                samples[name].append((time.perf_counter() - t0)
                                     / reps[name])
    if pairs:
        pairs[-1][2].synchronize()
        for name, s, e in pairs:
            samples[name].append(s.elapsed_time(e) * 1e-3 / reps[name])
    return {n: float(np.median(ts)) for n, ts in samples.items()}


def _stacked(pt: PackedTensor) -> int:
    """Leading layer axes of a leaf in the reference's stacked layout
    (``convert.tree_to_jax``); the port's own leaves have none."""
    canonical = {"tile_pattern": pt.canonical_w_ndim}.get(pt.scheme, 2)
    return pt.buf("w_packed").ndim - canonical


def canonical_slice(pt: PackedTensor) -> PackedTensor:
    """Layer 0 of a leaf in the reference's stacked layout (all its layers
    share one geometry); the port's per-layer leaves come back as they
    are."""
    n = _stacked(pt)
    if not n:
        return pt
    idx = (0,) * n
    return PackedTensor(pt.scheme, tuple(pt.shape[n:]), pt.names,
                        tuple(b[idx] for b in pt.buffers), pt.meta)


def tune_plan(pt: PackedTensor, kind: str, M: int, *, iters: int = 3,
              geometry: Optional[Tuple[int, int, int]] = None
              ) -> Tuple[Optional[Plan], Dict[str, float]]:
    """Time every candidate plan on the leaf's device; return (winner,
    per-plan median ms).

    Timing uses a bias- and activation-free call as the proxy for every
    epilogue of the bucket (the epilogue costs the same under every
    plan). A conv is timed on ``geometry`` (B, H, W), default one image
    row of M pixels. A candidate that fails to build or launch raises:
    nothing is skipped.
    """
    from repro_torch.sparse import registry as reg

    pt = canonical_slice(pt)
    dev = pt.buf("w_packed").device
    cuda = dev.type == "cuda"
    if cuda and torch.cuda.is_current_stream_capturing():
        raise RuntimeError("no plan search inside a CUDA graph capture")
    rng = np.random.default_rng(0)
    fns: Dict[str, Callable[[], Any]] = {}
    if kind == "conv":
        B, H, W = geometry if geometry is not None else (1, 1, M)
        x = torch.from_numpy(rng.standard_normal(
            (B, H, W, pt.shape[1]), dtype=np.float32)).to(dev, pt.dtype)
        w, taps = pt.buf("w_packed"), pt.buf("taps")
        for c in candidate_plans(pt, kind, B * H * W, cuda=cuda):
            fn = reg.conv_gemm_runner(pt, c)
            fn(x, w, taps)                                # builds + runs
            fns[c.to_str()] = (lambda fn=fn: fn(x, w, taps))
    else:
        handler = reg.SCHEMES[pt.scheme]
        x = torch.from_numpy(rng.standard_normal(
            (M, pt.shape[-2]), dtype=np.float32)).to(dev, pt.dtype)
        for c in candidate_plans(pt, kind, M, cuda=cuda):
            fn = handler.plan(pt, M, None, c)
            fn(x, pt, None)
            fns[c.to_str()] = (lambda fn=fn: fn(x, pt, None))
    with get_registry().timer("tune.search_seconds", kind=kind,
                              scheme=pt.scheme):
        timed = _time_candidates(fns, iters, cuda)
    get_registry().counter("tune.candidates_total", kind=kind,
                           scheme=pt.scheme).inc(len(fns))
    report: Dict[str, float] = {}
    best: Optional[Plan] = None
    best_t = float("inf")
    for name, t in timed.items():
        report[name] = round(t * 1e3, 4)
        if t < best_t:
            best, best_t = Plan.from_str(name), t
    return best, report


# ---------------------------------------------------------------------------
# tree-level tuning (the pack-time entry point)
# ---------------------------------------------------------------------------

def tune_packed_tree(tree: Any, ms: Iterable[int], *, iters: int = 3
                     ) -> Tuple[Any, Dict[str, Any]]:
    """Tune every packed leaf for the given M values; bake plans into meta.

    ``ms`` are GEMM row counts to serve (decode: batch; prefill: batch x
    prompt; conv: batch x H x W), deduplicated by bucket. Each geometry
    (kind, scheme, buffer shapes and dtypes, bucket, device) is searched
    once and its winner written into every leaf of that geometry, so a
    28-layer model's layers share their searches. Returns (new tree,
    report); the report maps ``<leaf path>:<meta key>`` to the winning
    plan and the per-candidate times.
    """
    ms = tuple(int(m) for m in ms)
    report: Dict[str, Any] = {}
    searched: Dict[Tuple, Tuple[Optional[Plan], Dict[str, float]]] = {}

    def leaf(path: str, x):
        if not is_packed(x):
            return x
        kind = _kind_of(x)
        if kind is None:
            return x
        mode = device_mode(x.buf("w_packed").device)
        small = _small_m_of(x)
        meta = list(x.meta)
        seen = set()
        wrote = False
        for M in ms:
            bucket = m_bucket(M, small)
            if M <= 0 or bucket in seen:
                continue
            seen.add(bucket)
            key = _tuned_key(x, kind, M, mode)
            if key not in searched:
                searched[key] = tune_plan(x, kind, M, iters=iters)
            plan, times = searched[key]
            if plan is None:
                continue
            mkey = plan_meta_key(kind, bucket)
            meta = [kv for kv in meta if kv[0] != mkey]
            meta.append((mkey, plan.to_str()))
            wrote = True
            report[f"{path}:{mkey}"] = {"plan": plan.to_str(),
                                        "candidates_ms": times}
        if not wrote:
            return x
        meta = [kv for kv in meta if kv[0] != MODE_KEY] + [(MODE_KEY, mode)]
        return dataclasses.replace(x, meta=tuple(meta))

    return tree_map_with_path(leaf, tree), report


def describe_plans(tree: Any) -> Dict[str, Dict[str, str]]:
    """Per-leaf persisted plan table (for reporting)."""
    return {path: plans_in_meta(x) for path, x in tree_items(tree)
            if is_packed(x) and plans_in_meta(x)}
