"""Per-device cost analysis of one traced step (the counterpart of
``repro/roofline/hlo_costs.py::analyze_hlo``, which parses XLA's HLO: the
port has no HLO, so it records the ops themselves as they dispatch).

``StepCostMode`` is a ``TorchDispatchMode``. Inside it, one step of the
program runs on one rank (on the meta device and the fake process group
for a dry-run, on real tensors anywhere else) and every aten op that
reaches a tensor is recorded:

  * FLOPs by ``torch.utils.flop_counter``'s formulas (the matmuls,
    convolutions and attention ops it knows; elementwise ops count none);
  * bytes: each op's operand bytes plus its output bytes (views, which
    move nothing, count none);
  * collective bytes by type, the reference's convention: the OUTPUT
    bytes of each all-gather / all-reduce / reduce-scatter / all-to-all,
    taken from the ``_c10d_functional`` ops DTensor issues;
  * the peak of the bytes that the step's own op outputs hold alive
    (``peak_bytes``: the step's temporaries, its inputs excluded).

A DTensor op is let through (``NotImplemented``) so that DTensor runs it
and the mode records the local ops it issues: every number is PER
DEVICE (rank 0's shard), as the reference's are. The fake tensors
DTensor uses for its sharding propagation are not recorded. On a CPU
mesh DTensor emulates an all-to-all by an all-gather and a chunk; the
mode counts what the step asks for, one all-to-all of the output's
bytes (``_count_alltoall``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import weakref
from typing import Any, Callable, Dict, Iterator, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.roofline.costs import Costs

COLLECTIVE_OPS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
}

# ops that move no bytes: views, metadata and the collectives' bookkeeping
_FREE_OPS = {
    "view", "_unsafe_view", "reshape", "t", "transpose", "permute",
    "expand", "slice", "select", "as_strided", "unsqueeze", "squeeze",
    "alias", "detach", "unflatten", "split", "split_with_sizes", "chunk",
    "unbind", "view_as", "_reshape_alias", "diagonal", "narrow",
    "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
    "wait_tensor", "_wrap_tensor_autograd", "lift_fresh",
    "_local_scalar_dense", "sym_size", "sym_stride", "sym_numel",
    "is_same_size", "_to_copy_meta", "set_", "resize_",
}

_SCOPE = threading.local()


@contextlib.contextmanager
def cost_scope(name: str) -> Iterator[None]:
    """Label the ops recorded inside (``OpStat.where``), e.g. the
    attention core; free when no ``StepCostMode`` runs."""
    stack = getattr(_SCOPE, "stack", None)
    if stack is None:
        stack = _SCOPE.stack = []
    stack.append(name)
    try:
        yield
    finally:
        stack.pop()


# the handler of ``replayable`` regions while ``replay_regions`` is open
_REPLAYER: Optional[Callable[..., Any]] = None


def replayable(scope: str, fn: Callable[..., Any], *args, **kwargs):
    """``fn(*args, **kwargs)``, a region a step repeats at one shape (an
    attention tile or call, a recurrent cell's scan chunk, the MoE's
    routing). Under ``replay_regions`` the call goes to its handler,
    which may trace it once per shapes and replay it after (the
    dry-run's ``_Replay``); else ``fn`` runs as it is."""
    if _REPLAYER is None:
        return fn(*args, **kwargs)
    return _REPLAYER(scope, fn, args, kwargs)


@contextlib.contextmanager
def replay_regions(handler: Callable[..., Any]) -> Iterator[None]:
    """While open, every ``replayable`` call is
    ``handler(scope, fn, args, kwargs)``."""
    global _REPLAYER
    prev, _REPLAYER = _REPLAYER, handler
    try:
        yield
    finally:
        _REPLAYER = prev


def _where() -> str:
    stack = getattr(_SCOPE, "stack", None)
    return stack[-1] if stack else ""


@dataclasses.dataclass
class OpStat:
    """One (op, where) row: how often it ran and what it cost."""

    op: str
    kind: str                    # "collective" | "compute"
    where: str = ""
    count: int = 0
    flops: float = 0.0
    bytes: float = 0.0


def _tensors(tree: Any) -> List[torch.Tensor]:
    """The tensors of an op's arguments or outputs (nested lists, tuples
    and dicts)."""
    out: List[torch.Tensor] = []
    stack = [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
        elif isinstance(x, dict):
            stack.extend(x.values())
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _is_fake(t: torch.Tensor) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor

    return isinstance(t, FakeTensor)


class StepCostMode(TorchDispatchMode):
    """Records the per-device costs of what runs inside it (see the
    module docstring). ``costs`` (a ``roofline.costs.Costs``),
    ``peak_bytes`` and ``ops`` (``OpStat`` rows by (op, where)) are read
    after the ``with`` block."""

    def __init__(self, device: Optional[str] = None):
        super().__init__()
        self.device = device
        self.costs = Costs()
        self.ops: Dict[tuple, OpStat] = {}
        self.live = 0
        self.peak_bytes = 0
        self._quiet = 0
        from torch.utils.flop_counter import flop_registry

        self._flops = flop_registry

    # -- recording ------------------------------------------------------

    def _stat(self, op: str, kind: str) -> OpStat:
        key = (op, kind, _where())
        if key not in self.ops:
            self.ops[key] = OpStat(op, kind, key[2])
        return self.ops[key]

    def record_collective(self, kind: str, out_bytes: float,
                          op: str) -> None:
        self.costs.collective_bytes[kind] += out_bytes
        st = self._stat(op, "collective")
        st.count += 1
        st.bytes += out_bytes

    def _track(self, out: Any) -> None:
        """Count each new output's bytes alive until it is freed."""
        for t in _tensors(out):
            n = _nbytes(t)
            if not n:
                continue
            self.live += n
            self.peak_bytes = max(self.peak_bytes, self.live)
            weakref.finalize(t, self._free, n)

    def _free(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented           # DTensor issues the local ops
        out = func(*args, **kwargs)
        ins = list(_tensors((args, kwargs)))
        if self._quiet or any(_is_fake(t) for t in ins):
            return out
        if self.device is not None and not any(
                t.device.type == self.device for t in ins + _tensors(out)):
            return out        # host bookkeeping beside a step on the device
        name = func.overloadpacket.__name__
        kind = COLLECTIVE_OPS.get(name)
        if kind is not None:
            self.record_collective(kind, sum(_nbytes(t)
                                             for t in _tensors(out)), name)
            self._track(out)
            return out
        if name in _FREE_OPS:
            return out
        flops = 0.0
        f = self._flops.get(func.overloadpacket)
        if f is not None:
            flops = float(f(*args, **kwargs, out_val=out))
        moved = sum(_nbytes(t) for t in ins) + sum(
            _nbytes(t) for t in _tensors(out))
        self.costs.flops += flops
        self.costs.bytes += moved
        st = self._stat(name, "compute")
        st.count += 1
        st.flops += flops
        st.bytes += moved
        self._track(out)
        return out

    @property
    def quiet(self) -> bool:
        """Inside ``quiet_scope``: nothing is recorded."""
        return self._quiet > 0

    @contextlib.contextmanager
    def quiet_scope(self) -> Iterator[None]:
        """Ops run inside are not recorded (a recompute that the real
        program would not run)."""
        self._quiet += 1
        try:
            yield
        finally:
            self._quiet -= 1

    # -- replay (one traced copy of a repeated region) -------------------

    def snapshot(self) -> Dict[str, Any]:
        return {"costs": self.costs.scaled(1.0), "live": self.live,
                "peak": self.peak_bytes,
                "ops": {k: dataclasses.replace(v) for k, v in
                        self.ops.items()}}

    def delta(self, snap: Dict[str, Any]) -> Dict[str, Any]:
        """What ran since ``snap``: its costs, its op rows and how far the
        live bytes rose above their level at ``snap``."""
        before = snap["costs"]
        d = Costs(flops=self.costs.flops - before.flops,
                  bytes=self.costs.bytes - before.bytes,
                  collective_bytes={k: self.costs.collective_bytes[k] -
                                    before.collective_bytes[k]
                                    for k in before.collective_bytes})
        rows = []
        for k, v in self.ops.items():
            old = snap["ops"].get(k)
            c = v.count - (old.count if old else 0)
            if c:
                rows.append(OpStat(v.op, v.kind, v.where, c,
                                   v.flops - (old.flops if old else 0.0),
                                   v.bytes - (old.bytes if old else 0.0)))
        rise = (self.peak_bytes - snap["live"]
                if self.peak_bytes > snap["peak"] else 0)
        return {"costs": d, "ops": rows, "rise": rise,
                "kept": self.live - snap["live"]}

    def replay(self, delta: Dict[str, Any], holder: Any = None,
               outputs: Any = ()) -> None:
        """Add a region's recorded ``delta`` as if it ran again now: its
        costs, its op rows, its peak above the live bytes of now, and the
        bytes it left alive (``kept``): each of ``outputs`` (the replayed
        region's outputs) held until it is freed when they are what it
        left, else all held until ``holder`` is freed."""
        if self.quiet:
            return
        self.costs.add(delta["costs"])
        for r in delta["ops"]:
            st = self.ops.setdefault((r.op, r.kind, r.where),
                                     OpStat(r.op, r.kind, r.where))
            st.count += r.count
            st.flops += r.flops
            st.bytes += r.bytes
        self.peak_bytes = max(self.peak_bytes, self.live + delta["rise"])
        if outputs and delta["kept"] == sum(_nbytes(t) for t in outputs):
            self._track(outputs)
        elif holder is not None and delta["kept"] > 0:
            self.live += delta["kept"]
            weakref.finalize(holder, self._free, delta["kept"])


@contextlib.contextmanager
def _count_alltoall(mode: StepCostMode) -> Iterator[None]:
    """While open, DTensor's all-to-all (``shard_dim_alltoall``, which a
    CPU mesh emulates by an all-gather and a chunk) is recorded as ONE
    all-to-all of its output's bytes, and the ops of its emulation not
    at all."""
    import importlib

    sites = []
    for name in ("torch.distributed.tensor._collective_utils",
                 "torch.distributed.tensor.placement_types",
                 "torch.distributed.tensor._redistribute"):
        try:
            mod = importlib.import_module(name)
        except ImportError:
            continue
        if hasattr(mod, "shard_dim_alltoall"):
            sites.append((mod, mod.shard_dim_alltoall))

    def counted(orig):
        def shard_dim_alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
            if input.is_meta:
                # nothing to move: rank 0's output shape, as the chunk
                # of the gathered tensor gives it
                n = mesh.size(mesh_dim)
                shape = list(input.shape)
                shape[gather_dim] *= n
                shape[shard_dim] = -(-shape[shard_dim] // n)
                out = input.new_empty(shape)
            else:
                with mode.quiet_scope():
                    out = orig(input, gather_dim, shard_dim, mesh, mesh_dim)
            mode.record_collective("all-to-all", _nbytes(out),
                                   "shard_dim_alltoall")
            return out
        return shard_dim_alltoall

    for mod, orig in sites:
        mod.shard_dim_alltoall = counted(orig)
    try:
        yield
    finally:
        for mod, orig in sites:
            mod.shard_dim_alltoall = orig


@contextlib.contextmanager
def record_step(device: Optional[str] = None) -> Iterator[StepCostMode]:
    """``with record_step() as rec: <one step>``, then read ``rec.costs``,
    ``rec.peak_bytes`` and ``rec.ops``. With ``device`` (a device type)
    an op none of whose tensors is on it is not recorded: the host's
    bookkeeping (DTensor's sharding propagation computes shard offsets
    with small CPU tensors, more or fewer as its caches are cold or
    warm) beside a step traced on that device."""
    mode = StepCostMode(device)
    with _count_alltoall(mode), mode:
        yield mode


def rank_step_hotspots(ops: Any, top: int = 12) -> Dict[str, Any]:
    """Collective and memory-op rankings of a recorded step (the
    counterpart of the reference's ``rank_hlo_hotspots``, which reads an
    HLO dump).

    ``ops``: a ``StepCostMode`` or its ``ops`` rows (``OpStat`` or their
    dicts, as a dry-run record keeps them). Returns ``collectives`` and
    ``memory_ops`` rows sorted by bytes, the bytes of the attention core
    (the part a fused flash kernel keeps on chip) and the total op bytes.
    """
    rows = ops.ops.values() if isinstance(ops, StepCostMode) else ops
    rows = [dataclasses.asdict(r) if isinstance(r, OpStat) else dict(r)
            for r in rows]
    coll = sorted((r for r in rows if r["kind"] == "collective"),
                  key=lambda r: r["bytes"], reverse=True)
    mem = sorted((r for r in rows if r["kind"] != "collective"
                  and r["bytes"] > 0),
                 key=lambda r: r["bytes"], reverse=True)
    total = sum(r["bytes"] for r in mem)
    attn = sum(r["bytes"] for r in mem if r["where"] == "attention")
    return {
        "collectives": coll[:top],
        "memory_ops": mem[:top],
        "attention_internal_bytes": attn,
        "instruction_bytes_total": total,
    }


def op_rows(mode: StepCostMode) -> List[Dict[str, Any]]:
    """The mode's ``OpStat`` rows as plain dicts (for a JSON record)."""
    return [dataclasses.asdict(r) for r in mode.ops.values()]
