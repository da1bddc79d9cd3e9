"""Logical-axis sharding rules on ``torch.distributed`` (mirrors
``repro/parallel/sharding.py``).

Models annotate tensors with LOGICAL axis names ("batch", "embed", "mlp",
"heads", "kv", "vocab", "experts", "layers", ...). A set of ``AxisRules``
maps logical names to mesh axes. The same model code then runs on the
single-pod (data, model) mesh, the multi-pod (pod, data, model) mesh, or
un-meshed (where ``constrain`` is a no-op and no tensor is a DTensor).

``AxisRules.spec`` returns the reference's ``PartitionSpec`` as a plain
tuple: one entry per tensor dim, ``None`` (replicated), a mesh-axis name
or a tuple of them. ``placements`` turns that tuple into one DTensor
``Placement`` per mesh dim; a ``DeviceMesh`` stands in for the
reference's ``jax.sharding.Mesh``, and ``constrain`` is an explicit
``redistribute`` where the reference hints GSPMD.

Parameter-sharding policy (the reference's):
  * output-feature dims ("heads", "mlp", "vocab", "expert_mlp") -> "model"
  * input-feature dim "embed" -> "data" (FSDP / ZeRO-3 style) when divisible
  * "batch" -> ("pod", "data"): pod is just more data parallelism
  * "layers" / "experts" -> replicated
  * long-context decode KV "kvseq" -> "data" (sequence parallelism)
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

_STATE = threading.local()

Spec = Tuple[Any, ...]


def mesh_axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: extent} of a ``DeviceMesh`` (or of any object with
    ``mesh_dim_names`` and a ``shape`` tuple, such as a stand-in for a
    mesh too large to build)."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


@dataclasses.dataclass(frozen=True)
class AxisRules:
    """Mapping logical axis name -> mesh axis (or tuple of mesh axes)."""

    rules: Tuple[Tuple[str, Any], ...]
    mesh: Any = None

    def lookup(self, name: Optional[str]):
        if name is None:
            return None
        for k, v in self.rules:
            if k == name:
                return v
        return None

    def _axis_size(self, name: str) -> int:
        if self.mesh is None:
            return 1
        return mesh_axis_sizes(self.mesh)[name]

    def spec(self, logical: Sequence[Optional[str]],
             shape: Optional[Sequence[int]] = None) -> Spec:
        """Per-dim mesh axes of a tuple of logical axis names (None =
        replicated), the reference's ``PartitionSpec`` entries.

        A mesh axis may be consumed at most once; later duplicates degrade
        to replicated. With ``shape``, a dim not divisible by its mesh-axis
        extent drops trailing axes until it divides, and is replicated if
        none are left (batch=1 long-context decode, kv_heads < TP).
        """
        used = set()
        out: List[Any] = []
        for i, name in enumerate(logical):
            ax = self.lookup(name)
            if ax is None:
                out.append(None)
                continue
            axes = ax if isinstance(ax, tuple) else (ax,)
            free = tuple(a for a in axes if a not in used)
            if shape is not None and free:
                ext = 1
                for a in free:
                    ext *= self._axis_size(a)
                while free and shape[i] % ext != 0:
                    free = free[:-1]
                    ext = 1
                    for a in free:
                        ext *= self._axis_size(a)
            if not free:
                out.append(None)
                continue
            used.update(free)
            out.append(free if len(free) > 1 else free[0])
        return tuple(out)


def default_rules(mesh, *, fsdp: bool = True) -> AxisRules:
    """Production rules for the (pod,)data,model meshes."""
    names = tuple(mesh.mesh_dim_names)
    batch_axes: Any = ("pod", "data") if "pod" in names else ("data",)
    rules = [
        ("batch", batch_axes),
        ("heads", "model"),
        ("kv_heads", "model"),
        ("kv_dim", "model"),    # fallback when kv_heads < TP degree
        ("mlp", "model"),
        ("vocab", "model"),
        ("expert_mlp", "model"),
        ("kvseq", "data"),      # sequence-sharded KV cache (long-context decode)
        ("act_seq", "model"),   # Megatron-SP: residual stream S-sharded on TP
        ("act_model", "model"), # SSM residual stream: feature dim on TP
        ("head_dim", "model"),  # fallback when heads % TP != 0
        # attention batch sharding over ALL axes (incl. model) — used when
        # heads don't divide the TP degree: each device owns whole heads for
        # a batch slice, so attention runs collective-free internally.
        ("attn_batch", (("pod", "data", "model")
                        if "pod" in names else ("data", "model"))),
        ("embed", "data" if fsdp else None),
    ]
    return AxisRules(rules=tuple(rules), mesh=mesh)


@contextlib.contextmanager
def axis_rules(rules: Optional[AxisRules]):
    prev = getattr(_STATE, "rules", None)
    _STATE.rules = rules
    try:
        yield
    finally:
        _STATE.rules = prev


def current_rules() -> Optional[AxisRules]:
    return getattr(_STATE, "rules", None)


def active_mesh():
    """The mesh of the active rules, or None (un-meshed)."""
    rules = current_rules()
    return None if rules is None else rules.mesh


def placements(spec: Spec, mesh) -> tuple:
    """One DTensor ``Placement`` per mesh dim for a per-tensor-dim
    ``spec``: ``Shard(d)`` on every mesh axis that dim d is split over,
    ``Replicate()`` on the others. A dim split over several axes splits
    in the spec's order, the first axis outermost (row-major, as a
    ``PartitionSpec`` does): DTensor shards a dim over mesh dims in mesh
    order, so the spec's axes must follow the mesh's order. An axis of
    extent 1 is ``Replicate()``: a one-card mesh runs every op locally,
    as the un-meshed path does."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    sizes = tuple(mesh.shape)
    out: List[Any] = [Replicate() for _ in names]
    for d, ax in enumerate(spec):
        if ax is None:
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(
                f"dim {d} is split over {axes}, not in the mesh's order "
                f"{tuple(names)}: DTensor cannot split it so")
        for i in idx:
            # an axis of extent 1 splits nothing: every rank holds it whole
            if sizes[i] > 1:
                out[i] = Shard(d)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh and one placement per mesh dim: where a DTensor lives (the
    counterpart of ``jax.sharding.NamedSharding``)."""

    mesh: Any
    placements: tuple


def logical_placements(rules: AxisRules, logical: Sequence[Optional[str]],
                       shape: Optional[Sequence[int]] = None) -> tuple:
    """``placements`` of the spec of ``logical`` (shape-aware with
    ``shape``)."""
    return placements(rules.spec(logical, shape), rules.mesh)


def logical_sharding(rules: AxisRules, logical: Sequence[Optional[str]],
                     shape: Optional[Sequence[int]] = None) -> NamedSharding:
    return NamedSharding(rules.mesh, logical_placements(rules, logical,
                                                        shape))


def batch_spec(rules: AxisRules, ndim: int, *, batch_dim: int = 0,
               shape: Optional[Sequence[int]] = None) -> NamedSharding:
    """Sharding of a data tensor: the batch dim sharded, the rest
    replicated."""
    logical: list = [None] * ndim
    logical[batch_dim] = "batch"
    return logical_sharding(rules, logical, shape)


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(n is None or isinstance(n, str)
                                        for n in x)


def param_shardings(rules: AxisRules, logical_tree: Any,
                    shape_tree: Any = None) -> Any:
    """Map a tree of logical-axis tuples to ``NamedSharding``s.

    With ``shape_tree`` (a congruent tree of tensors or shapes) the specs
    are shape-aware: non-divisible dims (granite's 49155 vocab on a
    16-way model axis) degrade to replicated instead of failing.
    """
    def walk(axes, shp):
        if _is_axes(axes):
            if shp is None:
                return logical_sharding(rules, axes)
            size = shp if isinstance(shp, (tuple, torch.Size)) else shp.shape
            return logical_sharding(rules, axes, tuple(size))
        if isinstance(axes, dict):
            return {k: walk(v, None if shp is None else shp[k])
                    for k, v in axes.items()}
        return [walk(v, None if shp is None else shp[i])
                for i, v in enumerate(axes)]

    return walk(logical_tree, shape_tree)


# ---------------------------------------------------------------------------
# DTensor plumbing
# ---------------------------------------------------------------------------

def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def replicate(x: torch.Tensor, like=None) -> torch.Tensor:
    """``x`` (a plain tensor that every rank holds whole) as a replicated
    DTensor on the active mesh (or on ``like``'s, a DTensor); unchanged
    when no mesh is active or ``x`` is a DTensor already."""
    mesh = like.device_mesh if like is not None and is_dtensor(like) \
        else active_mesh()
    if mesh is None or is_dtensor(x):
        return x
    from torch.distributed.tensor import DTensor, Replicate

    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def constrain(x: torch.Tensor, logical: Sequence[Optional[str]]
              ) -> torch.Tensor:
    """Redistribute ``x`` to the placements of ``logical`` if rules are
    active and ``x`` is a DTensor; else a no-op.

    Models call this on activations at the few points where the
    reference hints GSPMD (post-projection, post-block); everywhere else
    DTensor's sharding propagation decides. Shape-aware: non-divisible
    dims degrade to replicated.
    """
    rules = current_rules()
    if rules is None or rules.mesh is None or not is_dtensor(x):
        return x
    want = logical_placements(rules, logical, tuple(x.shape))
    if tuple(x.placements) == want:
        return x
    return x.redistribute(rules.mesh, want)


def shard(x: torch.Tensor, sharding: Optional[NamedSharding]) -> Any:
    """A DTensor of ``x`` (whole on every rank) with ``sharding``: each
    rank keeps its own shard, with no communication. ``sharding`` None
    leaves ``x`` as it is."""
    if sharding is None or x is None or is_dtensor(x):
        return x
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(x, sharding.mesh, list(sharding.placements),
                             src_data_rank=None)


def shard_tree(tree: Any, shardings: Any) -> Any:
    """``shard`` at every leaf of ``tree`` (``shardings`` congruent; a
    None subtree shards nothing beneath it). Containers keep their types,
    an optimizer's NamedTuple state included."""
    if isinstance(tree, dict):
        return {k: shard_tree(v, None if shardings is None else shardings[k])
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        seq = [shard_tree(v, None if shardings is None else shardings[i])
               for i, v in enumerate(tree)]
        if hasattr(tree, "_fields"):
            return type(tree)(*seq)
        return type(tree)(seq)
    return shard(tree, shardings)


def shardings_of(tree: Any) -> Any:
    """The ``NamedSharding`` of every DTensor leaf of ``tree`` (None at
    any other leaf)."""
    from repro_torch.utils.tree import tree_map

    return tree_map(lambda x: NamedSharding(x.device_mesh,
                                            tuple(x.placements))
                    if is_dtensor(x) else None, tree)


def like(g: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """``g`` redistributed to DTensor ``ref``'s placements (a gradient's
    pending reductions done: the data-parallel all-reduce or
    reduce-scatter); ``g`` as it is when either is a plain tensor."""
    if not (is_dtensor(g) and is_dtensor(ref)):
        return g
    if tuple(g.placements) == tuple(ref.placements):
        return g
    return g.redistribute(ref.device_mesh, ref.placements)


def sharded_dims(x) -> set:
    """Tensor dims of DTensor ``x`` split over some mesh axis (none for a
    plain tensor)."""
    if not is_dtensor(x):
        return set()
    return {p.dim % x.ndim for p in x.placements if p.is_shard()}


def split_dim(x: torch.Tensor, dim: int, sizes: Sequence[int]
              ) -> torch.Tensor:
    """``x`` with dim ``dim`` reshaped to ``sizes``. A DTensor split over
    some mesh axes along ``dim`` is gathered along it first unless the
    split falls on whole entries of the outer new dim (heads of a
    (B, S, H * hd) projection on a model axis that H does not divide)."""
    if dim in sharded_dims(x):
        ext = 1
        for p, n in zip(x.placements, x.device_mesh.shape):
            if p.is_shard(dim):
                ext *= n
        if sizes[0] % ext:
            x = _unshard(x, dim)
    return x.unflatten(dim, tuple(sizes))


def _unshard(x: torch.Tensor, dim: int) -> torch.Tensor:
    from torch.distributed.tensor import Replicate

    return x.redistribute(x.device_mesh, [
        Replicate() if p.is_shard(dim) else p for p in x.placements])


class _MergeDims(torch.autograd.Function):
    """``flatten(dim, dim + 1)`` of a DTensor whose gradient splits back
    through ``split_dim`` (DTensor's own view backward cannot split a
    merged dim whose shards do not fall on whole outer entries)."""

    @staticmethod
    def forward(ctx, x, dim):
        ctx.dim, ctx.sizes = dim, tuple(x.shape[dim:dim + 2])
        if dim + 1 in sharded_dims(x):
            x = _unshard(x, dim + 1)
        return x.flatten(dim, dim + 1)

    @staticmethod
    def backward(ctx, g):
        return split_dim(g, ctx.dim, ctx.sizes), None


def merge_dims(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` with dims ``dim`` and ``dim + 1`` merged (heads and head dim
    of an attention output): a plain reshape, or on a DTensor one that
    gathers a split inner dim first and differentiates through
    ``split_dim``."""
    if not is_dtensor(x):
        return x.reshape(x.shape[:dim] + (-1,) + x.shape[dim + 2:])
    return _MergeDims.apply(x, dim)


def local_rows(x: torch.Tensor, dim: int = 0) -> slice:
    """The slice of ``x``'s global dim ``dim`` this rank holds (all of it
    for a plain tensor)."""
    if not is_dtensor(x):
        return slice(0, x.shape[dim])
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset,
    )

    shape, offset = compute_local_shape_and_global_offset(
        x.shape, x.device_mesh, x.placements)
    return slice(offset[dim], offset[dim] + shape[dim])


def local_elementwise(fn, *args):
    """``fn(*args)`` for an elementwise ``fn`` outside autograd: when the
    DTensor args share one shape and one placement (0-d replicated ones
    aside), ``fn`` runs on their local shards and the result is a DTensor
    of that placement (no per-op sharding propagation, no communication;
    on a one-card mesh the very same ops as on plain tensors). Otherwise,
    or with no DTensor arg, ``fn(*args)`` as it is."""
    ds = [a for a in args if is_dtensor(a) and a.ndim]
    if not ds:
        return fn(*args)
    ref = ds[0]
    if any(tuple(d.placements) != tuple(ref.placements)
           or d.shape != ref.shape for d in ds) or any(
               p.is_partial() for p in ref.placements):
        return fn(*args)
    if any(is_dtensor(a) and not a.ndim and not all(
            p.is_replicate() for p in a.placements) for a in args):
        return fn(*args)
    from torch.distributed.tensor import DTensor

    out = fn(*[a.to_local() if is_dtensor(a) else a for a in args])
    return DTensor.from_local(out, ref.device_mesh, ref.placements,
                              run_check=False, shape=ref.shape,
                              stride=ref.stride())


def gather_full(x):
    """``x`` whole: a DTensor's ``full_tensor()``, any other leaf as it is."""
    return x.full_tensor() if is_dtensor(x) else x


def local_call(fn, ins: Sequence[Tuple[Any, Sequence[Optional[str]]]],
               outs: Sequence[tuple]):
    """``fn(*tensors)`` of ``ins`` (pairs of a tensor and its logical
    axes), on each rank's local shards through ``local_map`` when some
    input is a DTensor: the inputs are placed by their axes (shape-aware:
    a dim the mesh axis does not divide is whole on every rank) and the
    outputs, (logical axes, global shape) per output in ``outs``, are
    DTensors so placed; a third entry, a logical name, marks an output
    as each rank's partial sum over that name's mesh axes (a contraction
    over a split dim). Without a DTensor input, ``fn`` as it is, so a
    one-card mesh runs the very ops of no mesh.

    The core must be row-wise over the axes its outputs are split (or
    summed) on; the gradient of an input that is whole on such an axis
    (a weight, or features every row reads) is the partial sum of each
    rank's rows there."""
    tensors = [x for x, _ in ins]
    if not any(is_dtensor(x) for x in tensors):
        return fn(*tensors)
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map

    rules = current_rules()
    ref = next(x for x in tensors if is_dtensor(x))
    mesh = ref.device_mesh
    in_pl = [logical_placements(rules, ax, tuple(x.shape)) for x, ax in ins]
    out_pl = [_out_placements(rules, *out) for out in outs]
    split = [any(not pl[i].is_replicate() for pl in out_pl)
             for i in range(mesh.ndim)]
    grad_pl = [tuple(Partial() if p.is_replicate() and split[i] else p
                     for i, p in enumerate(pl)) for pl in in_pl]
    return local_map(fn, out_placements=tuple(out_pl) if len(outs) > 1
                     else list(out_pl[0]),
                     in_placements=in_pl,
                     in_grad_placements=grad_pl, device_mesh=mesh,
                     redistribute_inputs=True)(
                         *[replicate(x, like=ref) for x in tensors])


def _out_placements(rules: AxisRules, logical, shape,
                    partial: Optional[str] = None) -> tuple:
    """An output's placements: its logical axes', with ``Partial()`` on
    the mesh axes of ``partial`` (extent > 1)."""
    from torch.distributed.tensor import Partial

    pl = list(logical_placements(rules, logical, tuple(shape)))
    ax = rules.lookup(partial)
    names = list(rules.mesh.mesh_dim_names)
    for a in () if ax is None else (ax if isinstance(ax, tuple) else (ax,)):
        i = names.index(a)
        if rules.mesh.shape[i] > 1:
            pl[i] = Partial()
    return tuple(pl)


def write_local(dst: torch.Tensor, src: torch.Tensor,
                at: Tuple[int, ...] = ()) -> None:
    """``dst[at].copy_(src)`` IN PLACE on each rank's own shard: ``src``
    placed as ``dst`` is (the leading dims ``at`` indexes are whole on
    every rank), so no rank writes another's rows."""
    if not is_dtensor(dst):
        dst[at].copy_(src)
        return
    from torch.distributed.tensor import Shard

    n = len(at)
    want = [Shard(p.dim - n) if p.is_shard() else p for p in dst.placements]
    if any(p.is_shard() and p.dim < n for p in dst.placements):
        raise ValueError("write_local indexes a split dim")
    src = replicate(src, like=dst)
    if tuple(src.placements) != tuple(want):
        src = src.redistribute(dst.device_mesh, want)
    dst.to_local()[at].copy_(src.to_local())
