"""The port's logical-axis sharding rules against the reference's, on the
same inputs (``repro.parallel.sharding`` and friends): ``AxisRules.spec``
and ``default_rules`` on stand-in meshes (16×16, 2×16×16, 2×2, 1×4; no
devices needed, rule logic is device-count agnostic), ``placements`` of a
two-axis batch dim (rank by rank on a fake 2×2×2 group: row-major, as a
``PartitionSpec`` splits it), ``param_logical_axes`` and
``cache_logical_axes`` (the reference's stacked "layers" lead stripped),
``_expand_heads_for_tp`` on the same numpy q/k/v, ``replan_mesh``,
``skip_reason`` / ``applicable_shapes`` and ``input_specs``' shapes and
dtypes for every arch and shape.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import get_config as ref_get_config
from repro.configs import reduced_config as ref_reduced_config
from repro.configs.base import SHAPES as REF_SHAPES
from repro.configs.shapes import applicable_shapes as ref_applicable
from repro.configs.shapes import input_specs as ref_input_specs
from repro.configs.shapes import skip_reason as ref_skip_reason
from repro.models import build_model as ref_build_model
from repro.parallel import sharding as ref_sh
from repro.runtime.elastic import replan_mesh as ref_replan
from repro.utils.tree import tree_paths

from repro_torch.configs import ARCHS, get_config, reduced_config
from repro_torch.configs.base import SHAPES
from repro_torch.configs.shapes import applicable_shapes, input_specs
from repro_torch.configs.shapes import skip_reason
from repro_torch.models import build_model
from repro_torch.parallel import sharding as sh
from repro_torch.runtime.elastic import replan_mesh
from repro_torch.utils.tree import tree_items

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "1x4": ((1, 4), ("data", "model"))}


class RefMesh:
    """The reference's mesh interface: ``axis_names``, ``shape`` by name."""

    def __init__(self, shape, names):
        self.axis_names = names
        self.shape = dict(zip(names, shape))


class PortMesh:
    """The port's: ``mesh_dim_names``, ``shape`` tuple, ``ndim``."""

    def __init__(self, shape, names):
        self.mesh_dim_names = names
        self.shape = shape
        self.ndim = len(shape)


def rules_pair(name):
    shape, names = MESHES[name]
    return (ref_sh.default_rules(RefMesh(shape, names)),
            sh.default_rules(PortMesh(shape, names)))


LOGICALS = [("batch", None, "mlp"), ("heads", "mlp"), ("batch", None),
            ("batch", None, "kv_heads", "kv_dim"), ("vocab", "embed"),
            ("embed", "vocab"), ("attn_batch", None, None, None),
            ("batch", "act_seq", None), ("batch", None, "act_model"),
            ("layers", "experts", "embed", "expert_mlp"), ("kvseq", None),
            ("batch", None, "heads", None), (None, None)]
SHAPES_FOR = [None, (1, 7), (256, 4096, 1536), (32, 32768, 2, 128),
              (128, 1, 12, 128), (151936, 1536), (49155, 2048),
              (1, 524288, 5, 64), (8, 16, 25, 64)]


@pytest.mark.parametrize("mesh", list(MESHES))
def test_default_rules_equal_reference(mesh):
    ref, port = rules_pair(mesh)
    assert port.rules == ref.rules


@pytest.mark.parametrize("mesh", list(MESHES))
def test_spec_equals_reference(mesh):
    """Basic, duplicate-axis, non-divisible and kv_dim fallback cases."""
    ref, port = rules_pair(mesh)
    n = 0
    for logical in LOGICALS:
        for shape in SHAPES_FOR:
            if shape is not None and len(shape) != len(logical):
                continue
            assert port.spec(logical, shape) == tuple(
                ref.spec(logical, shape)), (logical, shape)
            n += 1
    assert n > 20


def test_spec_cases_of_the_reference_tests():
    _, port = rules_pair("16x16")
    assert port.spec(("batch", None, "mlp")) == ("data", None, "model")
    assert port.spec(("heads", "mlp")) == ("model", None)
    assert port.spec(("batch", None), shape=(1, 7)) == (None, None)
    # kv_heads=2 cannot take 16-way model; head_dim 128 takes it instead
    assert port.spec(("batch", None, "kv_heads", "kv_dim"),
                     shape=(32, 128, 2, 128)) == ("data", None, None,
                                                  "model")
    _, multi = rules_pair("2x16x16")
    assert multi.spec(("batch", None), shape=(64, 4)) == (("pod", "data"),
                                                          None)
    # 16 rows cannot split 32 ways: the trailing axis goes first
    assert multi.spec(("batch", None), shape=(16, 4)) == ("pod", None)


def test_placements_of_a_two_axis_batch_dim():
    from torch.distributed.tensor import Replicate, Shard

    pm = PortMesh((2, 4, 4), ("pod", "data", "model"))
    assert sh.placements((("pod", "data"), None, "model"), pm) == (
        Shard(0), Shard(0), Shard(2))
    assert sh.placements((None, None), pm) == (Replicate(),) * 3
    # an axis of extent 1 splits nothing
    one = PortMesh((1, 4), ("data", "model"))
    assert sh.placements(("data", "model"), one) == (Replicate(), Shard(1))
    with pytest.raises(ValueError):
        sh.placements((("data", "pod"),), pm)


def test_two_axis_batch_splits_row_major():
    """Rank r at mesh coordinate (p, d, m) of a 2×2×2 mesh holds batch
    block p * 2 + d, as the reference's PartitionSpec(("pod", "data"))
    places it."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    try:
        for rank in range(8):
            fake_process_group_at(rank, 8)
            mesh = init_device_mesh("cpu", (2, 2, 2),
                                    mesh_dim_names=("pod", "data", "model"))
            rules = sh.default_rules(mesh)
            pl = sh.batch_spec(rules, 2, shape=(16, 3)).placements
            x = sh.shard(torch.arange(16 * 3).reshape(16, 3),
                         sh.NamedSharding(mesh, pl))
            p, d = rank // 4, (rank // 2) % 2
            assert sh.local_rows(x) == slice((p * 2 + d) * 4,
                                             (p * 2 + d + 1) * 4)
            assert torch.equal(x.to_local()[:, 0],
                               torch.arange((p * 2 + d) * 4,
                                            (p * 2 + d + 1) * 4) * 3)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def fake_process_group_at(rank, world):
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)


def _ref_axes_flat(tree):
    is_axes = lambda x: isinstance(x, tuple) and all(
        n is None or isinstance(n, str) for n in x)
    paths = tree_paths(tree, is_leaf=is_axes)
    leaves = jax.tree_util.tree_leaves(tree, is_leaf=is_axes)
    return dict(zip(paths, leaves))


def _port_axes_flat(tree, prefix=""):
    """{path: axes tuple} of the port's axes tree (dicts and lists)."""
    if isinstance(tree, tuple):
        return {prefix: tree}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        out.update(_port_axes_flat(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _ref_path(path):
    import re
    return re.sub(r"^blocks/\d+/", "blocks/", path)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_logical_axes_equal_reference(arch):
    """Per leaf, the reference's axes with its stacked "layers" lead
    stripped (an xLSTM's mLSTM leaves keep their own stacking lead)."""
    ref = _ref_axes_flat(ref_build_model(ref_get_config(arch))
                         .param_logical_axes())
    model = build_model(get_config(arch), device="cpu")
    port = _port_axes_flat(model.param_logical_axes())
    assert {_ref_path(p) for p in port} == set(ref)
    shapes = model.param_shapes()
    for path, axes in port.items():
        want = ref[_ref_path(path)]
        if path.startswith("blocks/"):
            want = want[1:]
        assert axes == want, path
        assert len(axes) == len(shapes[path]), path


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "hymba-1.5b", "xlstm-1.3b",
                                  "h2o-danube-1.8b"])
def test_cache_logical_axes_equal_reference(arch):
    B, S = 2, 64
    ref_model = ref_build_model(ref_reduced_config(arch))
    ref = _ref_axes_flat(ref_model.cache_logical_axes(
        jax.eval_shape(lambda: ref_model.init_cache(B, S))))
    model = build_model(reduced_config(arch), device="cpu")
    cache = model.on_meta().init_cache(B, S)
    port = _port_axes_flat(model.cache_logical_axes(cache))
    for path, axes in port.items():
        if path.split("/")[0] in ("k", "v"):      # per layer: no lead
            assert axes == ref[path.split("/")[0]][1:], path
        else:
            assert axes == ref[path], path
        assert len(axes) == dict(tree_items(cache))[path].ndim, path


@pytest.mark.parametrize("tp", [4, 16])
@pytest.mark.parametrize("heads,kv", [(12, 2), (24, 8), (25, 5)])
def test_expand_heads_for_tp_equals_reference(tp, heads, kv):
    rng = np.random.default_rng(heads * 100 + tp)
    B, S, hd = 2, 8, 16
    q = rng.standard_normal((B, S, heads, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, kv, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, kv, hd)).astype(np.float32)
    shape, names = (2, tp), ("data", "model")
    ref_model = ref_build_model(ref_reduced_config("qwen2-1.5b"))
    with ref_sh.axis_rules(ref_sh.default_rules(RefMesh(shape, names))):
        rq, rk, rv, rH = ref_model._expand_heads_for_tp(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    model = build_model(reduced_config("qwen2-1.5b"), device="cpu")
    with sh.axis_rules(sh.default_rules(PortMesh(shape, names))):
        pq, pk, pv, pH = model._expand_heads_for_tp(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    assert pH == rH == heads
    for got, want in ((pq, rq), (pk, rk), (pv, rv)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert got.shape[2] % tp == 0


def test_expand_heads_is_a_noop_without_rules():
    model = build_model(reduced_config("qwen2-1.5b"), device="cpu")
    q, k = torch.zeros(1, 2, 12, 4), torch.zeros(1, 2, 2, 4)
    out = model._expand_heads_for_tp(q, k, k)
    assert out[0] is q and out[1] is k and out[3] == 12


@pytest.mark.parametrize("healthy", [16, 17, 31, 64, 100, 255, 256, 300, 511,
                                     512, 768, 1000])
@pytest.mark.parametrize("tp", [16, 8])
def test_replan_mesh_equals_reference(healthy, tp):
    got, want = (replan_mesh(healthy, model_parallel=tp),
                 ref_replan(healthy, model_parallel=tp))
    assert (got.shape, got.axes, got.dropped) == (want.shape, want.axes,
                                                  want.dropped)
    with pytest.raises(ValueError):
        replan_mesh(tp - 1, model_parallel=tp)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_skip_reason_and_applicable_shapes_equal_reference(arch):
    assert sorted(ARCHS) == sorted(REF_ARCHS)
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    for name in SHAPES:
        assert skip_reason(cfg, SHAPES[name]) == ref_skip_reason(
            ref_cfg, REF_SHAPES[name])
    assert [s.name for s in applicable_shapes(cfg)] == [
        s.name for s in ref_applicable(ref_cfg)]


_DT = {jnp.dtype(jnp.int32): torch.int32, jnp.dtype(jnp.bfloat16):
       torch.bfloat16, jnp.dtype(jnp.float32): torch.float32}


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_input_specs_equal_reference(arch):
    """Shapes and dtypes of every input of every applicable cell; the
    port's per-layer k/v rows are the reference's stacked rows."""
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    for s in applicable_shapes(cfg):
        port = input_specs(cfg, s)
        ref = ref_input_specs(ref_cfg, REF_SHAPES[s.name])
        assert port["kind"] == ref["kind"]
        if port["kind"] == "train":
            pairs = [(port["batch"][k], ref["batch"][k])
                     for k in ("inputs", "labels")]
        elif port["kind"] == "prefill":
            assert port["seq_len"] == ref["seq_len"]
            pairs = [(port["inputs"], ref["inputs"])]
        else:
            pairs = [(port["tokens"], ref["tokens"])]
            for path, t in tree_items(port["cache"]):
                top = path.split("/")[0]
                if top in ("k", "v"):
                    shape, dt = ref_cache_leaf(ref["cache"], top)
                    assert tuple(t.shape) == shape[1:], path
                else:
                    shape, dt = ref_cache_leaf(ref["cache"], path)
                    assert tuple(t.shape) == shape, path
                assert t.dtype == _DT[jnp.dtype(dt)], path
                assert t.is_meta
        for got, want in pairs:
            assert tuple(got.shape) == tuple(want.shape)
            assert got.dtype == _DT[jnp.dtype(want.dtype)]
            assert got.is_meta


def ref_cache_leaf(cache, path):
    node = cache
    for key in path.split("/"):
        node = node[key]
    return tuple(node.shape), node.dtype
