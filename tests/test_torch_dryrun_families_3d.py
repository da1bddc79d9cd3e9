"""The dry-run of the MoE, hybrid and ssm families on a fake 32-rank
2×4×4 ("pod", "data", "model") group (``launch/dryrun.py``).

In subprocesses (``tests/torch_scaleout_worker.py fake_families``): every
shape of the reduced qwen2-moe-a2.7b, deepseek-moe-16b, hymba-1.5b and
xlstm-1.3b is OK, or SKIP with the reference's reason; rank 0's argument
bytes of the train and prefill cells are the shard bytes the reference's
own ``param_shardings`` specs imply for the same config and mesh (the
batch on ("pod", "data")).
"""

import importlib.util
import json
import math
import os

import jax
import numpy as np
import pytest

from repro.configs import reduced_config as ref_reduced_config
from repro.models import build_model as ref_build_model
from repro.parallel import sharding as ref_sh

from repro_torch.configs import reduced_config
from repro_torch.configs.base import SHAPES
from repro_torch.configs.shapes import skip_reason

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "torch_scaleout_worker.py")


def _load_worker():
    spec = importlib.util.spec_from_file_location("torch_scaleout_worker",
                                                  WORKER)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


W = _load_worker()
ARCHS = list(W.FAMILIES)
GROUPS = (("qwen2-moe-a2.7b", "deepseek-moe-16b"), ("hymba-1.5b",),
          ("xlstm-1.3b",))


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    """(arch, shape) -> the port's record on 2×4×4."""
    out = str(tmp_path_factory.mktemp("fake3d"))
    for p in [W.start([WORKER, "fake_families", out, "2x4x4", *group])
              for group in GROUPS]:
        W.wait(p)
    recs = {}
    for name in os.listdir(out):
        with open(os.path.join(out, name)) as f:
            rec = json.load(f)
        recs[(rec["arch"], rec["shape"])] = rec
    return recs


class RefMesh:
    def __init__(self, shape, names):
        self.axis_names = names
        self.shape = dict(zip(names, shape))


def _ref_local(rules, spec, shape):
    """Elements of one rank's shard of ``shape`` under PartitionSpec
    ``spec``."""
    n = 1
    for size, ax in zip(shape, tuple(spec) + (None,) * len(shape)):
        axes = () if ax is None else (ax if isinstance(ax, tuple) else (ax,))
        n *= size // math.prod(rules.mesh.shape[a] for a in axes)
    return n


@pytest.mark.parametrize("arch", ARCHS)
def test_every_shape_is_ok_or_skipped_with_the_reference_reason(cells,
                                                                arch):
    cfg = reduced_config(arch)
    for name, shape in SHAPES.items():
        rec = cells[(arch, name)]
        reason = skip_reason(cfg, shape)
        if reason is not None:
            assert (rec["status"], rec["reason"]) == ("skipped", reason)
            continue
        assert rec["status"] == "ok", rec
        assert rec["flops"] > 0 and rec["memory"]["temp_bytes"] > 0
        if name != "long_500k":      # one sequence: nothing to split
            assert rec["collectives"]["total"] > 0, name


@pytest.mark.parametrize("arch", ARCHS)
def test_argument_bytes_are_the_reference_specs_shards(cells, arch):
    """Params (and AdamW's fp32 mu / nu, its step and the state's, int32)
    as the reference's shape-aware specs shard them, and inputs and
    labels with the batch on ("pod", "data")."""
    shape, names = W.FAKE_MESHES["2x4x4"]
    rules = ref_sh.default_rules(RefMesh(shape, names))
    model = ref_build_model(ref_reduced_config(arch))
    axes = model.param_logical_axes()
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    is_axes = lambda x: isinstance(x, tuple) and all(
        n is None or isinstance(n, str) for n in x)
    params = moments = 0
    for ax, s in zip(jax.tree_util.tree_leaves(axes, is_leaf=is_axes),
                     jax.tree_util.tree_leaves(shapes)):
        n = _ref_local(rules, rules.spec(ax, s.shape), s.shape)
        params += n * np.dtype(s.dtype).itemsize
        moments += 2 * n * 4

    def batch_bytes(cell):
        B, S = cell.global_batch, cell.seq_len
        return _ref_local(rules, rules.spec(("batch", None), (B, S)),
                          (B, S)) * 4

    pre, tr = SHAPES["prefill_32k"], SHAPES["train_4k"]
    assert cells[(arch, "prefill_32k")]["memory"]["argument_bytes"] == (
        params + batch_bytes(pre))
    assert cells[(arch, "train_4k")]["memory"]["argument_bytes"] == (
        params + moments + 8 + 2 * batch_bytes(tr))
