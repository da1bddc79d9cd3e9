"""The port's dry-run on fake process groups (``launch/dryrun.py``,
``roofline/step_costs.py``, ``roofline/report.py``).

In a subprocess (``tests/torch_scaleout_worker.py fake``): every shape of
a reduced dense config (h2o-danube: its window makes long_500k apply) on
fake 16-rank 4×4 and 32-rank 2×4×4 groups is OK; each cell's
``argument_bytes`` is the shard bytes the reference's own
``param_shardings`` specs imply for the same config and mesh; a small
train step on a fake 2×2 group issues the same collectives, in the same
counts and bytes, as a real 2×2 gloo step records
(``tests/torch_scaleout_worker.py collectives``, 4 ranks); per device
on the 4×4 mesh, each cell's FLOPs and argument bytes are what the
reference's own dry-run compiles for the same config on 16 host devices
(``tests/jax_sharded_reference.py dryrun``); the report and the hotspot
ranking run on the records. Also the CLI on the production meshes for
one cell.
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

from repro_torch.roofline import rank_step_hotspots
from repro_torch.roofline import report

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "torch_scaleout_worker.py")


def _load_worker():
    spec = importlib.util.spec_from_file_location("torch_scaleout_worker",
                                                  WORKER)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


W = _load_worker()
REF_SHAPES = ["train_4k", "prefill_32k", "decode_32k"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The five subprocesses of this file, run at once: the fake-group
    cells (the 2×4×4 ones apart), the real gloo step's collectives, the
    CLI and the reference's dry-run of the 4×4 cells."""
    dirs = {k: str(tmp_path_factory.mktemp(k))
            for k in ("fake", "gloo", "cli", "ref")}
    procs = {"fake": W.start([WORKER, "fake", dirs["fake"], "4x4", "2x2"]),
             "fake3d": W.start([WORKER, "fake", dirs["fake"], "2x4x4"]),
             "ref": W.start([os.path.join(HERE, "jax_sharded_reference.py"),
                             "dryrun", dirs["ref"]] + REF_SHAPES),
             "gloo": W.start([WORKER, "collectives", dirs["gloo"]]),
             "cli": W.start(["-m", "repro_torch.launch.dryrun", "--arch",
                            "h2o-danube-1.8b", "--shape", "long_500k",
                            "--mesh", "both", "--out", dirs["cli"]])}
    texts = {k: W.wait(p) for k, p in procs.items()}
    return dirs, texts


@pytest.fixture(scope="module")
def cells(runs):
    out = runs[0]["fake"]
    recs = {}
    for name in os.listdir(out):
        with open(os.path.join(out, name)) as f:
            rec = json.load(f)
        recs[(rec["shape"], rec["mesh"])] = rec
    return out, recs


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


def _ref_param_bytes(mesh_name):
    """Rank 0's shard bytes of the params and of their fp32 moments under
    the reference's ``param_shardings`` specs (shape-aware)."""
    shape, names = W.FAKE_MESHES[mesh_name]
    rules = ref_sh.default_rules(RefMesh(shape, names))
    model = ref_build_model(ref_reduced_config(W.DRY_ARCH))
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
    return rules, params, moments


@pytest.mark.parametrize("mesh", ["4x4", "2x4x4"])
def test_every_shape_of_a_reduced_dense_config_is_ok(cells, mesh):
    _, recs = cells
    from repro_torch.configs.base import SHAPES

    for name in SHAPES:
        rec = recs[(name, mesh)]
        assert rec["status"] == "ok", rec
        assert rec["flops"] > 0 and rec["bytes_accessed"] > 0
        assert rec["memory"]["temp_bytes"] > 0
        if name != "long_500k":      # one sequence: nothing to split
            assert rec["collectives"]["total"] > 0, name


@pytest.mark.parametrize("mesh", ["4x4", "2x4x4"])
def test_argument_bytes_are_the_reference_specs_shards(cells, mesh):
    _, recs = cells
    from repro_torch.configs.base import SHAPES

    rules, params, moments = _ref_param_bytes(mesh)

    def batch_bytes(B, S):
        return _ref_local(rules, rules.spec(("batch", None), (B, S)),
                          (B, S)) * 4

    pre = SHAPES["prefill_32k"]
    assert recs[("prefill_32k", mesh)]["memory"]["argument_bytes"] == (
        params + batch_bytes(pre.global_batch, pre.seq_len))
    tr = SHAPES["train_4k"]
    # params, AdamW's mu / nu, its step and the state's step (int32),
    # inputs and labels
    assert recs[("train_4k", mesh)]["memory"]["argument_bytes"] == (
        params + moments + 8 + 2 * batch_bytes(tr.global_batch, tr.seq_len))


@pytest.mark.parametrize("shape", REF_SHAPES)
def test_flops_and_arguments_equal_the_reference_dry_run(runs, cells,
                                                         shape):
    """The port's traced FLOPs (matmuls at 2·M·N·K) against the FLOPs the
    reference's HLO parser counts (dots at 2·K·prod(out), loop bodies
    times their trip counts), rank 0 of the 4×4 mesh: equal, but for the
    tiles the reference's dk/dv pass computes past the last q chunk and
    zeroes (it scans a fixed band of q chunks per kv chunk; the port's
    loop stops at the last chunk): per layer band·(band − 1)/2 tiles of
    4 dots each, a tile's dot 2·b·c·c·h·hd for the local batch b, chunk
    c and local heads h. The argument bytes are equal."""
    from repro_torch.configs import reduced_config
    from repro_torch.configs.base import SHAPES
    from repro_torch.models.attention import kv_band

    with open(os.path.join(runs[0]["ref"], f"ref_{shape}.json")) as f:
        ref = json.load(f)
    got = cells[1][(shape, "4x4")]
    assert got["memory"]["argument_bytes"] == ref["memory"][
        "argument_bytes"]
    extra = 0
    if shape == "train_4k":
        cfg = reduced_config(W.DRY_ARCH)
        (data, tp), _ = W.FAKE_MESHES["4x4"]
        S, B = SHAPES[shape].seq_len, SHAPES[shape].global_batch
        c = min(512, S)
        band = kv_band(S // c, c, cfg.causal, cfg.sliding_window)
        heads = -(-cfg.num_heads // tp)
        tile = 2 * (B // data) * c * c * heads * cfg.head_dim
        extra = cfg.num_layers * band * (band - 1) // 2 * 4 * tile
    assert got["flops"] == ref["flops"] - extra


@pytest.mark.parametrize("shape", REF_SHAPES)
def test_replayed_trace_equals_the_full_trace(cells, shape):
    """A cell whose attention tiles were traced once per shape and
    replayed records what tracing every tile records."""
    _, recs = cells
    got, full = recs[(shape, "4x4")], recs[(shape + "_full", "4x4")]
    for key in ("flops", "bytes_accessed", "collectives", "memory"):
        assert got[key] == full[key], key
    rows = lambda r: sorted((o["op"], o["kind"], o["where"], o["count"],
                             o["flops"], o["bytes"]) for o in r["ops"])
    assert rows(got) == rows(full)


def test_fake_collectives_equal_a_real_gloo_step(cells, runs):
    out, recs = cells
    with open(os.path.join(runs[0]["gloo"], "collectives.json")) as f:
        real = json.load(f)
    fake = recs[("train_small", "2x2")]
    counts = {}
    for r in fake["ops"]:
        if r["kind"] == "collective":
            counts[r["op"]] = counts.get(r["op"], 0) + r["count"]
    assert counts == real["counts"]
    assert {k: v for k, v in fake["collectives"].items()
            if k != "total"} == real["bytes"]
    assert set(counts) >= {"all_gather_into_tensor", "reduce_scatter_tensor",
                           "all_reduce"}


def test_report_and_hotspots_run_on_the_records(cells, monkeypatch):
    out, recs = cells
    monkeypatch.setitem(report.MESH_DEVICES, "4x4", 16)
    monkeypatch.setattr(report, "get_config", ref_free_reduced)
    rows = report.load_cells(out, "4x4")
    ok = [r for r in rows if r.get("status") == "ok"]
    assert len(ok) == 4
    for r in ok:
        assert r["useful_flop_ratio"] > 0, r["shape"]
        assert r["dominant"] in ("compute", "memory", "collective")
        # 6·N·D / 2·N·D counts the embedding table in N, which a decode
        # step only gathers from: at d_model 64 and vocab 512 it is most
        # of N, so only the full-sequence cells are held to the bound
        if r["shape"] in ("train_4k", "prefill_32k"):
            assert r["useful_flop_ratio"] <= 1.05, r["shape"]
    text = report.render_md(rows, "4x4")
    assert text.count("\n| h2o-danube-1.8b |") == 4
    spots = rank_step_hotspots(recs[("train_4k", "4x4")]["ops"], top=5)
    coll = [r["bytes"] for r in spots["collectives"]]
    mem = [r["bytes"] for r in spots["memory_ops"]]
    assert coll == sorted(coll, reverse=True) and len(mem) == 5
    assert mem == sorted(mem, reverse=True)
    assert 0 < spots["attention_internal_bytes"] < spots[
        "instruction_bytes_total"]


def ref_free_reduced(arch):
    from repro_torch.configs import reduced_config

    return reduced_config(arch)


def test_cli_on_the_production_meshes(runs):
    dirs, texts = runs
    text = texts["cli"]
    assert "OK   h2o-danube-1.8b__long_500k__16x16" in text
    assert "OK   h2o-danube-1.8b__long_500k__2x16x16" in text
    assert "dry-run complete: 2 ok, 0 skipped, 0 failed" in text
    with open(os.path.join(dirs["cli"],
                           "h2o-danube-1.8b__long_500k__16x16.json")) as f:
        rec = json.load(f)
    assert rec["status"] == "ok" and rec["mesh"] == "16x16"


def test_cli_skips_with_the_reference_reason(tmp_path, capsys):
    from repro_torch.launch import dryrun

    assert dryrun.main(["--arch", "qwen2-1.5b", "--shape", "long_500k",
                        "--mesh", "single", "--out", str(tmp_path)]) == 0
    assert ("SKIP qwen2-1.5b__long_500k__16x16: pure full-attention arch; "
            "500k decode needs sub-quadratic attention"
            ) in capsys.readouterr().out
    with open(tmp_path / "qwen2-1.5b__long_500k__16x16.json") as f:
        assert json.load(f)["status"] == "skipped"
