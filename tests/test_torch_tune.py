"""The port's plan tuner and plan-cached registry (``repro_torch/sparse/
tune.py``, ``sparse/registry.py``) against the reference's, on the CPU.

Checked: ``m_bucket`` and the ``Plan`` strings equal the reference's; the
candidates of every route are the listed set, plain functions of the
shapes, and none changes a route or a K split (each candidate's launch
arguments captured from the wrappers' ``_launch`` with the C call
stubbed); plans apply only on the device they were stamped for; a 4-layer
reduced qwen2 artifact is tuned with one search per geometry and the
same plan in every layer; plans survive save and load (a column leaf's
per-layer plans too) and re-serving runs no search; the reference loads
a port-tuned artifact, sees none of its plans and serves it to the
untuned tokens; the port serves the same tokens tuned and untuned; a
``REPRO_AUTOTUNE=1`` first-dispatch search is memoized and none runs
inside a capture; ``DISPATCH_STATS``' key set for a forward is the
reference's; ``dispatch_stats_scope`` isolates; ``--no-tune`` changes what
``launch/pipeline.py`` writes.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JModelConfig
from repro.core import DEFAULT_EXCLUDE as J_EXCLUDE
from repro.core import PruneConfig as JPruneConfig
from repro.core import greedy_prune as j_greedy_prune
from repro.models import build_model
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro.sparse import tune as jtune
from repro.sparse.artifact import PrunedArtifact as JPrunedArtifact
from repro.sparse.packed import is_packed as j_is_packed
from repro.sparse.registry import dispatch_stats_scope as j_stats_scope
from repro_torch.configs import reduced_config
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import params_from_jax
from repro_torch.core import DEFAULT_EXCLUDE, LayerSpec, PruneConfig
from repro_torch.core import greedy_prune
from repro_torch.kernels import _build
from repro_torch.kernels import column_gemm as cg
from repro_torch.kernels import pattern_conv as pc
from repro_torch.kernels import pattern_gemm as pg
from repro_torch.kernels.sm90 import GRID_ORDERS, wgmma_plan
from repro_torch.models import LM
from repro_torch.runtime.telemetry import registry_scope
from repro_torch.serve import Request, ServeEngine
from repro_torch.sparse import PrunedArtifact, is_packed, tune
from repro_torch.sparse import registry as reg
from repro_torch.utils.tree import tree_items

JCFG = JModelConfig(name="bench", family="dense", num_layers=2, d_model=128,
                    num_heads=4, num_kv_heads=2, head_dim=32, d_ff=256,
                    vocab_size=512, param_dtype="float32")
OVERRIDES = {".*": {"tile_block_p": 128, "tile_group_q": 8, "tile_keep": 4},
             r".*/(wk|wv)": {"tile_block_p": 64}}
PROMPT_LENS = (5, 9, 9, 12)
MAX_NEW = (4, 6, 3, 5)
BATCH, MAX_SEQ = 2, 32
TUNE_MS = (4, 24)


def _prompts():
    rng = np.random.default_rng(7)
    return [rng.integers(0, JCFG.vocab_size, n).astype(np.int32)
            for n in PROMPT_LENS]


def _requests():
    return [Request(uid=i, prompt=torch.from_numpy(p), max_new_tokens=m)
            for i, (p, m) in enumerate(zip(_prompts(), MAX_NEW))]


def _j_requests():
    return [JRequest(uid=i, prompt=jnp.asarray(p), max_new_tokens=m)
            for i, (p, m) in enumerate(zip(_prompts(), MAX_NEW))]


def _searches(reg_):
    return reg_.sum_counter("tune.candidates_total")


@pytest.fixture(scope="module")
def both():
    """(reference model, reference artifact, port model, port artifact):
    the same dense weights pruned and packed by each package."""
    jmodel = build_model(JCFG)
    np_params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    jart = j_greedy_prune(
        jax.tree.map(jnp.asarray, np_params),
        JPruneConfig(scheme="tile_pattern", exclude=tuple(J_EXCLUDE),
                     overrides=OVERRIDES)).to_artifact().pack()
    cfg = ModelConfig(**dataclasses.asdict(JCFG))
    model = LM(cfg, device="cpu")
    art = greedy_prune(params_from_jax(np_params, cfg, "cpu"),
                       PruneConfig(scheme="tile_pattern",
                                   exclude=DEFAULT_EXCLUDE,
                                   overrides=OVERRIDES),
                       device="cpu").pack(device="cpu")
    return jmodel, jart, model, art, cfg


# --------------------------------------------------------- plans and buckets

def test_m_bucket_equals_reference():
    for small in (1, 16, 32, 64):
        for M in range(0, 5000, 7):
            assert tune.m_bucket(M, small) == jtune.m_bucket(M, small)
    assert tune.m_bucket(4) == tune.m_bucket(24) == 32


@pytest.mark.parametrize("s", ["pallas:bm=256:go=pm", "gather", "xla",
                               "pallas:bm=128:bk=512:go=pm", "gather_tb",
                               "pallas:bm=128"])
def test_reference_plan_strings_parse_to_the_same_fields(s):
    mine, ref = tune.Plan.from_str(s), jtune.Plan.from_str(s)
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    assert mine.to_str() == ref.to_str() == s


@pytest.mark.parametrize("plan", [
    tune.Plan("skinny"), tune.Plan("gather"),
    tune.Plan("wgmma", block_m=64, grid="pm"),
    tune.Plan("wgmma", block_m=128), tune.Plan("wgmma", block_p=256),
    tune.Plan("wgmma", block_p=64, grid="pm")])
def test_plan_strings_round_trip(plan):
    assert tune.Plan.from_str(plan.to_str()) == plan
    assert "|" not in plan.to_str()


def test_plan_from_str_refuses_an_unknown_tag():
    with pytest.raises(KeyError):
        tune.Plan.from_str("wgmma:zz=3")


# ---------------------------------------------------------------- candidates

def _tile_leaf(Q, P, bp=128, dtype=torch.bfloat16, seed=0):
    g = torch.Generator().manual_seed(seed)
    w = torch.randn(Q, P, generator=g).to(dtype)
    spec = LayerSpec(scheme="tile_pattern", tile_block_p=bp, tile_group_q=8,
                     tile_keep=4)
    w = spec.project(w.float()).to(dtype)
    return reg.handler_for("tile_pattern").pack(w, spec)


def _column_leaf(Q, P, dtype=torch.bfloat16, seed=0, keep=None):
    g = torch.Generator().manual_seed(seed)
    w = torch.randn(Q, P, generator=g)
    keep = Q // 2 if keep is None else keep
    w[keep:] = 0
    spec = LayerSpec(scheme="column", alpha=0.5)
    return reg.handler_for("column").pack(w.to(dtype), spec)


def _conv_leaf(A, C, dtype=torch.bfloat16, seed=0):
    g = torch.Generator().manual_seed(seed)
    w = torch.randn(A, C, 3, 3, generator=g)
    w[:, :, 0, :] = 0
    w[:, :, 2, 2] = 0
    w[:, :, 1, 0] = 0
    spec = LayerSpec(scheme="pattern_shared", alpha=0.25)
    return reg.handler_for("pattern").pack(w.to(dtype), spec)


WGMMA_GEMM = [tune.Plan("wgmma", block_m=bm, grid=go)
              for bm in (64, 128) for go in ("mp", "pm")]


@pytest.mark.parametrize("M", [1, 4, 16, 17, 24, 32, 512, 2048])
def test_gemm_candidates_follow_the_route(M):
    for pt in (_tile_leaf(1536, 256), _column_leaf(1536, 256)):
        want_route = ("skinny" if M <= 16 else "wgmma")
        assert tune.route(pt, "matmul", M, cuda=True) == want_route
        cands = tune.candidate_plans(pt, "matmul", M, cuda=True)
        assert cands == ([tune.Plan("skinny")] if M <= 16 else WGMMA_GEMM)
        assert tune.candidate_plans(pt, "matmul", M, cuda=False) == [
            tune.Plan("gather")]
    for pt in (_tile_leaf(256, 256, dtype=torch.float32),
               _column_leaf(256, 256, dtype=torch.float32)):
        want = "skinny" if M <= 16 else "simt"
        assert tune.candidate_plans(pt, "matmul", M, cuda=True) == [
            tune.Plan(want)]
    # a column leaf whose P TMA cannot address takes wmma
    pt = _column_leaf(256, 100)
    want = "skinny" if M <= 16 else "wmma"
    assert tune.candidate_plans(pt, "matmul", M, cuda=True) == [
        tune.Plan(want)]


@pytest.mark.parametrize("A,C,dtype,want", [
    (64, 64, torch.bfloat16, [64]),
    (128, 64, torch.bfloat16, [64, 128]),
    (512, 256, torch.bfloat16, [64, 128, 256]),
    (64, 3, torch.bfloat16, "wmma"),
    (64, 64, torch.float32, "simt"),
])
def test_conv_candidates_follow_the_route(A, C, dtype, want):
    pt = _conv_leaf(A, C, dtype)
    cands = tune.candidate_plans(pt, "conv", 32 * 56 * 56, cuda=True)
    if isinstance(want, str):
        assert cands == [tune.Plan(want)]
    else:
        assert cands == [tune.Plan("wgmma", block_p=bn, grid=go)
                         for bn in want for go in ("mp", "pm")]
    assert tune.candidate_plans(pt, "conv", 8, cuda=False) == [
        tune.Plan("xla")]


@pytest.fixture
def stub_launch(monkeypatch):
    """Run the wrappers' ``_launch`` on CPU tensors with the C call
    stubbed: returns the list of captured (name, args)."""
    calls = []

    class _Props:
        multi_processor_count = 132

    class _Stream:
        cuda_stream = 0

    monkeypatch.setattr(_build, "launch", lambda name, *a: calls.append(
        (name, a)))
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d=None: _Props)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d=None: _Stream)
    return calls


# (name, positions of variant, ksplit, block_m, grid order in the C call)
_ARGS = {"pattern_gemm": (12, 11, 13, 14), "column_gemm": (12, 11, 13, 14)}


@pytest.mark.parametrize("M", [4, 17, 24, 32, 512, 2048])
def test_no_candidate_changes_a_route_or_a_k_split(stub_launch, M):
    """Every candidate launches the untuned call's variant with its K
    split; only block_m and the grid order move. With no plan the launch
    is the heuristic's: wgmma_plan's block_m, row tiles fastest."""
    sms = 132
    for Q, P in ((1536, 1536), (1536, 256), (8960, 1536)):
        for mod, pt in ((pg, _tile_leaf(Q, P)), (cg, _column_leaf(Q, P))):
            name = mod.__name__.rsplit(".", 1)[1]
            x = torch.zeros((M, Q), dtype=torch.bfloat16)
            bufs = (pt.buffers[0], pt.buffers[1])
            route = tune.route(pt, "matmul", M, cuda=True)
            stub_launch.clear()
            mod._launch(x, *bufs, None, None, route)
            base = stub_launch[0][1]
            iv, ik, ib, ig = _ARGS[name]
            if route == "wgmma":
                if name == "pattern_gemm":
                    nb, Kp = pt.buf("lane_idx").shape
                    n_tiles = nb
                else:
                    Kp, Pw = pt.buf("w_packed").shape
                    n_tiles = -(-Pw // 128)
                bm, ks = wgmma_plan(M, n_tiles, -(-Kp // 64), sms)
                assert (base[ib], base[ik]) == (bm, ks)
                assert base[ig] == GRID_ORDERS["pm"]
                assert tune.heuristic_plan(pt, "matmul", M, cuda=True,
                                           sms=sms) == tune.Plan(
                    "wgmma", block_m=bm, grid="pm")
            for c in tune.candidate_plans(pt, "matmul", M, cuda=True):
                stub_launch.clear()
                mod._launch(x, *bufs, None, None, c.impl,
                            **tune.plan_knobs("matmul", c))
                got = stub_launch[0][1]
                assert got[iv] == base[iv] and got[ik] == base[ik]
                if c.impl == "wgmma":
                    assert got[ib] == c.block_m
                    assert got[ig] == GRID_ORDERS[c.grid]
                diff = {i for i, (a, b) in enumerate(zip(got, base))
                        if a != b}
                # pointers of fresh outputs aside, only the knobs move
                assert diff - {ib, ig} <= {4, 5, 6}


def test_conv_candidates_keep_the_patch(stub_launch):
    for A, C, H in ((64, 64, 224), (128, 128, 112), (512, 512, 28)):
        pt = _conv_leaf(A, C)
        x = torch.zeros((2, H, H, C), dtype=torch.bfloat16)
        stub_launch.clear()
        pc._launch(x, pt.buf("w_packed"), pt.buf("taps"), None, None,
                   "wgmma")
        base = stub_launch[0][1]
        assert base[16] == pc.conv_plan(2, H, H, A, 132)[3]
        assert base[17] == GRID_ORDERS["mp"]
        for c in tune.candidate_plans(pt, "conv", 2 * H * H, cuda=True):
            stub_launch.clear()
            pc._launch(x, pt.buf("w_packed"), pt.buf("taps"), None, None,
                       "wgmma", **tune.plan_knobs("conv", c))
            got = stub_launch[0][1]
            assert got[12:16] == base[12:16]          # route and patch
            assert (got[16], got[17]) == (c.block_p, GRID_ORDERS[c.grid])


def test_bad_knobs_raise():
    x = torch.zeros((4, 64))
    pt = _tile_leaf(64, 128, dtype=torch.float32)
    with pytest.raises(ValueError):
        pg.pattern_gemm(x, pt.buffers[0], pt.buffers[1], block_m=256)
    with pytest.raises(ValueError):
        pg.pattern_gemm(x, pt.buffers[0], pt.buffers[1], grid_order="xy")
    with pytest.raises(ValueError):
        pc.pattern_conv(torch.zeros((1, 4, 4, 8)),
                        torch.zeros((32, 8)),
                        torch.zeros((8, 4), dtype=torch.int32), block_n=32)


# ---------------------------------------------------------------- mode gate

def test_plans_apply_only_on_their_device():
    pt = _tile_leaf(256, 128, dtype=torch.float32)
    tree, _ = tune.tune_packed_tree({"w": pt}, (64,), iters=1)
    tuned = tree["w"]
    assert tuned.meta_dict[tune.MODE_KEY] == "cpu"
    assert tune.resolve(tuned, "matmul", 64, mode="cpu") == tune.Plan(
        "gather")
    assert tune.resolve(tuned, "matmul", 64, mode="cuda:sm_90") is None
    other = dataclasses.replace(tuned, meta=tuple(
        (k, "cuda:sm_80" if k == tune.MODE_KEY else v)
        for k, v in tuned.meta))
    assert tune.resolve(other, "matmul", 64, mode="cpu") is None
    # the reference's plan:* and plan_mode entries are never read
    ref = dataclasses.replace(pt, meta=pt.meta + (
        ("plan:matmul:m64", "pallas:bm=256:go=pm"),
        ("plan_mode", "compiled")))
    assert tune.resolve(ref, "matmul", 64, mode="cpu") is None
    assert tune.resolve(ref, "matmul", 64, mode="cuda:sm_90") is None
    assert tune.plans_in_meta(ref) == {}


# ----------------------------------------------------- a 4-layer artifact

@pytest.fixture(scope="module")
def qwen4():
    cfg = dataclasses.replace(reduced_config("qwen2-1.5b"), num_layers=4)
    model = LM(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    art = greedy_prune(params, PruneConfig(
        scheme="tile_pattern", exclude=DEFAULT_EXCLUDE,
        overrides={".*": {"tile_block_p": 32}}), device="cpu").pack(
        device="cpu")
    return cfg, model, art


def _geometries(packed):
    return {(tuple(pt.shape), tuple(tuple(b.shape) for b in pt.buffers))
            for _, pt in tree_items(packed) if is_packed(pt)}


def test_one_search_per_geometry_same_plan_every_layer(qwen4):
    cfg, _, art = qwen4
    with registry_scope() as r:
        tuned = art.tune((4, 24, 64), iters=1)
        # 4 and 24 share bucket m32; 64 is m64
        assert _searches(r) == 2 * len(_geometries(art.packed))
    plans = tune.describe_plans(tuned.packed)
    assert len(plans) == sum(is_packed(x) for _, x in tree_items(art.packed))
    for name in ("attn/wq", "attn/wk", "mlp/w_gate", "mlp/w_down"):
        per_layer = [plans.get(f"blocks/{i}/{name}") for i in range(4)]
        assert per_layer[0] and all(p == per_layer[0] for p in per_layer)
        assert set(per_layer[0]) == {"plan_torch:matmul:m32",
                                     "plan_torch:matmul:m64"}
    assert all(pt.meta_dict[tune.MODE_KEY] == "cpu"
               for _, pt in tree_items(tuned.packed) if is_packed(pt))
    assert set(tuned.meta["tuned_plans"]) == {
        f"{p}:{k}" for p, d in plans.items() for k in d}


def test_save_load_keeps_plans_and_reserving_runs_no_search(
        qwen4, tmp_path, monkeypatch):
    cfg, model, art = qwen4
    tuned = art.pack(device="cpu", tune_for=(4, 64), tune_iters=1)
    d = str(tmp_path / "art")
    tuned.save(d)
    loaded = PrunedArtifact.load(d, cfg=cfg, device="cpu")
    assert tune.describe_plans(loaded.packed) == tune.describe_plans(
        tuned.packed)
    assert loaded.meta["tuned_plans"] == tuned.meta["tuned_plans"]
    monkeypatch.setenv("REPRO_AUTOTUNE", "1")
    tune.clear_tuned_cache()
    reqs = [Request(uid=i, prompt=torch.arange(6 + i) % cfg.vocab_size,
                    max_new_tokens=5) for i in range(3)]
    with registry_scope() as r:
        got = [x.tokens for x in ServeEngine(
            model, loaded, packed=True, batch_size=4, max_seq_len=64,
            device="cpu").generate(reqs)]
        assert _searches(r) == 0
    monkeypatch.delenv("REPRO_AUTOTUNE")
    want = [x.tokens for x in ServeEngine(
        model, art, packed=True, batch_size=4, max_seq_len=64,
        device="cpu").generate(reqs)]
    assert got == want


def test_column_layers_keep_their_own_plans(tmp_path):
    """A column leaf whose layers kept different row counts is saved
    padded to one shape; each layer's plan comes back with its own rows."""
    cfg = dataclasses.replace(reduced_config("qwen2-1.5b"), num_layers=3)
    model = LM(cfg, device="cpu")
    pruned = greedy_prune(model.init(torch.Generator().manual_seed(1)),
                          PruneConfig(scheme="column", alpha=0.5),
                          device="cpu")
    for i in range(3):                 # layer i's wq keeps 4 i rows fewer
        wq = pruned.params["blocks"][i]["attn"]["wq"]
        alive = torch.nonzero((wq != 0).any(dim=1)).reshape(-1)
        wq[alive[:4 * i]] = 0
    art = pruned.pack(device="cpu")
    rows = [art.packed["blocks"][i]["attn"]["wq"].buf("kept_idx").shape[0]
            for i in range(3)]
    assert len(set(rows)) == 3
    with registry_scope() as r:
        tuned = art.tune((4,), iters=1)
        assert _searches(r) == len(_geometries(art.packed))
    # stand-ins for plans a card would pick per layer: distinct strings
    blocks = tuned.packed["blocks"]
    for i, s in enumerate(("gather", "wgmma:bm=64", "wgmma:bm=128:go=pm")):
        pt = blocks[i]["attn"]["wq"]
        blocks[i]["attn"]["wq"] = dataclasses.replace(pt, meta=tuple(
            (k, s if k == "plan_torch:matmul:m32" else v)
            for k, v in pt.meta))
    d = str(tmp_path / "col")
    tuned.save(d)
    loaded = PrunedArtifact.load(d, cfg=cfg, device="cpu")
    for i in range(3):
        a, b = blocks[i]["attn"]["wq"], loaded.packed["blocks"][i]["attn"]["wq"]
        assert tune.plans_in_meta(b) == tune.plans_in_meta(a)
        assert b.buf("kept_idx").shape[0] == rows[i]
        assert tune.plan_mode(b) == "cpu"
    assert tune.describe_plans(loaded.packed) == tune.describe_plans(
        tuned.packed)


# ------------------------------------------------- both packages, one disk

def test_reference_sees_no_port_plan_and_serves_untuned_tokens(both,
                                                                tmp_path):
    jmodel, jart, model, art, cfg = both
    tuned = art.tune(TUNE_MS, iters=1)
    d_tuned, d_plain = str(tmp_path / "tuned"), str(tmp_path / "plain")
    tuned.save(d_tuned)
    art.save(d_plain)
    j_tuned = JPrunedArtifact.load(d_tuned)
    j_plain = JPrunedArtifact.load(d_plain)
    leaves = [x for x in jax.tree.leaves(j_tuned.packed, is_leaf=j_is_packed)
              if j_is_packed(x)]
    assert leaves
    for pt in leaves:
        assert jtune.plans_in_meta(pt) == {}
        for M in (1, 4, 24, 64, 256):
            assert jtune.plan_from_meta(pt, "matmul", M) is None
        assert any(k.startswith(tune.PLAN_PREFIX) for k, _ in pt.meta)

    def serve(a):
        return [r.tokens for r in JServeEngine(
            jmodel, a, batch_size=BATCH, max_seq_len=MAX_SEQ,
            packed=True).generate(_j_requests())]

    assert serve(j_tuned) == serve(j_plain)


def test_port_serves_the_same_tokens_tuned_and_untuned(both):
    jmodel, jart, model, art, cfg = both
    tuned = art.pack(device="cpu", tune_for=TUNE_MS, tune_iters=1)

    def serve(a):
        return [r.tokens for r in ServeEngine(
            model, a, batch_size=BATCH, max_seq_len=MAX_SEQ, packed=True,
            device="cpu").generate(_requests())]

    want = [r.tokens for r in JServeEngine(
        jmodel, jart, batch_size=BATCH, max_seq_len=MAX_SEQ,
        packed=True).generate(_j_requests())]
    assert serve(tuned) == serve(art) == want


# ------------------------------------------------------ first-dispatch search

def test_autotune_first_dispatch_search_is_memoized(monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE", "1")
    tune.clear_tuned_cache()
    pt = _tile_leaf(256, 128, dtype=torch.float32)
    x = torch.randn(40, 256)
    with registry_scope() as r:
        y0 = reg.dispatch_matmul(x, pt)
        assert _searches(r) == 1
        y1 = reg.dispatch_matmul(x, pt)
        # a new leaf object of the same geometry: the in-process winner
        twin = dataclasses.replace(pt)
        y2 = reg.dispatch_matmul(x, twin)
        assert _searches(r) == 1
    assert torch.equal(y0, y1) and torch.equal(y0, y2)
    key = tune._tuned_key(pt, "matmul", 40, "cpu")
    assert tune._TUNED[key] == "gather"
    tune.clear_tuned_cache()


def test_no_search_inside_a_capture(monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE", "1")
    tune.clear_tuned_cache()
    pt = _tile_leaf(256, 128, dtype=torch.float32)
    with registry_scope() as r:
        assert tune.resolve(pt, "matmul", 40, mode="cpu",
                            capturing=True) is None
        assert tune.resolution_deferred(pt, "matmul", 40, "cpu", True)
        assert not tune.resolution_deferred(pt, "matmul", 40, "cpu", False)
        assert _searches(r) == 0
    tree, _ = tune.tune_packed_tree({"w": pt}, (40,), iters=1)
    assert not tune.resolution_deferred(tree["w"], "matmul", 40, "cpu", True)
    monkeypatch.delenv("REPRO_AUTOTUNE")
    assert not tune.resolution_deferred(pt, "matmul", 40, "cpu", True)
    tune.clear_tuned_cache()


def test_a_plan_of_another_route_takes_the_heuristic():
    """A bucket spanning two routes: the plan names one; a call on the
    other runs the heuristic and counts a plan_miss."""
    pt = _tile_leaf(256, 128, dtype=torch.float32)
    stamped = dataclasses.replace(pt, meta=pt.meta + (
        ("plan_torch:matmul:m32", "skinny"), (tune.MODE_KEY, "cpu")))
    x = torch.randn(4, 256)
    with reg.dispatch_stats_scope() as st:
        y = reg.dispatch_matmul(x, stamped)
        reg.dispatch_matmul(x, stamped)
        assert st["plan_miss:matmul:tile_pattern:m32"] == 2
        assert st["matmul:tile_pattern:m32"] == 2
        assert st["plan_build:matmul:tile_pattern:gather"] == 1
    assert torch.equal(y, reg.dispatch_matmul(x, pt))


# ------------------------------------------------------------- dispatch stats

def test_dispatch_stats_key_set_equals_reference(both):
    jmodel, jart, model, art, cfg = both
    with j_stats_scope() as jst:
        JServeEngine(jmodel, jart, batch_size=BATCH, max_seq_len=MAX_SEQ,
                     packed=True).generate(_j_requests())
        want = set(jst)
    with reg.dispatch_stats_scope() as st:
        ServeEngine(model, art, batch_size=BATCH, max_seq_len=MAX_SEQ,
                    packed=True, device="cpu").generate(_requests())
        got = dict(st)
    assert set(got) == want
    # per eager dispatch: 7 GEMMs a layer + the head, per prefill and step
    assert sum(v for k, v in got.items() if k.startswith("matmul:")) > len(
        want)


def test_dispatch_stats_scope_isolates_and_restores():
    pt = _tile_leaf(256, 128, dtype=torch.float32)
    x = torch.randn(4, 256)
    reg.dispatch_matmul(x, pt)
    before = reg.dispatch_stats()
    with reg.dispatch_stats_scope() as st:
        assert dict(st) == {}
        reg.dispatch_matmul(torch.randn(100, 256), pt)
        assert dict(st) == {"matmul:tile_pattern:m128": 1,
                            "plan_build:matmul:tile_pattern:gather": 1}
    after = reg.dispatch_stats()
    assert after["matmul:tile_pattern:m128"] == before.get(
        "matmul:tile_pattern:m128", 0) + 1
    assert after["matmul:tile_pattern:m32"] == before[
        "matmul:tile_pattern:m32"]
    reg.reset_dispatch_stats()
    assert reg.dispatch_stats() == {}


def test_dispatch_counter_follows_the_active_registry():
    pt = _tile_leaf(256, 128, dtype=torch.float32)
    x = torch.randn(4, 256)
    for _ in range(2):
        with registry_scope() as r:
            reg.dispatch_matmul(x, pt)
            reg.dispatch_matmul(x, pt)
            assert r.value("sparse.dispatch_total", kind="matmul",
                           scheme="tile_pattern", bucket=32) == 2


# ------------------------------------------------------------------ pipeline

def test_no_tune_changes_what_the_pipeline_writes(tmp_path, monkeypatch):
    from repro_torch.launch import pipeline
    from repro_torch.privacy import report

    tiny = dict(teacher_steps=2, retrain_steps=2, shadows=1,
                member_batches=1, cnn_batch=16, lm_batch=4, seq_len=16,
                n_boot=20)

    class _TinyConfig:
        @staticmethod
        def for_mode(quick, **overrides):
            return report.ReportConfig.for_mode(quick,
                                                **{**tiny, **overrides})

    monkeypatch.setattr(pipeline, "ReportConfig", _TinyConfig)
    cfg = reduced_config("qwen2-1.5b")
    plans = {}
    for flag in ((), ("--no-tune",)):
        out = tmp_path / ("plain" if flag else "tuned")
        assert pipeline.main(["--arch", "qwen2-1.5b", "--reduced",
                              "--quick", "--iters", "1", "--device", "cpu",
                              "--no-mia", "--out", str(out), *flag]) == 0
        d = str(out / "qwen2-1.5b" / "artifact")
        meta = json.load(open(os.path.join(d, "artifact.json")))["meta"]
        loaded = PrunedArtifact.load(d, cfg=cfg, device="cpu")
        plans[flag] = (meta.get("tuned_plans"),
                       tune.describe_plans(loaded.packed))
    tuned_report, tuned = plans[()]
    assert tuned and all(set(p) == {"plan_torch:matmul:m32"}
                         for p in tuned.values())
    assert set(tuned_report) == {f"{p}:plan_torch:matmul:m32"
                                 for p in tuned}
    assert plans[("--no-tune",)] == (None, {})


def test_serve_launcher_metrics_carry_dispatch_counts_and_tune_timings(
        tmp_path, monkeypatch):
    """``launch.serve --metrics-out``: the process-wide registry's packed
    dispatch counts, and under ``REPRO_AUTOTUNE=1`` the first dispatches'
    plan searches."""
    from repro_torch.launch import serve as launch_serve

    cfg = reduced_config("qwen2-1.5b")
    model = LM(cfg, device="cpu")
    art = greedy_prune(model.init(torch.Generator().manual_seed(0)),
                       PruneConfig(scheme="tile_pattern",
                                   exclude=DEFAULT_EXCLUDE,
                                   overrides={".*": {"tile_block_p": 32}}),
                       device="cpu").pack(device="cpu")
    d = str(tmp_path / "art")
    art.save(d)
    monkeypatch.setenv("REPRO_AUTOTUNE", "1")
    tune.clear_tuned_cache()
    out = str(tmp_path / "m.json")
    with registry_scope():
        launch_serve.main(["--arch", "qwen2-1.5b", "--reduced", "--artifact",
                           d, "--packed", "--requests", "2", "--batch", "2",
                           "--prompt-len", "6", "--max-new", "3",
                           "--device", "cpu", "--metrics-out", out])
    tune.clear_tuned_cache()
    metrics = json.load(open(out))["metrics"]
    counters = {(c["name"], c["labels"].get("bucket")): c["value"]
                for c in metrics["counters"]}
    # prefill at M = 2 x 6 and decode at M = 2: both in bucket m32
    assert counters[("sparse.dispatch_total", "32")] > 0
    assert counters[("sparse.plan_build_total", None)] > 0
    assert counters[("tune.candidates_total", None)] == len(
        _geometries(art.packed))
    assert "tune.search_seconds" in {h["name"]
                                     for h in metrics["histograms"]}
