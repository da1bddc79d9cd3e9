"""The port's kernel profiler (``repro_torch/runtime/profiler.py``) against
the reference's ``repro/runtime/profiler.py``, on the CPU: the same call
sequences give the same events, walls and samples; values are untouched;
dispatch counts are the same with the profiler on and off; the engines'
walls are recorded with tokens identical; a packed dispatch's
``bytes_per_call`` is the reference's count for the same leaf."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.schemes import LayerSpec as JLayerSpec
from repro.runtime.profiler import KernelProfiler as JKernelProfiler
from repro.runtime.telemetry import MetricsRegistry as JMetricsRegistry
from repro.sparse.registry import handler_for as j_handler_for
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import packed_from_jax
from repro_torch.core import DEFAULT_EXCLUDE, LayerSpec, PruneConfig
from repro_torch.core import greedy_prune
from repro_torch.models import LM
from repro_torch.runtime import (KernelProfiler, get_profiler,
                                 profiler_scope, set_profiler)
from repro_torch.runtime.telemetry import MetricsRegistry
from repro_torch.serve import ContinuousEngine, Request, ServeEngine
from repro_torch.sparse.registry import (dispatch_matmul, dispatch_stats,
                                         dispatch_stats_scope, handler_for)
from repro_torch.testing import ScriptedClock


def _tile_leaf(seed=3):
    rng = np.random.default_rng(seed)
    w = torch.from_numpy(rng.standard_normal((64, 128)).astype(np.float32))
    spec = LayerSpec(scheme="tile_pattern", tile_block_p=64, tile_group_q=8,
                     tile_keep=4)
    return handler_for("tile_pattern").pack(spec.project(w), spec)


def _counts(prof):
    return sorted((k, r.events, r.walls, r.samples)
                  for k, r in prof._res.items())


# ------------------------------------------------------------------- core

class TestProfilerCore:
    def test_default_is_inert(self):
        prof = get_profiler()
        assert not prof.active
        assert prof.wall("matmul", lambda a: a + 1, (1,)) == 2
        assert prof.report() == []

    def test_sample_rate_validated(self):
        for bad in (0.0, 1.5):
            with pytest.raises(ValueError):
                KernelProfiler(sample_rate=bad)

    @pytest.mark.parametrize("rate,warmup,calls", [
        (0.5, 1, 8), (1.0, 0, 5), (0.25, 2, 11), (1 / 3, 1, 10)])
    def test_wall_counts_equal_reference(self, rate, warmup, calls):
        mine = KernelProfiler(sample_rate=rate, warmup=warmup,
                              registry=MetricsRegistry())
        ref = JKernelProfiler(sample_rate=rate, warmup=warmup,
                              registry=JMetricsRegistry())
        assert mine.stride == ref.stride
        for i in range(calls):
            key = dict(scheme="s", bucket=32 if i % 3 else 64, plan="p",
                       nbytes=100.0)
            mine.wall("matmul", lambda: torch.zeros(4), (), **key)
            ref.wall("matmul", lambda: jnp.zeros(4), (), **key)
        mine_rows, ref_rows = mine.report(), ref.report()
        assert _counts(mine) == _counts(ref)
        strip = [{k: r[k] for k in ("kind", "scheme", "bucket", "plan",
                                    "events", "samples", "bytes_per_call")}
                 for r in mine_rows]
        assert strip == [{k: r[k] for k in strip[0]} for r in ref_rows]
        for name in ("profiler.events_total", "profiler.samples_total"):
            for b in (32, 64):
                labels = dict(kind="matmul", scheme="s", bucket=b)
                assert (mine.registry.value(name, **labels)
                        == ref.registry.value(name, **labels))
        assert (mine.registry.value("profiler.bytes_streamed_total",
                                    kind="matmul", scheme="s")
                == ref.registry.value("profiler.bytes_streamed_total",
                                      kind="matmul", scheme="s"))

    def test_observe_counts_equal_reference(self):
        mine = KernelProfiler(sample_rate=0.25, warmup=2,
                              registry=MetricsRegistry())
        ref = JKernelProfiler(sample_rate=0.25, warmup=2,
                              registry=JMetricsRegistry())
        for p in (mine, ref):
            for _ in range(5):
                p.observe("decode_many", 0.01, scheme="engine:chunked",
                          bucket=8, plan="-", nbytes=10.0)
        (row,) = mine.report()
        assert row["events"] == 5 and row["samples"] == 3
        assert _counts(mine) == _counts(ref)
        assert row["measured_ns"] == ref.report()[0]["measured_ns"]

    def test_ring_is_bounded(self):
        prof = KernelProfiler(warmup=0, reservoir=4,
                              registry=MetricsRegistry())
        for i in range(10):
            prof.observe("k", float(i), scheme="s", bucket=1)
        (row,) = prof.report()
        assert row["samples"] == 10
        assert sorted(prof._res[("k", "s", 1, "-")].values) == [6, 7, 8, 9]

    def test_scope_restores_previous(self):
        before = get_profiler()
        with profiler_scope(sample_rate=1.0) as prof:
            assert get_profiler() is prof
            with profiler_scope(KernelProfiler(enabled=False)):
                assert not get_profiler().active
            assert get_profiler() is prof
        assert get_profiler() is before

    def test_set_profiler_returns_previous(self):
        before = get_profiler()
        prof = KernelProfiler()
        assert set_profiler(prof) is before
        assert set_profiler(before) is prof
        assert set_profiler(None) is before
        assert not get_profiler().active
        set_profiler(before)


# -------------------------------------------------------- the dispatch hook

class TestDispatchHook:
    def test_eager_dispatch_recorded_and_values_untouched(self):
        pt = _tile_leaf()
        x = torch.randn(16, 64, generator=torch.Generator().manual_seed(5))
        y_plain = dispatch_matmul(x, pt)
        with profiler_scope(sample_rate=1.0, warmup=0) as prof:
            y_prof = dispatch_matmul(x, pt)
        assert torch.equal(y_plain, y_prof)
        (row,) = [r for r in prof.report() if r["kind"] == "matmul"]
        assert row["scheme"] == "tile_pattern" and row["bucket"] == 32
        assert row["plan"] == "heuristic"
        assert row["events"] == 1 and row["samples"] == 1
        assert row["bytes_per_call"] > pt.packed_bytes()

    def test_a_tuned_leaf_is_labelled_with_its_plan(self):
        from repro_torch.sparse import tune

        tree, _ = tune.tune_packed_tree({"w": _tile_leaf()}, (16,), iters=1)
        with profiler_scope(sample_rate=1.0, warmup=0) as prof:
            dispatch_matmul(torch.randn(16, 64), tree["w"])
        assert [r["plan"] for r in prof.report()] == ["gather"]

    def test_bytes_per_call_is_the_references_count(self):
        """The same leaf in both packages, the same x: the reference's
        ``wall_dispatch`` count (packed buffers + x + M x shape[-1]
        outputs of x's dtype)."""
        rng = np.random.default_rng(4)
        w = rng.standard_normal((64, 128)).astype(np.float32)
        jspec = JLayerSpec(scheme="tile_pattern", tile_block_p=64,
                           tile_group_q=8, tile_keep=4)
        jpt = j_handler_for("tile_pattern").pack(
            jspec.project(jnp.asarray(w)), jspec)
        pt = packed_from_jax({"w": jax.tree.map(np.asarray, jpt)}, None,
                             "cpu")["w"]
        x = rng.standard_normal((24, 64)).astype(np.float32)
        mine = KernelProfiler(warmup=0, registry=MetricsRegistry())
        ref = JKernelProfiler(warmup=0, registry=JMetricsRegistry())
        mine.wall_dispatch("matmul", pt, 24, "p", lambda x, pt, b: x,
                           (torch.from_numpy(x), pt, None))
        ref.wall_dispatch("matmul", jpt, 24, "p", lambda x, pt, b: x,
                          (jnp.asarray(x), jpt, None))
        assert (mine.report()[0]["bytes_per_call"]
                == ref.report()[0]["bytes_per_call"])

    def test_dispatch_counts_identical_on_vs_off(self):
        x = torch.randn(8, 64)
        with dispatch_stats_scope():
            dispatch_matmul(x, _tile_leaf())      # a fresh leaf each time
            off = dict(dispatch_stats())
        with dispatch_stats_scope():
            with profiler_scope(sample_rate=1.0):
                dispatch_matmul(x, _tile_leaf())
            on = dict(dispatch_stats())
        assert off == on == {"matmul:tile_pattern:m32": 1,
                             "plan_build:matmul:tile_pattern:gather": 1}


# ------------------------------------------------------------ engine walls

CFG = ModelConfig(name="tiny", family="dense", num_layers=2, d_model=128,
                  num_heads=4, num_kv_heads=2, head_dim=32, d_ff=256,
                  vocab_size=512, param_dtype="float32")


@pytest.fixture(scope="module")
def setup():
    model = LM(CFG, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    art = greedy_prune(params, PruneConfig(
        scheme="tile_pattern", exclude=DEFAULT_EXCLUDE,
        overrides={".*": {"tile_block_p": 64}}), device="cpu").pack(
        device="cpu")
    reqs = [Request(uid=i, prompt=torch.arange(8 + i) % CFG.vocab_size,
                    max_new_tokens=5) for i in range(3)]
    return model, params, art, reqs


class TestEngineWalls:
    def test_walls_recorded_tokens_identical(self, setup):
        model, params, _, reqs = setup
        eng = ServeEngine(model, params, batch_size=4, max_seq_len=64,
                          device="cpu")
        plain = [r.tokens for r in eng.generate(reqs)]
        with profiler_scope(sample_rate=1.0, warmup=0) as prof:
            profiled = [r.tokens for r in eng.generate(reqs)]
        assert plain == profiled
        kinds = {r["kind"]: r for r in prof.report()}
        assert set(kinds) == {"prefill", "decode_many"}
        for row in kinds.values():
            assert row["scheme"] == "engine:chunked"
            assert row["samples"] == 1 and row["bytes_per_call"] > 0
        assert kinds["prefill"]["bucket"] >= kinds["decode_many"]["bucket"]

    def test_packed_engine_walls_dispatches_too(self, setup):
        model, _, art, reqs = setup
        eng = ServeEngine(model, art, batch_size=4, max_seq_len=64,
                          packed=True, device="cpu")
        plain = [r.tokens for r in eng.generate(reqs)]
        with dispatch_stats_scope():
            eng.generate(reqs)
            off = dict(dispatch_stats())
        with dispatch_stats_scope():
            with profiler_scope(sample_rate=1.0, warmup=0) as prof:
                profiled = [r.tokens for r in eng.generate(reqs)]
            on = dict(dispatch_stats())
        assert plain == profiled and off == on
        kinds = {(r["kind"], r["scheme"]) for r in prof.report()}
        assert kinds == {("prefill", "engine:chunked"),
                         ("decode_many", "engine:chunked"),
                         ("matmul", "tile_pattern")}

    def test_continuous_chunks_observed(self, setup):
        model, params, _, reqs = setup
        eng = ContinuousEngine(model, params, batch_size=2, max_seq_len=64,
                               chunk_steps=2, device="cpu")
        plain = [r.tokens for r in eng.generate(reqs)]
        with profiler_scope(sample_rate=1.0, warmup=0) as prof:
            profiled = [r.tokens for r in eng.generate(
                reqs, clock=ScriptedClock([], tail_step=0.01))]
        assert plain == profiled
        (row,) = prof.report()
        assert (row["kind"], row["scheme"]) == ("decode_many",
                                                "engine:continuous")
        assert row["samples"] == eng.stats["chunks"]
        assert row["bucket"] == 32 and row["bytes_per_call"] > 0
