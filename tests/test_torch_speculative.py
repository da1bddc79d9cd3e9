"""Speculative serving of the port against the reference's.

The same dense weights (the reference's, through
``convert.params_from_jax``) and the same numpy inputs go through
``repro``'s ``LM.verify_chunk`` / ``cache_snapshot`` / ``cache_rollback``
and ``SpeculativeEngine`` and the port's (on the CPU; packed GEMMs run
their plain versions). The model-level cases are pairs: the port within
2e-5 of the reference (geometry exact), and the port's verify chunk
within 2e-5 of its own K sequential ``decode_step``s, which the reference
misses on the CPU (its own contract tests fail there). Greedy speculative
tokens and ``stats`` must equal the reference's, and the tokens both
packages' ``ServeEngine``'s, for a packed, dense, full-model and 1-layer
shallow drafter. Sampled rows use the port's splitmix64 keys, so they are
held to the port: reproducible per request, and a chi-square test that
committed tokens follow softmax(target / T). The chaos cases (drafter
collapse, corrupt drafter artifact) demote and still serve the target's
tokens. Config: the reference's speculative test LM (2 layers, d_model
128, 4 / 2 heads of 32, d_ff 256, vocab 512), fp32, tile pattern 4 of 8
at ``tile_block_p`` 64.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats as sp_stats

from repro.configs.base import ModelConfig as JModelConfig
from repro.core import DEFAULT_EXCLUDE as J_EXCLUDE
from repro.core import PruneConfig as JPruneConfig
from repro.core import greedy_prune as j_greedy_prune
from repro.models import build_model
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro.serve import SpeculativeEngine as JSpeculativeEngine
from repro.serve import shallow_drafter as j_shallow_drafter
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import params_from_jax
from repro_torch.core import DEFAULT_EXCLUDE, PruneConfig, greedy_prune
from repro_torch.models import LM
from repro_torch.runtime import StragglerMonitor, trace_analysis
from repro_torch.runtime.telemetry import (
    MetricsRegistry,
    Telemetry,
    read_trace,
)
from repro_torch.serve import Request, ServeEngine
from repro_torch.serve import graphs as graphs_mod
from repro_torch.serve.speculative import SpeculativeEngine, shallow_drafter
from repro_torch.sparse import is_packed
from repro_torch.sparse.packed import validate_packed
from repro_torch.testing import corrupt_packed_index
from repro_torch.utils.tree import tree_items, tree_map_with_path

JCFG = JModelConfig(name="tiny", family="dense", num_layers=2, d_model=128,
                    num_heads=4, num_kv_heads=2, head_dim=32, d_ff=256,
                    vocab_size=512, param_dtype="float32")
TILE = {".*": {"tile_block_p": 64, "tile_group_q": 8, "tile_keep": 4}}
TOL = 2e-5
V = JCFG.vocab_size


@pytest.fixture(scope="module")
def both():
    """The reference's (model, params, packed artifact) and the port's."""
    jmodel = build_model(JCFG)
    np_params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    jparams = jax.tree.map(jnp.asarray, np_params)
    jart = j_greedy_prune(jparams, JPruneConfig(
        scheme="tile_pattern", exclude=tuple(J_EXCLUDE),
        overrides=TILE)).to_artifact(arch="tiny").pack()
    cfg = ModelConfig(**dataclasses.asdict(JCFG))
    model = LM(cfg, device="cpu")
    params = params_from_jax(np_params, cfg, "cpu")
    art = greedy_prune(params, PruneConfig(
        scheme="tile_pattern", exclude=DEFAULT_EXCLUDE, overrides=TILE),
        device="cpu").pack(device="cpu")
    return (jmodel, jparams, jart), (model, params, art)


def _clone(cache):
    return {k: ([t.clone() for t in v] if isinstance(v, list) else v.clone())
            for k, v in cache.items()}


def _np(cache):
    """A port cache in the reference's stacked layout, as numpy."""
    return {"k": torch.stack(cache["k"]).numpy(),
            "v": torch.stack(cache["v"]).numpy(),
            "slot_pos": cache["slot_pos"].numpy(),
            "pos": cache["pos"].numpy()}


def _assert_cache_close(got, want):
    """Geometry exact, k/v within 2e-5 (both numpy, stacked layout)."""
    for key in ("pos", "slot_pos"):
        np.testing.assert_array_equal(got[key], np.asarray(want[key]))
    for key in ("k", "v"):
        np.testing.assert_allclose(got[key], np.asarray(want[key]),
                                   rtol=0, atol=TOL)


def _prefill_both(both, prompts, seq_len):
    (jmodel, jparams, _), (model, params, _) = both
    jcache, _ = jmodel.prefill(jparams, jnp.asarray(prompts), seq_len)
    cache, _ = model.prefill(params, torch.from_numpy(prompts).long(),
                             seq_len)
    return jcache, cache


PROMPTS = np.stack([np.arange(6) % V, (np.arange(6) + 3) % V])


class TestVerifyChunk:
    def test_chunk_logits_match_reference(self, both):
        (jmodel, jparams, _), (model, params, _) = both
        jcache, cache = _prefill_both(both, PROMPTS, 32)
        toks = np.random.default_rng(0).integers(0, V, (2, 4))
        jc, jl = jmodel.verify_chunk(jparams, jcache,
                                     jnp.asarray(toks, jnp.int32))
        c, lg = model.verify_chunk(params, cache, torch.from_numpy(toks))
        np.testing.assert_allclose(lg.numpy(), np.asarray(jl), rtol=0,
                                   atol=TOL)
        _assert_cache_close(_np(c), jc)

    def test_chunk_logits_match_sequential_decode(self, both):
        """The port's own contract: a chunk of K equals K decode steps,
        logits within 2e-5, argmax equal, geometry exact."""
        _, (model, params, _) = both
        _, cache = _prefill_both(both, PROMPTS, 32)
        toks = torch.from_numpy(
            np.random.default_rng(0).integers(0, V, (2, 4)))
        seq_cache, seq = _clone(cache), []
        for i in range(4):
            _, lg = model.decode_step(params, seq_cache, toks[:, i:i + 1])
            seq.append(lg[:, 0])
        seq = torch.stack(seq, 1)
        _, ch = model.verify_chunk(params, cache, toks)
        assert (seq - ch).abs().max().item() <= TOL
        assert torch.equal(seq.argmax(-1), ch.argmax(-1))
        got, want = _np(cache), _np(seq_cache)
        _assert_cache_close(got, want)

    def test_rollback_equals_partial_decode(self, both):
        """Snapshot -> verify 5 -> rollback(keep=[2, 5]): geometry exact,
        the rejected rows bit-equal to the snapshot, the kept rows within
        2e-5 of row-wise partial decoding, and the cache within 2e-5 of
        the reference's rollback."""
        (jmodel, jparams, _), (model, params, _) = both
        prompts = np.stack([np.arange(6) % V, (np.arange(8) + 1)[:6]])
        jcache, cache = _prefill_both(both, prompts, 32)
        before = _clone(cache)
        toks = np.random.default_rng(1).integers(0, V, (2, 5))
        jsnap = jmodel.cache_snapshot(jcache, 5)
        jc, _ = jmodel.verify_chunk(jparams, jcache,
                                    jnp.asarray(toks, jnp.int32))
        jrb = jmodel.cache_rollback(jc, jsnap, jnp.asarray([2, 5],
                                                           jnp.int32))
        snap = model.cache_snapshot(cache, 5)
        model.verify_chunk(params, cache, torch.from_numpy(toks))
        model.cache_rollback(cache, snap, torch.tensor([2, 5]))
        assert cache["pos"].tolist() == [6 + 2, 6 + 5]
        got = _np(cache)
        _assert_cache_close(got, jrb)
        # row 0's rejected rows 8 .. 10: bit-equal to before the chunk
        old = _np(before)
        for key in ("k", "v"):
            np.testing.assert_array_equal(got[key][:, 0, 8:11],
                                          old[key][:, 0, 8:11])
        np.testing.assert_array_equal(got["slot_pos"][0, 8:11],
                                      old["slot_pos"][0, 8:11])
        # row-wise partial decoding: row 0 two steps, row 1 five (rows
        # never mix, so row b of one batched run is its own run)
        ref, states = _clone(before), []
        for i in range(5):
            model.decode_step(params, ref, torch.from_numpy(toks[:, i:i + 1]))
            states.append(_np(_clone(ref)))
        want = {k: v.copy() for k, v in states[4].items()}
        for k in ("k", "v"):
            want[k][:, 0] = states[1][k][:, 0]
        for k in ("slot_pos", "pos"):
            want[k][0] = states[1][k][0]
        _assert_cache_close(got, want)

    def test_rollback_on_freshly_admitted_slot(self, both):
        """Slots admitted by ``prefill_into_slot`` (their own pos and
        slot_pos rows) roll back independently: row 0 all the way back
        (bit-equal to before), row 1 keeping 3; as in the reference."""
        (jmodel, jparams, _), (model, params, _) = both
        p0, p1 = np.arange(10) % V, (np.arange(4) + 7) % V
        jcache = jmodel.init_cache(2, 32)
        cache = model.init_cache(2, 32)
        for slot, p in ((0, p0), (1, p1)):
            jcache, _ = jmodel.prefill_into_slot(
                jparams, jcache, jnp.asarray(p)[None], slot)
            model.prefill_into_slot(params, cache,
                                    torch.from_numpy(p)[None], slot)
        before = _clone(cache)
        toks = np.random.default_rng(3).integers(0, V, (2, 3))
        jsnap = jmodel.cache_snapshot(jcache, 3)
        jc, _ = jmodel.verify_chunk(jparams, jcache,
                                    jnp.asarray(toks, jnp.int32))
        jrb = jmodel.cache_rollback(jc, jsnap, jnp.asarray([0, 3],
                                                           jnp.int32))
        snap = model.cache_snapshot(cache, 3)
        model.verify_chunk(params, cache, torch.from_numpy(toks))
        model.cache_rollback(cache, snap, torch.tensor([0, 3]))
        assert cache["pos"].tolist() == [10, 7]
        _assert_cache_close(_np(cache), jrb)
        for key in ("k", "v"):
            assert all(torch.equal(a[0], b[0])
                       for a, b in zip(cache[key], before[key]))
        assert torch.equal(cache["slot_pos"][0], before["slot_pos"][0])

    def test_chunk_past_capacity_drops_as_reference(self, both):
        """A chunk running past a full cache's capacity drops the overflow
        writes, as the reference's scatter does; rollback across the edge
        matches the reference's too."""
        (jmodel, jparams, _), (model, params, _) = both
        jcache, cache = _prefill_both(both, PROMPTS, 8)
        toks = np.random.default_rng(4).integers(0, V, (2, 4))
        jsnap = jmodel.cache_snapshot(jcache, 4)
        jc, jl = jmodel.verify_chunk(jparams, jcache,
                                     jnp.asarray(toks, jnp.int32))
        snap = model.cache_snapshot(cache, 4)
        _, lg = model.verify_chunk(params, cache, torch.from_numpy(toks))
        _assert_cache_close(_np(cache), jc)
        # the in-range positions' logits (6, 7) agree
        np.testing.assert_allclose(lg[:, :2].numpy(), np.asarray(jl)[:, :2],
                                   rtol=0, atol=TOL)
        keep = [1, 2]
        jrb = jmodel.cache_rollback(jc, jsnap, jnp.asarray(keep, jnp.int32))
        model.cache_rollback(cache, snap, torch.tensor(keep))
        _assert_cache_close(_np(cache), jrb)


# --------------------------------------------------------------- engines

def _mixed(n=5):
    """Mixed prompt lengths and budgets, as numpy prompts."""
    return [((np.arange(3 + 4 * i) + i) % V, 4 + i) for i in range(n)]


def _reqs(specs, **kw):
    """The same requests for both packages."""
    jreqs = [JRequest(uid=i, prompt=jnp.asarray(p, jnp.int32),
                      max_new_tokens=m, **kw)
             for i, (p, m) in enumerate(specs)]
    reqs = [Request(uid=i, prompt=torch.from_numpy(p.astype(np.int64)),
                    max_new_tokens=m, **kw) for i, (p, m) in enumerate(specs)]
    return jreqs, reqs


def _drafters(both, kind):
    """(reference draft, reference draft model, port draft, port model)."""
    (jmodel, jparams, jart), (model, params, art) = both
    if kind == "packed":
        return jart, None, art, None
    if kind == "dense":
        return (jart.bind(jmodel, packed=False), None,
                art.bind(model, packed=False), None)
    if kind == "target":
        return jparams, None, params, None
    jdm, jdp = j_shallow_drafter(jmodel, jparams, 1)
    dm, dp = shallow_drafter(model, params, 1)
    return jdp, jdm, dp, dm


STATS = ("rounds", "dispatches", "drafted", "accepted", "acceptance_rate")


@pytest.fixture(scope="module")
def plain(both):
    """Greedy tokens of both packages' ServeEngine on ``_mixed()``."""
    (jmodel, jparams, _), (model, params, _) = both
    jreqs, reqs = _reqs(_mixed())
    want = [r.tokens for r in JServeEngine(
        jmodel, jparams, batch_size=4, max_seq_len=64).generate(jreqs)]
    got = [r.tokens for r in ServeEngine(
        model, params, batch_size=4, max_seq_len=64,
        device="cpu").generate(reqs)]
    assert got == want
    return want


@pytest.mark.parametrize("kind", ["packed", "dense", "target", "shallow"])
def test_greedy_tokens_and_stats_match_reference(both, plain, kind):
    (jmodel, jparams, _), (model, params, _) = both
    jdraft, jdm, draft, dm = _drafters(both, kind)
    jreqs, reqs = _reqs(_mixed())
    # never demoted: every token comes out of speculative rounds
    kw = dict(batch_size=4, max_seq_len=64, draft_k=4, demote_after=10**9)
    jeng = JSpeculativeEngine(jmodel, jparams, jdraft, draft_model=jdm, **kw)
    eng = SpeculativeEngine(model, params, draft, draft_model=dm,
                            device="cpu", **kw)
    want = [r.tokens for r in jeng.generate(jreqs)]
    out = eng.generate(reqs)
    assert [r.uid for r in out] == [r.uid for r in reqs]
    assert [r.tokens for r in out] == want == plain
    assert {k: eng.stats[k] for k in STATS} == \
        {k: jeng.stats[k] for k in STATS}
    assert eng.stats["demoted"] is False
    if kind == "target":
        assert eng.stats["acceptance_rate"] == 1.0
    # lockstep: both caches at the same positions, the same rows valid
    assert torch.equal(eng.target.cache["pos"], eng.drafter.cache["pos"])
    assert torch.equal(eng.target.cache["slot_pos"],
                       eng.drafter.cache["slot_pos"])


def test_draft_k_past_the_budget(both):
    """draft_k 8 against budgets of 3 and 1: overflow tokens dropped, the
    tokens and stats the reference's."""
    (jmodel, jparams, jart), (model, params, art) = both
    specs = [(np.arange(5) % V, 3), (np.arange(5) % V, 1)]
    jreqs, reqs = _reqs(specs)
    jeng = JSpeculativeEngine(jmodel, jparams, jparams, batch_size=2,
                              max_seq_len=64, draft_k=8)
    eng = SpeculativeEngine(model, params, params, batch_size=2,
                            max_seq_len=64, draft_k=8, device="cpu")
    want = [r.tokens for r in jeng.generate(jreqs)]
    got = [r.tokens for r in eng.generate(reqs)]
    assert got == want and [len(t) for t in got] == [3, 1]
    assert {k: eng.stats[k] for k in STATS} == \
        {k: jeng.stats[k] for k in STATS}
    dense = ServeEngine(model, params, batch_size=2, max_seq_len=64,
                        device="cpu")
    assert got == [r.tokens for r in dense.generate(reqs)]


def test_eos_trim(both, plain):
    """eos_id trims speculative output as the chunked engine does."""
    _, (model, params, art) = both
    specs = _mixed()
    eos = plain[3][2]
    _, reqs = _reqs(specs, eos_id=eos)
    eng = SpeculativeEngine(model, params, art, batch_size=4,
                            max_seq_len=64, draft_k=4, device="cpu")
    dense = ServeEngine(model, params, batch_size=4, max_seq_len=64,
                        device="cpu")
    got = [r.tokens for r in eng.generate(reqs)]
    assert got == [r.tokens for r in dense.generate(reqs)]
    assert got[3][-1] == eos and len(got[3]) <= 3


def test_capacity_validation(both):
    _, (model, params, art) = both
    eng = SpeculativeEngine(model, params, art, batch_size=2,
                            max_seq_len=16, draft_k=4, device="cpu")
    bad = Request(uid=0, prompt=torch.arange(10), max_new_tokens=8)
    with pytest.raises(ValueError, match="exceeds target cache"):
        eng.generate([bad])


def test_serve_engine_wiring(both, plain):
    """ServeEngine(speculative=...) routes generate through the
    speculative engine over its own cache, in both packages."""
    (jmodel, jparams, jart), (model, params, art) = both
    jreqs, reqs = _reqs(_mixed())
    jeng = JServeEngine(jmodel, jparams, batch_size=4, max_seq_len=64,
                        speculative=jart, draft_k=4)
    eng = ServeEngine(model, params, batch_size=4, max_seq_len=64,
                      speculative=art, draft_k=4, device="cpu")
    assert eng.speculative.target is eng
    assert [r.tokens for r in eng.generate(reqs)] == plain == \
        [r.tokens for r in jeng.generate(jreqs)]
    assert {k: eng.speculative.stats[k] for k in STATS} == \
        {k: jeng.speculative.stats[k] for k in STATS}


def test_shallow_drafter_shares_embed_and_head(both):
    _, (model, params, _) = both
    dm, dp = shallow_drafter(model, params, 1)
    assert dm.config.num_layers == 1
    assert dp["embed"] is params["embed"]
    assert dp["final_norm"] is params["final_norm"]
    assert len(dp["blocks"]) == 1 and dp["blocks"][0] is params["blocks"][0]
    for n in (0, model.config.num_layers + 1):
        with pytest.raises(ValueError):
            shallow_drafter(model, params, n)


class _FakeGraph:
    """A CPU stand-in for ``CountedGraph``: the warm-up runs once, a
    replay reruns the captured function."""

    def __init__(self, fn, pool, warmup=None):
        (warmup or fn)()
        self.fn, self.pool_bytes, self.launches, self.fallbacks = fn, 0, [], 0

    def replay(self):
        self.fn()


def test_round_graph_logic_matches_eager(both, plain, monkeypatch):
    """The graph path (one round graph per (B, K), R replays into the
    static blocks, prefill and decode graphs of both caches in one pool)
    rehearsed on the CPU with a replaying stand-in: the tokens and stats
    of the eager path, the round graph captured once."""
    _, (model, params, art) = both
    monkeypatch.setattr(graphs_mod, "CountedGraph", _FakeGraph)
    _, reqs = _reqs(_mixed())
    eager = SpeculativeEngine(model, params, art, batch_size=4,
                              max_seq_len=64, draft_k=4, device="cpu")
    eng = SpeculativeEngine(model, params, art, batch_size=4,
                            max_seq_len=64, draft_k=4, device="cpu")
    pool = types.SimpleNamespace(reserved=0)
    for e in (eng, eng.target, eng.drafter):
        e.graphs = True
    eng.target.graph_pool = eng.drafter.graph_pool = pool
    got = [r.tokens for r in eng.generate(reqs)]
    assert got == [r.tokens for r in eager.generate(reqs)] == plain
    assert eng.stats == eager.stats
    graph = eng.round_graph
    assert graph is not None and eng.drafter.prefill_graphs
    eng.generate(reqs)
    assert eng.round_graph is graph


# ------------------------------------------------------ sampled rows

def test_seeded_request_reproduces_across_engines_and_mates(both):
    _, (model, params, art) = both
    seeded = Request(uid=0, prompt=torch.arange(6), max_new_tokens=8,
                     temperature=0.8, seed=42)
    mate = Request(uid=1, prompt=torch.arange(6) + 9, max_new_tokens=8,
                   temperature=1.3, seed=5)

    def run(seed, reqs):
        eng = SpeculativeEngine(model, params, art, batch_size=2,
                                max_seq_len=64, draft_k=4, seed=seed,
                                device="cpu")
        return eng.generate(reqs)[0].tokens

    a = run(0, [seeded])
    assert a == run(123, [seeded]) == run(7, [seeded, mate])
    assert len(a) == 8 and all(0 <= t < V for t in a)


def test_greedy_mate_unaffected_by_a_sampled_row(both):
    (jmodel, jparams, _), (model, params, art) = both
    mixed = [Request(uid=0, prompt=torch.arange(6), max_new_tokens=8,
                     temperature=0.9, seed=7),
             Request(uid=1, prompt=torch.arange(6), max_new_tokens=8)]
    eng = SpeculativeEngine(model, params, art, batch_size=2,
                            max_seq_len=64, draft_k=4, device="cpu")
    want = JServeEngine(jmodel, jparams, batch_size=2, max_seq_len=64
                        ).generate([JRequest(uid=1, prompt=jnp.arange(6),
                                             max_new_tokens=8)])[0].tokens
    assert eng.generate(mixed)[1].tokens == want


CHI_CFG = ModelConfig(name="chi", family="dense", num_layers=1, d_model=32,
                      num_heads=2, num_kv_heads=1, head_dim=16, d_ff=64,
                      vocab_size=16, param_dtype="float32")


def test_committed_tokens_follow_the_target_distribution():
    """Rejection sampling on the port's keys: with a drafter of other
    weights, the first speculative token (drafted, or drawn from the
    residual) of N seeded requests follows softmax(target / T), given
    each request's first token: a chi-square goodness-of-fit at 0.001
    against the summed conditional probabilities."""
    T, N, B = 0.9, 1200, 16
    model = LM(CHI_CFG, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    draft = model.init(torch.Generator().manual_seed(1))
    prompt = torch.tensor([3, 1, 4, 1, 5])
    reqs = [Request(uid=i, prompt=prompt, max_new_tokens=2, temperature=T,
                    seed=1000 + i) for i in range(N)]
    eng = SpeculativeEngine(model, params, draft, batch_size=B,
                            max_seq_len=16, draft_k=2, demote_after=10**9,
                            device="cpu")
    out = [r.tokens for r in eng.generate(reqs)]
    assert eng.stats["demoted"] is False
    assert 0 < eng.stats["accepted"] < eng.stats["drafted"]
    first = torch.tensor([t[0] for t in out])
    seqs = torch.cat([prompt.expand(N, -1), first[:, None]], dim=1)
    h, _ = model.hidden_states(params, seqs)
    probs = torch.softmax(model.lm_logits(params, h[:, -1]) / T, dim=-1)
    expected = probs.double().sum(0).numpy()
    counts = np.bincount([t[1] for t in out], minlength=CHI_CFG.vocab_size)
    keep = expected > 5                        # pool sparse cells
    obs = np.append(counts[keep], counts[~keep].sum())
    exp = np.append(expected[keep], expected[~keep].sum())
    if exp[-1] == 0:
        obs, exp = obs[:-1], exp[:-1]
    exp *= obs.sum() / exp.sum()               # fp32 sums to N
    assert sp_stats.chisquare(obs, exp).pvalue > 1e-3


# --------------------------------------------------------------- chaos

def _solo(model, params, req):
    eng = ServeEngine(model, params, batch_size=1, max_seq_len=64,
                      device="cpu")
    return eng.generate([req])[0].tokens


def test_acceptance_collapse_demotes_output_identical(both):
    """A garbage drafter (re-initialised weights) collapses acceptance:
    the engine demotes and finishes on the target's own decode, the
    tokens those of the target alone."""
    _, (model, params, _) = both
    garbage = model.init(torch.Generator().manual_seed(99))
    req = Request(uid=0, prompt=torch.arange(6), max_new_tokens=48)
    eng = SpeculativeEngine(model, params, garbage, batch_size=1,
                            max_seq_len=64, draft_k=4, demote_after=8,
                            demote_below=0.5, device="cpu")
    out = eng.generate([req])
    assert out[0].status == "ok"
    assert out[0].tokens == _solo(model, params, req)
    assert eng.stats["demoted"] is True
    assert [d["at"] for d in eng.stats["demotions"]] == ["acceptance"]
    assert eng.stats["dispatches"] >= 2       # rounds, then plain decode


def test_corrupt_drafter_artifact_demotes_at_init(both):
    """A drafter artifact with an out-of-range packed index (bind serves
    the leaf dense) demotes at construction, never drafts, and serves the
    target's tokens."""
    _, (model, params, art) = both
    path = next(p for p, x in tree_items(art.packed) if is_packed(x))
    packed = tree_map_with_path(
        lambda p, x: corrupt_packed_index(x, seed=17) if p == path else x,
        art.packed)
    assert validate_packed(dict(tree_items(packed))[path]) is not None
    bad = dataclasses.replace(art, packed=packed)
    eng = SpeculativeEngine(model, params, bad, batch_size=1,
                            max_seq_len=64, draft_k=4, device="cpu")
    assert eng.demoted is True and eng.drafter is None
    assert eng._demotions[0]["at"] == "init"
    assert "verification" in eng._demotions[0]["reason"]
    req = Request(uid=0, prompt=torch.arange(6), max_new_tokens=12)
    out = eng.generate([req])
    assert out[0].tokens == _solo(model, params, req)
    assert eng.stats["demoted"] is True and eng.stats["rounds"] == 0


# ----------------------------------------------------------- telemetry

def test_stats_is_a_registry_view_and_the_trace_has_dispatches(both,
                                                               tmp_path):
    _, (model, params, art) = both
    _, reqs = _reqs(_mixed())
    reg = MetricsRegistry()
    path = str(tmp_path / "spec.jsonl")
    tel = Telemetry(metrics=reg, trace_path=path)
    kw = dict(batch_size=4, max_seq_len=64, draft_k=3, device="cpu")
    eng = SpeculativeEngine(model, params, art, telemetry=tel,
                            straggler=StragglerMonitor(), **kw)
    plain = SpeculativeEngine(model, params, art, **kw)
    assert ([r.tokens for r in eng.generate(reqs)]
            == [r.tokens for r in plain.generate(reqs)])
    tel.close()
    E = {"engine": "speculative"}
    for k in ("rounds", "dispatches", "drafted", "accepted"):
        assert eng.stats[k] == reg.value(f"spec.{k}_total", **E)
        assert eng.stats[k] == plain.stats[k]
    assert reg.value("spec.acceptance_rate", **E) == \
        pytest.approx(eng.stats["acceptance_rate"])
    assert reg.value("serve.requests_total", status="ok", **E) == len(reqs)
    assert reg.histogram("serve.ttft_seconds", **E).count == len(reqs)
    assert "straggler_events" in eng.stats
    records = read_trace(path)
    spans = [r for r in records if r["name"] == "spec_dispatch"]
    assert len(spans) == eng.stats["dispatches"]
    assert sum(r.get("rounds", 0) for r in spans) == eng.stats["rounds"]
    retires = {r["uid"]: r["status"] for r in records
               if r["name"] == "retire"}
    assert retires == {r.uid: "ok" for r in reqs}
    an = trace_analysis.analyze(path)
    assert len(an.by_name["spec_dispatch"]) == len(spans)
    assert len(an.by_name["retire"]) == len(reqs)


# ------------------------------------------------------------ launcher

def test_launcher_speculative_matches_plain(tmp_path):
    """``launch.serve --speculative DIR --draft-k 2`` on the reduced
    config: the saved artifact drafts packed, the same artifact's dense
    weights verify; the tokens those of the plain launcher."""
    from repro_torch.configs import reduced_config
    from repro_torch.launch import serve

    cfg = reduced_config("qwen2-1.5b")
    model = LM(cfg, device="cpu")
    art = greedy_prune(model.init(torch.Generator().manual_seed(0)),
                       PruneConfig(scheme="tile_pattern",
                                   exclude=DEFAULT_EXCLUDE,
                                   overrides={".*": {"tile_block_p": 32}}),
                       device="cpu").pack(device="cpu")
    art.save(str(tmp_path / "art"))
    base = ["--arch", "qwen2-1.5b", "--reduced", "--requests", "3",
            "--batch", "2", "--prompt-len", "6", "--max-new", "6",
            "--max-seq", "64", "--device", "cpu", "--artifact",
            str(tmp_path / "art")]
    want = [r.tokens for r in serve.main(base)]
    got = serve.main(base + ["--speculative", str(tmp_path / "art"),
                             "--draft-k", "2"])
    assert [r.tokens for r in got] == want
    assert [len(t) for t in want] == [6] * 3
