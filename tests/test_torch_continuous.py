"""The continuous-batching engine against the reference's.

The same dense weights (the reference's, through
``convert.params_from_jax``), pruned by each package and packed, and the
same numpy prompts go through ``repro``'s ``ContinuousEngine`` and the
port's (eagerly on the CPU; the packed GEMMs run their plain versions):
greedy tokens and ``Result.status`` must be identical request by request,
dense, tile-pattern and column packed. Inside the port the bar is the
reference's own: continuous == static == solo on equal lengths,
continuous == solo on mixed lengths, and a seeded temperature request
independent of admission timing (the port's splitmix64 streams are not
JAX's, so sampled tokens are held to the port only). Config: the
reference's continuous-serve test config (2 layers, d_model 128, 4 / 2
heads of 32, d_ff 256, vocab 512), fp32. Each reference engine compiles
once per prompt length and chunk length, so the engines are built once
per module and prompt lengths are few.
"""

import dataclasses

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
from repro.serve import ContinuousEngine as JContinuousEngine
from repro.serve import Request as JRequest
from repro.testing import ScriptedClock as JScriptedClock
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import params_from_jax
from repro_torch.core import DEFAULT_EXCLUDE, PruneConfig, greedy_prune
from repro_torch.models import LM
from repro_torch.serve import (
    ContinuousEngine,
    Request,
    Scheduler,
    ServeEngine,
    SlotTable,
    trim_at_eos,
)
from repro_torch.testing import ScriptedClock

JCFG = JModelConfig(name="tiny", family="dense", num_layers=2, d_model=128,
                    num_heads=4, num_kv_heads=2, head_dim=32, d_ff=256,
                    vocab_size=512, param_dtype="float32")
TILE = {".*": {"tile_block_p": 64, "tile_group_q": 8, "tile_keep": 4}}
SCHEMES = {"tile_pattern": dict(scheme="tile_pattern", overrides=TILE),
           "column": dict(scheme="column", alpha=0.5)}
# mixed prompt lengths and budgets: with batch 2, five requests reuse the
# slots after retirements; one prompt length repeats
PROMPT_LENS = (5, 9, 12, 5, 9)
MAX_NEW = (4, 7, 3, 6, 5)
B, MAX_SEQ, CHUNK = 2, 64, 4


def _prompts(lens=PROMPT_LENS, seed=7):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, JCFG.vocab_size, n).astype(np.int32)
            for n in lens]


@pytest.fixture(scope="module")
def both():
    """Per serving mode ("dense", "tile_pattern", "column"): (reference
    engine, port engine); plus the port's model and params."""
    jmodel = build_model(JCFG)
    np_params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    jparams = jax.tree.map(jnp.asarray, np_params)
    cfg = ModelConfig(**dataclasses.asdict(JCFG))
    model = LM(cfg, device="cpu")
    params = params_from_jax(np_params, cfg, "cpu")
    kw = dict(batch_size=B, max_seq_len=MAX_SEQ, chunk_steps=CHUNK)
    engines = {"dense": (JContinuousEngine(jmodel, jparams, **kw),
                         ContinuousEngine(model, params, device="cpu", **kw))}
    for name, pkw in SCHEMES.items():
        jart = j_greedy_prune(jparams, JPruneConfig(
            exclude=tuple(J_EXCLUDE), **pkw)).to_artifact().pack()
        art = greedy_prune(params, PruneConfig(
            exclude=DEFAULT_EXCLUDE, **pkw), device="cpu").pack(device="cpu")
        engines[name] = (
            JContinuousEngine(jmodel, jart, packed=True, **kw),
            ContinuousEngine(model, art, packed=True, device="cpu", **kw))
    return engines, model, params


def _reqs(prompts, max_new, eos=None):
    """The same requests for both packages."""
    eos = eos or {}
    jreqs = [JRequest(uid=i, prompt=jnp.asarray(p), max_new_tokens=m,
                      eos_id=eos.get(i)) for i, (p, m) in
             enumerate(zip(prompts, max_new))]
    reqs = [Request(uid=i, prompt=torch.from_numpy(p.astype(np.int64)),
                    max_new_tokens=m, eos_id=eos.get(i)) for i, (p, m) in
            enumerate(zip(prompts, max_new))]
    return jreqs, reqs


def _outcome(results):
    return [(r.uid, r.tokens, r.status) for r in results]


@pytest.mark.parametrize("mode", ["dense", "tile_pattern"])
def test_mixed_lengths_slot_reuse_and_eos_match_reference(both, mode):
    """Mixed lengths, per-request budgets, slot reuse after retirements,
    then the same workload with one request stopped at its own eos."""
    engines, _, _ = both
    jeng, eng = engines[mode]
    jreqs, reqs = _reqs(_prompts(), MAX_NEW)
    want = jeng.generate(jreqs)
    got = eng.generate(reqs)
    assert _outcome(got) == _outcome(want)
    assert [len(r.tokens) for r in got] == list(MAX_NEW)
    assert eng.stats["chunks"] == jeng.stats["chunks"]
    assert eng.stats["busy_slot_steps"] == jeng.stats["busy_slot_steps"]
    eos = {1: want[1].tokens[2]}
    jreqs, reqs = _reqs(_prompts(), MAX_NEW, eos)
    want = jeng.generate(jreqs)
    got = eng.generate(reqs)
    assert _outcome(got) == _outcome(want)
    assert got[1].tokens == trim_at_eos(want[1].tokens, eos[1])
    assert got[1].tokens[-1] == eos[1] and len(got[1].tokens) <= 3


def test_column_packed_matches_reference(both):
    engines, _, _ = both
    jeng, eng = engines["column"]
    jreqs, reqs = _reqs(_prompts(), MAX_NEW)
    assert _outcome(eng.generate(reqs)) == _outcome(jeng.generate(jreqs))


@pytest.mark.parametrize("mode", ["dense", "tile_pattern"])
def test_equal_lengths_match_reference(both, mode):
    engines, _, _ = both
    jeng, eng = engines[mode]
    jreqs, reqs = _reqs(_prompts((9,) * 4, seed=3), (5,) * 4)
    assert _outcome(eng.generate(reqs)) == _outcome(jeng.generate(jreqs))


def test_scripted_arrivals_match_reference(both):
    """Arrivals on a scripted engine clock: the same admissions, the same
    statuses (a deadline that passes while the request queues, another
    mid-stream) and the same tokens."""
    engines, _, _ = both
    jeng, eng = engines["dense"]
    prompts = _prompts()
    arrivals = [0.0, 0.5, 3.0, 3.0, 9.0]
    deadlines = {2: 2.5, 3: 8.0}
    jreqs, reqs = _reqs(prompts, (6, 6, 6, 24, 6))
    for i, d in deadlines.items():
        jreqs[i].deadline = reqs[i].deadline = d
    want = jeng.generate(jreqs, arrivals=arrivals,
                         clock=JScriptedClock([], tail_step=0.25))
    got = eng.generate(reqs, arrivals=arrivals,
                       clock=ScriptedClock([], tail_step=0.25))
    assert _outcome(got) == _outcome(want)
    assert [r.status for r in got] == ["ok", "ok", "timeout", "timeout",
                                       "ok"]
    assert got[2].tokens == [] and 0 < len(got[3].tokens) < 24
    assert eng.stats == jeng.stats


# ------------------------------------------------------- inside the port


def _solo(model, params, reqs):
    eng = ServeEngine(model, params, batch_size=1, max_seq_len=MAX_SEQ,
                      device="cpu")
    return [eng.generate([r])[0].tokens for r in reqs]


def test_continuous_static_and_solo_agree(both):
    """Equal lengths: continuous == static == solo; mixed lengths:
    continuous == solo (the static engine's padding differs there)."""
    engines, model, params = both
    _, eng = engines["dense"]
    _, reqs = _reqs(_prompts((8,) * 4, seed=5), (5,) * 4)
    solo = _solo(model, params, reqs)
    static = ServeEngine(model, params, batch_size=B, max_seq_len=MAX_SEQ,
                         device="cpu")
    assert [r.tokens for r in static.generate(reqs)] == solo
    assert [r.tokens for r in eng.generate(reqs)] == solo
    _, reqs = _reqs(_prompts(), MAX_NEW)
    assert [r.tokens for r in eng.generate(reqs)] == _solo(model, params,
                                                           reqs)


def test_stream_yields_in_completion_order(both):
    engines, _, _ = both
    _, eng = engines["dense"]
    _, reqs = _reqs(_prompts((6, 6)), (12, 2))
    streamed = list(eng.stream(reqs))
    assert [r.uid for r in streamed] == [1, 0]
    assert {r.uid: r.tokens for r in streamed} == {
        r.uid: r.tokens for r in eng.generate(reqs)}


def test_seeded_request_independent_of_admission_timing(both):
    """A seeded temperature request gives the same tokens served alone and
    among temperature batch-mates admitted around it, on engines of other
    seeds: its key stream follows its own token index."""
    engines, model, params = both
    prompts = _prompts((6, 4, 7, 10), seed=11)
    seeded = Request(uid=0, prompt=torch.from_numpy(prompts[0].astype(
        np.int64)), max_new_tokens=7, temperature=0.9, seed=77)
    mates = [Request(uid=i, prompt=torch.from_numpy(p.astype(np.int64)),
                     max_new_tokens=5 + i, temperature=1.1)
             for i, p in enumerate(prompts[1:], 1)]
    solo = ContinuousEngine(model, params, batch_size=1, max_seq_len=MAX_SEQ,
                            chunk_steps=3, seed=0, device="cpu")
    alone = solo.generate([seeded])[0].tokens
    busy = ContinuousEngine(model, params, batch_size=B, max_seq_len=MAX_SEQ,
                            chunk_steps=4, seed=5, device="cpu")
    out = busy.generate(mates[:1] + [seeded] + mates[1:],
                        arrivals=[0.0, 1.0, 0.0, 2.0],
                        clock=ScriptedClock([], tail_step=0.5))
    assert out[1].tokens == alone and len(alone) == 7
    greedy = _solo(model, params, [dataclasses.replace(
        seeded, temperature=None)])[0]
    assert alone != greedy


def test_capacity_validation(both):
    _, model, params = both
    eng = ContinuousEngine(model, params, batch_size=2, max_seq_len=16,
                           chunk_steps=4, device="cpu")
    with pytest.raises(ValueError, match="exceeds cache capacity"):
        eng.generate([Request(uid=0, prompt=list(range(10)),
                              max_new_tokens=16)])


def test_prefill_into_slot_writes_only_its_row(both):
    """Row ``slot`` gets the solo prefill's k/v, positions and pos; every
    other row keeps its bytes; the logits are the solo prefill's."""
    _, model, params = both
    cache = model.init_cache(3, 32)
    for t in cache["k"] + cache["v"]:
        t.normal_(generator=torch.Generator().manual_seed(1))
    cache["slot_pos"].fill_(4)
    before = {n: [t.clone() for t in cache[n]] for n in ("k", "v")}
    sp, pos = cache["slot_pos"].clone(), cache["pos"].clone()
    prompt = torch.arange(1, 10).view(1, 9)
    _, logits = model.prefill_into_slot(params, cache, prompt, 1)
    solo, want = model.prefill(params, prompt, 32)
    assert torch.equal(logits, want)
    for n in ("k", "v"):
        for got, old, ref in zip(cache[n], before[n], solo[n]):
            assert torch.equal(got[[0, 2]], old[[0, 2]])
            assert torch.equal(got[1, :9], ref[0, :9])
            assert torch.equal(got[1, 9:], old[1, 9:])
    assert torch.equal(cache["slot_pos"][[0, 2]], sp[[0, 2]])
    assert cache["slot_pos"][1].tolist() == list(range(9)) + [-1] * 23
    assert cache["pos"].tolist() == [int(pos[0]), 9, int(pos[2])]


def test_decode_flags_observe_without_changing_tokens(both):
    _, model, params = both
    prompts = torch.from_numpy(np.stack(_prompts((6, 6))).astype(np.int64))
    tok = torch.zeros((2, 1), dtype=torch.int64)
    runs = []
    for flags in (False, True):
        cache, _ = model.prefill(params, prompts, 32)
        runs.append(model.decode_many(params, cache, tok, 5,
                                      with_flags=flags))
    assert torch.equal(runs[0][1], runs[1][1])
    assert runs[1][2].shape == (2, 5) and bool(runs[1][2].all())


# ------------------------------------------- the host side (reference's)


def test_slot_table_free_list():
    t = SlotTable(2)
    a = t.admit(0, Request(uid=0, prompt=[0, 1]))
    b = t.admit(1, Request(uid=1, prompt=[0, 1]))
    assert t.num_free == 0 and {a.slot, b.slot} == {0, 1}
    with pytest.raises(RuntimeError):
        t.admit(2, Request(uid=2, prompt=[0, 1]))
    t.retire(a.slot)
    c = t.admit(2, Request(uid=2, prompt=[0, 1]))
    assert c.slot == a.slot
    assert list(t.active_mask()) == [1, 1]


def test_scheduler_fifo_and_arrival_gating():
    s = Scheduler(batch_size=2, chunk_steps=4)
    for i, arr in enumerate((0.0, 0.0, 1.0)):
        s.submit(i, Request(uid=i, prompt=[0, 1], max_new_tokens=4), arr)
    assert [st.order for st in s.ready_admissions(now=0.0)] == [0, 1]
    assert s.pending == 1 and s.next_arrival() == 1.0
    assert s.chunk_len() == 4
    done = s.absorb_chunk(np.zeros((2, 4), np.int64), 4)
    assert sorted(st.order for st in done) == [0, 1]
    assert [st.order for st in s.ready_admissions(now=2.0)] == [2]


def test_occupancy_accounting():
    s = Scheduler(batch_size=4, chunk_steps=8)
    s.submit(0, Request(uid=0, prompt=[0, 1], max_new_tokens=8))
    list(s.ready_admissions(0.0))
    s.absorb_chunk(np.zeros((4, 8), np.int64), 8)
    assert s.occupancy() == pytest.approx(8 / 32)


def test_chunk_len_rounds_up_to_a_power_of_two():
    s = Scheduler(batch_size=2, chunk_steps=8)
    assert s.chunk_len() == 1                  # no live slot: never 0
    s.submit(0, Request(uid=0, prompt=[0], max_new_tokens=3))
    list(s.ready_admissions(0.0))
    assert s.chunk_len() == 4
