"""Sliding-window models of the port against the reference's.

A windowed model attends to the last ``window`` positions and serves from
a ring cache of ``window`` slots (position p in slot p % C). The same
weights (the reference's init, through ``convert.params_from_jax``) and
the same numpy inputs go through ``repro`` and the port on the CPU:

- ring geometry (``slot_prompt_rows``, ``insert_slots`` / ``cache_insert``,
  ``chunk_rows`` / ``chunk_slots``) equal to the reference's exactly;
- prefill and decode logits through the wrap within fp32 2e-5, slot
  positions exact, for the reference's speculative-test ``tinyw`` config
  (window 8), ``reduced_config("h2o-danube-1.8b")`` (window 32) and the
  same at head_dim 80, including the reference's two ring rules (a
  ``seq_len <= window`` prefill writes a full cache that decode wraps);
- the training forward and the layer-wise ADMM adapter's layer apply;
- greedy tokens of ``ServeEngine`` (dense and tile packed),
  ``ContinuousEngine`` (tokens and statuses) and ``SpeculativeEngine``
  (tokens and ``stats``) equal to the reference's;
- the reference's ring speculative cases, held to the reference and to
  the port's own sequential decode; a verify chunk longer than the ring
  raises;
- ``launch.prune`` then ``launch.serve --arch h2o-danube-1.8b --reduced``;
- every registered config equals the reference's, and the other two
  dense configs serve the reference's greedy tokens reduced.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced_config as j_reduced_config
from repro.configs.base import ModelConfig as JModelConfig
from repro.core import DEFAULT_EXCLUDE as J_EXCLUDE
from repro.core import LMAdapter as JLMAdapter
from repro.core import PruneConfig as JPruneConfig
from repro.core import greedy_prune as j_greedy_prune
from repro.models import attention as jatt
from repro.models import build_model
from repro.serve import ContinuousEngine as JContinuousEngine
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro.serve import SpeculativeEngine as JSpeculativeEngine
from repro.serve import shallow_drafter as j_shallow_drafter
from repro_torch.configs import ARCHS, get_config, reduced_config
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import params_from_jax
from repro_torch.core import DEFAULT_EXCLUDE, LMAdapter, PruneConfig
from repro_torch.core import greedy_prune
from repro_torch.models import LM
from repro_torch.models import attention as att
from repro_torch.serve import ContinuousEngine, Request, ServeEngine
from repro_torch.serve.speculative import SpeculativeEngine, shallow_drafter

TOL = 2e-5
TINYW = JModelConfig(name="tinyw", family="dense", num_layers=2, d_model=32,
                     num_heads=4, num_kv_heads=2, d_ff=64, vocab_size=64,
                     param_dtype="float32", sliding_window=8)
DANUBE = j_reduced_config("h2o-danube-1.8b")           # window 32, hd 16
CONFIGS = {"tinyw": TINYW, "danube": DANUBE,
           "danube_hd80": dataclasses.replace(DANUBE, head_dim=80)}
TILE = {".*": {"tile_block_p": 32}}


def _pair(jcfg, seed=1):
    """(reference model, params) and (port model, params), same weights."""
    jmodel = build_model(jcfg)
    np_params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(seed)))
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    return ((jmodel, jax.tree.map(jnp.asarray, np_params)),
            (LM(cfg, device="cpu"), params_from_jax(np_params, cfg, "cpu")))


@pytest.fixture(scope="module")
def tinyw():
    return _pair(TINYW)


@pytest.fixture(scope="module")
def danube():
    return _pair(DANUBE)


def _np(cache):
    """A port cache in the reference's stacked layout, as numpy."""
    return {"k": torch.stack(cache["k"]).numpy(),
            "v": torch.stack(cache["v"]).numpy(),
            "slot_pos": cache["slot_pos"].numpy(),
            "pos": cache["pos"].numpy()}


def _assert_cache_close(got, want, atol=TOL):
    """Geometry exact, k/v within ``atol`` (stacked layout)."""
    for key in ("pos", "slot_pos"):
        np.testing.assert_array_equal(got[key], np.asarray(want[key]))
    for key in ("k", "v"):
        np.testing.assert_allclose(got[key], np.asarray(want[key]),
                                   rtol=0, atol=atol)


def _clone(cache):
    return {k: ([t.clone() for t in v] if isinstance(v, list) else v.clone())
            for k, v in cache.items()}


# ------------------------------------------------------------ ring geometry

@pytest.mark.parametrize("C,S,ring", [
    (8, 5, True), (8, 8, True), (8, 12, True), (8, 17, True), (32, 40, True),
    (8, 5, False), (8, 8, False)])
def test_slot_prompt_rows_match_reference(C, S, ring):
    rows, keep, sp = att.slot_prompt_rows(C, S, ring)
    jrows, jkeep, jsp = jatt.slot_prompt_rows(C, S, ring)
    assert keep == jkeep == min(C, S)
    np.testing.assert_array_equal(rows.numpy(), np.asarray(jrows))
    np.testing.assert_array_equal(sp.numpy(), np.asarray(jsp))


def test_slot_prompt_rows_refuse_a_long_prompt_in_a_full_cache():
    with pytest.raises(ValueError, match="exceeds cache capacity"):
        att.slot_prompt_rows(8, 9, False)


@pytest.mark.parametrize("ring", [True, False])
@pytest.mark.parametrize("K", [1, 3, 8])
def test_chunk_rows_and_slots_match_reference(ring, K):
    C = 8
    pos = np.array([0, 5, 6, 7, 13, 30], np.int32)
    idx, rows = att.chunk_rows(torch.from_numpy(pos), K, C, ring)
    jidx, jrows = jatt.chunk_rows(jnp.asarray(pos), K, C, ring)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(rows.numpy(), np.asarray(jrows))
    sidx, slot, src, write = att.chunk_slots(torch.from_numpy(pos), K, C,
                                             ring)
    np.testing.assert_array_equal(sidx.numpy(), np.asarray(jidx))
    if ring:                       # every column writes its own slot
        np.testing.assert_array_equal(slot.numpy(), np.asarray(jrows))
        assert (src.numpy() == np.arange(K)[None]).all()
        assert bool(write.all())
    else:                          # overflow clamps, as the scatter drops
        inside = np.asarray(jrows) < C
        np.testing.assert_array_equal(slot.numpy()[inside],
                                      np.asarray(jrows)[inside])
        assert (slot.numpy() <= C - 1).all()


@pytest.mark.parametrize("ring", [True, False])
def test_insert_slots_match_reference_cache_insert(ring):
    """One decode insert per row: the slot the port writes and the values
    it leaves are the reference's ``cache_insert``'s (a full cache drops
    a write past C)."""
    B, C, KV, hd = 3, 8, 2, 4
    pos = np.array([3, 9, 8], np.int32)
    rng = np.random.default_rng(0)
    k0 = rng.standard_normal((B, C, KV, hd)).astype(np.float32)
    kn = rng.standard_normal((B, 1, KV, hd)).astype(np.float32)
    sp0 = np.tile(np.arange(C, dtype=np.int32), (B, 1))
    jk, _, jsp = jatt.cache_insert(jnp.asarray(k0), jnp.asarray(k0),
                                   jnp.asarray(sp0), jnp.asarray(kn),
                                   jnp.asarray(kn), jnp.asarray(pos),
                                   ring=ring)
    k, sp, tpos = torch.from_numpy(k0), torch.from_numpy(sp0), \
        torch.from_numpy(pos)
    rows, slot, keep = att.insert_slots(tpos, C, ring)
    att.cache_insert(k, torch.from_numpy(kn), rows, slot, keep)
    att.cache_insert(sp, tpos[:, None], rows, slot, keep)
    np.testing.assert_array_equal(k.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(sp.numpy(), np.asarray(jsp))


def test_ring_cache_insert():
    """The reference's ``test_ring_cache_insert``: 12 positions into a
    ring of 8, the last 8 at slot pos % C."""
    B, C, KV, hd = 1, 8, 2, 4
    kc = torch.zeros((B, C, KV, hd))
    sp = torch.full((B, C), -1, dtype=torch.int32)
    for pos in range(12):
        p = torch.full((B,), pos, dtype=torch.int32)
        rows, slot, keep = att.insert_slots(p, C, ring=True)
        att.cache_insert(kc, torch.full((B, 1, KV, hd), float(pos)), rows,
                         slot, keep)
        att.cache_insert(sp, p[:, None], rows, slot, keep)
    for pos in range(4, 12):
        assert float(kc[0, pos % C, 0, 0]) == float(pos)
        assert int(sp[0, pos % C]) == pos


# ------------------------------------------------------- the model, the wrap

@pytest.mark.parametrize("name,seq_len,S,steps", [
    ("tinyw", 32, 12, 6),         # the prefill wraps the ring (C = 8)
    ("tinyw", 32, 5, 6),          # decode wraps it
    ("tinyw", 8, 5, 6),           # seq_len <= window: full prefill, ring decode
    ("danube", 64, 40, 4),        # C = 32
    ("danube", 64, 28, 8),
    ("danube_hd80", 64, 40, 4),
])
def test_prefill_and_decode_through_the_wrap(name, seq_len, S, steps):
    (jmodel, jparams), (model, params) = _pair(CONFIGS[name])
    V = model.config.vocab_size
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, V, (2, S))
    jcache, jl = jmodel.prefill(jparams, jnp.asarray(prompt, jnp.int32),
                                seq_len)
    cache, lg = model.prefill(params, torch.from_numpy(prompt), seq_len)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jl), rtol=0, atol=TOL)
    _assert_cache_close(_np(cache), jcache)
    assert cache["slot_pos"].shape[1] == min(seq_len,
                                             model.config.sliding_window)
    for _ in range(steps):
        tok = rng.integers(0, V, (2, 1))
        jcache, jl = jmodel.decode_step(jparams, jcache,
                                        jnp.asarray(tok, jnp.int32))
        cache, lg = model.decode_step(params, cache, torch.from_numpy(tok))
        np.testing.assert_allclose(lg.numpy(), np.asarray(jl), rtol=0,
                                   atol=TOL)
        _assert_cache_close(_np(cache), jcache)
    assert int(cache["pos"][0]) == S + steps > cache["slot_pos"].shape[1]


def test_prefill_into_slot_of_a_ring_matches_reference(danube):
    """Slot admission into a ring: a prompt longer than the ring keeps its
    last C positions at pos % C; the batch-mate's row stays untouched."""
    (jmodel, jparams), (model, params) = danube
    jcache = jmodel.init_cache(2, 64)
    cache = model.init_cache(2, 64)
    rng = np.random.default_rng(1)
    for slot, S in ((0, 40), (1, 9)):
        p = rng.integers(0, 512, (1, S))
        jcache, jl = jmodel.prefill_into_slot(
            jparams, jcache, jnp.asarray(p, jnp.int32), slot)
        cache, lg = model.prefill_into_slot(params, cache,
                                            torch.from_numpy(p), slot)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jl), rtol=0,
                                   atol=TOL)
        _assert_cache_close(_np(cache), jcache)
    assert cache["pos"].tolist() == [40, 9]


def test_training_forward_and_adapter_layer_match_reference(danube):
    """The windowed training forward (blockwise, with autograd) and the
    ADMM adapter's layer apply, over a sequence longer than the window."""
    (jmodel, jparams), (model, params) = danube
    tokens = np.random.default_rng(2).integers(0, 512, (2, 48))
    jh, _, _ = jmodel.hidden_states(jparams, jnp.asarray(tokens, jnp.int32))
    w = params["blocks"][0]["attn"]["wq"].requires_grad_(True)
    h, _ = model.hidden_states(params, torch.from_numpy(tokens))
    np.testing.assert_allclose(h.detach().numpy(), np.asarray(jh), rtol=0,
                               atol=TOL)
    (g,) = torch.autograd.grad(h.square().sum(), [w])
    assert bool(g.abs().sum() > 0)
    w.requires_grad_(False)
    jad, tad = JLMAdapter(jmodel, seq_len=48), LMAdapter(model, seq_len=48)
    jx = jad.embed(jparams, jnp.asarray(tokens))
    tx = tad.embed(params, torch.from_numpy(tokens))
    with torch.no_grad():
        for n in range(model.config.num_layers):
            jx = jad.apply_layer(n, jad.layer_params(jparams, n), jx)
            tx = tad.apply_layer(n, tad.layer_params(params, n), tx)
            np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=0,
                                       atol=TOL)


# --------------------------------------------------------------- the engines

# prompts longer and shorter than the window (32), budgets across the wrap
LENS, NEW = (40, 12, 40, 33), (10, 24, 6, 9)


def _requests(lens=LENS, new=NEW, seed=4):
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, 512, n).astype(np.int32) for n in lens]
    return ([JRequest(uid=i, prompt=jnp.asarray(p), max_new_tokens=m)
             for i, (p, m) in enumerate(zip(prompts, new))],
            [Request(uid=i, prompt=torch.from_numpy(p).long(),
                     max_new_tokens=m)
             for i, (p, m) in enumerate(zip(prompts, new))])


@pytest.fixture(scope="module")
def danube_art(danube):
    (_, jparams), (_, params) = danube
    jart = j_greedy_prune(jparams, JPruneConfig(
        scheme="tile_pattern", exclude=tuple(J_EXCLUDE),
        overrides=TILE)).to_artifact(arch="h2o-danube-1.8b").pack()
    art = greedy_prune(params, PruneConfig(
        scheme="tile_pattern", exclude=DEFAULT_EXCLUDE, overrides=TILE),
        device="cpu").pack(device="cpu")
    return jart, art


@pytest.mark.parametrize("packed", [False, True])
def test_serve_engine_tokens_match_reference(danube, danube_art, packed):
    (jmodel, jparams), (model, params) = danube
    jart, art = danube_art
    jreqs, reqs = _requests()
    kw = dict(batch_size=2, max_seq_len=64)
    jeng = JServeEngine(jmodel, jart if packed else jparams, packed=packed,
                        **kw)
    eng = ServeEngine(model, art if packed else params, packed=packed,
                      device="cpu", **kw)
    want = [r.tokens for r in jeng.generate(jreqs)]
    assert [r.tokens for r in eng.generate(reqs)] == want
    assert [len(t) for t in want] == list(NEW)


def test_continuous_engine_tokens_and_statuses_match_reference(danube):
    """The reference's ``test_sliding_window_ring_cache`` bar (continuous
    == solo through the wrap) plus the reference's own tokens and
    statuses; the ring exempts the prompts from the capacity check."""
    (jmodel, jparams), (model, params) = danube
    jreqs, reqs = _requests(lens=(40, 12, 70, 12), new=(10, 24, 6, 9))
    kw = dict(batch_size=2, max_seq_len=64, chunk_steps=4)
    jout = JContinuousEngine(jmodel, jparams, **kw).generate(jreqs)
    out = ContinuousEngine(model, params, device="cpu", **kw).generate(reqs)
    assert [(r.tokens, r.status) for r in out] == \
        [(r.tokens, r.status) for r in jout]
    solo = ServeEngine(model, params, batch_size=1, max_seq_len=64,
                       device="cpu")
    assert [r.tokens for r in out] == [solo.generate([r])[0].tokens
                                       for r in reqs]


def test_continuous_engine_keeps_the_check_below_the_window(tinyw):
    """At ``max_seq_len <= window`` the cache is not a ring to the engine:
    an oversized request still raises (and is shed when not strict)."""
    _, (model, params) = tinyw
    eng = ContinuousEngine(model, params, batch_size=1, max_seq_len=8,
                           chunk_steps=2, device="cpu")
    big = Request(uid=0, prompt=torch.arange(6), max_new_tokens=4)
    with pytest.raises(ValueError, match="exceeds cache capacity"):
        eng.generate([big])


def test_speculative_engine_tokens_and_stats_match_reference(danube,
                                                             danube_art):
    """The packed artifact drafts for the dense pruned weights across the
    ring's wrap: tokens and the acceptance ``stats`` equal the
    reference's, and tokens equal plain decoding's."""
    (jmodel, _), (model, _) = danube
    jart, art = danube_art
    jreqs, reqs = _requests()
    kw = dict(batch_size=2, max_seq_len=64, draft_k=4)
    jeng = JSpeculativeEngine(jmodel, jart.params, jart, **kw)
    eng = SpeculativeEngine(model, art.params, art, device="cpu", **kw)
    got = [r.tokens for r in eng.generate(reqs)]
    assert got == [r.tokens for r in jeng.generate(jreqs)]
    for key in ("rounds", "drafted", "accepted", "acceptance_rate"):
        assert eng.stats[key] == jeng.stats[key], key
    plain = ServeEngine(model, art.params, batch_size=2, max_seq_len=64,
                        device="cpu")
    assert got == [r.tokens for r in plain.generate(reqs)]


def test_rollback_across_ring_wrap(tinyw):
    """The reference's case: a verify chunk across the wrap overwrites live
    window rows and rollback restores them. Held to the reference (chunk
    logits, rolled-back cache) and to the port's own K sequential decode
    steps (logits within 2e-5, cache exact after keep = 2)."""
    (jmodel, jparams), (model, params) = tinyw
    prompt = np.arange(12)[None, :] % 64
    jcache, _ = jmodel.prefill(jparams, jnp.asarray(prompt), 32)
    cache, _ = model.prefill(params, torch.from_numpy(prompt), 32)
    assert cache["k"][0].shape[1] == 8
    toks = np.random.default_rng(2).integers(0, 64, (1, 5))
    start = _clone(cache)
    jsnap = jmodel.cache_snapshot(jcache, 5)
    snap = model.cache_snapshot(cache, 5)
    jc, jl = jmodel.verify_chunk(jparams, jcache,
                                 jnp.asarray(toks, jnp.int32))
    c, lg = model.verify_chunk(params, cache, torch.from_numpy(toks))
    np.testing.assert_allclose(lg.numpy(), np.asarray(jl), rtol=0, atol=TOL)
    _assert_cache_close(_np(c), jc)
    seq_cache, seq = _clone(start), []
    for i in range(5):
        _, sl = model.decode_step(params, seq_cache,
                                  torch.from_numpy(toks[:, i:i + 1]))
        seq.append(sl[:, 0])
    np.testing.assert_allclose(torch.stack(seq, 1).numpy(), lg.numpy(),
                               rtol=0, atol=TOL)
    keep = np.array([2], np.int32)
    jrb = jmodel.cache_rollback(jc, jsnap, jnp.asarray(keep))
    rb = model.cache_rollback(c, snap, torch.from_numpy(keep))
    _assert_cache_close(_np(rb), jrb)
    ref = _clone(start)
    for i in range(2):
        model.decode_step(params, ref, torch.from_numpy(toks[:, i:i + 1]))
    got, old = _np(rb), _np(start)
    _assert_cache_close(got, _np(ref))
    # positions 14 .. 16 wrapped into slots 6, 7, 0: restored bit for bit
    for key in ("k", "v"):
        np.testing.assert_array_equal(got[key][:, :, [6, 7, 0]],
                                      old[key][:, :, [6, 7, 0]])


def test_sliding_window_ring_identity(tinyw):
    """The reference's case: speculative == plain through the ring's wrap,
    under full acceptance (the target drafts) and under constant
    rejection (a 1-layer shallow drafter); tokens and stats equal the
    reference's."""
    (jmodel, jparams), (model, params) = tinyw
    lens = [3 + 5 * i for i in range(3)]
    jreqs = [JRequest(uid=i, prompt=jnp.arange(n) % 64, max_new_tokens=10)
             for i, n in enumerate(lens)]
    reqs = [Request(uid=i, prompt=torch.arange(n) % 64, max_new_tokens=10)
            for i, n in enumerate(lens)]
    kw = dict(batch_size=2, max_seq_len=32, draft_k=4)
    plain = ServeEngine(model, params, batch_size=2, max_seq_len=32,
                        device="cpu")
    ref = [r.tokens for r in plain.generate(reqs)]
    assert ref == [r.tokens for r in JServeEngine(
        jmodel, jparams, batch_size=2, max_seq_len=32).generate(jreqs)]
    jd_model, jd_params = j_shallow_drafter(jmodel, jparams, 1)
    d_model, d_params = shallow_drafter(model, params, 1)
    for jdraft, draft, dm, jdm in ((jparams, params, None, None),
                                   (jd_params, d_params, d_model, jd_model)):
        jeng = JSpeculativeEngine(jmodel, jparams, jdraft, draft_model=jdm,
                                  **kw)
        eng = SpeculativeEngine(model, params, draft, draft_model=dm,
                                device="cpu", **kw)
        assert [r.tokens for r in eng.generate(reqs)] == ref
        jeng.generate(jreqs)
        for key in ("rounds", "drafted", "accepted"):
            assert eng.stats[key] == jeng.stats[key], key


def test_a_chunk_longer_than_the_ring_raises(tinyw):
    (jmodel, jparams), (model, params) = tinyw
    cache, _ = model.prefill(params, torch.arange(5)[None], 32)
    with pytest.raises(ValueError, match="exceeds the ring"):
        model.verify_chunk(params, cache, torch.zeros((1, 9),
                                                      dtype=torch.int64))
    with pytest.raises(ValueError, match="ring cache's window"):
        SpeculativeEngine(model, params, params, batch_size=2,
                          max_seq_len=32, draft_k=9, device="cpu")
    with pytest.raises(ValueError, match="ring cache's window"):
        JSpeculativeEngine(jmodel, jparams, jparams, batch_size=2,
                           max_seq_len=32, draft_k=9)


# -------------------------------------------------------------- the launchers

def test_prune_then_serve_danube_launchers_on_cpu(tmp_path):
    """``launch.prune --arch h2o-danube-1.8b --reduced`` writes a packed
    artifact; ``launch.serve`` serves it packed to the dense-pruned
    tokens, with prompts (40) past the ring (32 of ``--max-seq`` 256)."""
    from repro_torch.launch import prune, serve

    art = str(tmp_path / "artifact")
    prune.main(["--arch", "h2o-danube-1.8b", "--reduced", "--scheme",
                "tile_pattern", "--rate", "2", "--iters", "2", "--batch",
                "2", "--seq", "40", "--tile-block", "32", "--out",
                str(tmp_path / "out"), "--artifact-out", art, "--device",
                "cpu"])
    argv = ["--arch", "h2o-danube-1.8b", "--reduced", "--artifact", art,
            "--requests", "3", "--batch", "2", "--prompt-len", "40",
            "--max-new", "6", "--device", "cpu"]
    packed = serve.main(argv + ["--packed"])
    dense = serve.main(argv)
    assert [r.tokens for r in packed] == [r.tokens for r in dense]
    assert all(len(r.tokens) == 6 for r in packed)


# ---------------------------------------------------------------- the configs

@pytest.mark.parametrize("name", sorted(ARCHS))
def test_registered_config_equals_reference(name):
    assert dataclasses.asdict(get_config(name)) == \
        dataclasses.asdict(j_get_config(name))
    assert dataclasses.asdict(reduced_config(name)) == \
        dataclasses.asdict(j_reduced_config(name))


@pytest.mark.parametrize("name", ["granite-3-2b", "phi4-mini-3.8b"])
def test_reduced_dense_config_serves_reference_tokens(name):
    (jmodel, jparams), (model, params) = _pair(j_reduced_config(name))
    jreqs, reqs = _requests(lens=(9, 9, 5), new=(6, 4, 6))
    want = [r.tokens for r in JServeEngine(
        jmodel, jparams, batch_size=2, max_seq_len=32).generate(jreqs)]
    got = ServeEngine(model, params, batch_size=2, max_seq_len=32,
                      device="cpu").generate(reqs)
    assert [r.tokens for r in got] == want
