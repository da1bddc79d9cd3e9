"""The port's MoE family against the reference's.

The same weights (the reference's init, through
``convert.params_from_jax``) and the same numpy inputs go through
``repro`` and the port on the CPU, at the reference's reduced MoE
configs (2 layers, d_model 64, 8 routed experts of width 32, 2 shared,
top-2), fp32:

- ``moe_apply`` outputs and aux within 2e-5, including a group whose
  capacity drops assignments (``capacity_factor`` 0.25) and the
  reference's scanned steps (small ``group_size`` / ``scan_tokens``);
  top-k on exact ties takes the lower expert first, as ``lax.top_k``;
- the ``LM``: training forward and ``train_loss`` with the aux term,
  the layer-wise adapter's layer, prefill and decode logits and caches,
  ``verify_chunk`` against the reference's and against the port's own
  sequential decode;
- greedy tokens of ``ServeEngine`` (dense, and tile packed with the
  experts excluded), on left-padded mixed-length chunks, of
  ``ContinuousEngine`` (equal to solo too) and ``SpeculativeEngine``
  (the packed artifact drafting), equal to the reference's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as j_reduced_config
from repro.core import DEFAULT_EXCLUDE as J_EXCLUDE
from repro.core import LMAdapter as JLMAdapter
from repro.core import PruneConfig as JPruneConfig
from repro.core import greedy_prune as j_greedy_prune
from repro.models import build_model
from repro.models import moe as jmoe
from repro.serve import ContinuousEngine as JContinuousEngine
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro.serve import SpeculativeEngine as JSpeculativeEngine
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import params_from_jax
from repro_torch.core import DEFAULT_EXCLUDE, LMAdapter, PruneConfig
from repro_torch.core import greedy_prune
from repro_torch.models import LM
from repro_torch.models import moe
from repro_torch.serve import ContinuousEngine, Request, ServeEngine
from repro_torch.serve.speculative import SpeculativeEngine
from repro_torch.sparse import is_packed
from repro_torch.utils.tree import tree_items

TOL = 2e-5
NAMES = ("qwen2-moe-a2.7b", "deepseek-moe-16b")
TILE = {".*": {"tile_block_p": 32}}
EXPERTS = (r".*experts.*",)


def _pair(jcfg, seed=1):
    """(reference model, params) and (port model, params), same weights."""
    jmodel = build_model(jcfg)
    np_params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(seed)))
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    return ((jmodel, jax.tree.map(jnp.asarray, np_params)),
            (LM(cfg, device="cpu"), params_from_jax(np_params, cfg, "cpu")))


@pytest.fixture(scope="module")
def qwen():
    return _pair(j_reduced_config("qwen2-moe-a2.7b"))


def _close(got, want, atol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=0,
                               atol=atol)


# ----------------------------------------------------------------- the layer

def _moe_params(seed=0, D=64, E=8, F=32, shared=2):
    jp = jmoe.moe_init(jax.random.PRNGKey(seed), D, E, shared, F, jnp.float32)
    np_p = jax.tree.map(np.asarray, jp)
    return jp, params_from_jax(np_p, None, "cpu")


@pytest.mark.parametrize("B,S,kw", [
    (2, 48, dict(top_k=2)),                                  # one group a row
    (2, 256, dict(top_k=2, capacity_factor=0.25)),           # C = 16: drops
    (2, 64, dict(top_k=2, group_size=16, scan_tokens=32)),   # 4 scanned steps
    (2, 64, dict(top_k=2, group_size=16, scan_tokens=64)),   # 2 steps of 2
    (3, 1, dict(top_k=2)),                                   # a decode step
], ids=["groups", "capacity-drop", "scan", "scan-2-chunks", "decode"])
def test_moe_apply_matches_reference(B, S, kw):
    jp, tp = _moe_params()
    x = np.random.default_rng(0).standard_normal((B, S, 64)).astype(
        np.float32)
    jy, jaux = jmoe.moe_apply(jp, jnp.asarray(x), **kw)
    y, aux = moe.moe_apply(tp, torch.from_numpy(x), **kw)
    _close(y.numpy(), jy)
    _close(float(aux), float(jaux))
    if "capacity_factor" in kw:       # the case does drop assignments
        tg = min(kw.get("group_size", 512), S)
        _, _, _, sel = moe._route(tp["router"], torch.from_numpy(x).reshape(
            -1, tg, 64), 2, kw["capacity_factor"])
        C = moe._group_capacity(tg, 8, 2, kw["capacity_factor"])
        assert int(sel.sum(dim=(1, 2)).max()) > C


def test_moe_apply_refuses_a_ragged_group():
    _, tp = _moe_params()
    with pytest.raises(ValueError, match="not divisible by group_size"):
        moe.moe_apply(tp, torch.zeros((1, 600, 64)), top_k=2)


def test_top_k_ties_take_the_lower_index_first():
    probs = np.array([[0.1, 0.3, 0.3, 0.1, 0.2], [0.2] * 5,
                      [0.0, 0.5, 0.0, 0.5, 0.0]], np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(probs), 3)
    v, i = moe.sorted_top_k(torch.from_numpy(probs), 3)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    assert i.tolist()[1] == [0, 1, 2]
    # a zero router ties every expert: slots go to experts 0 .. k - 1
    jp, tp = _moe_params()
    jp["router"] = jnp.zeros_like(jp["router"])
    tp["router"] = torch.zeros_like(tp["router"])
    x = np.random.default_rng(1).standard_normal((2, 32, 64)).astype(
        np.float32)
    jy, jaux = jmoe.moe_apply(jp, jnp.asarray(x), top_k=2)
    y, aux = moe.moe_apply(tp, torch.from_numpy(x), top_k=2)
    _close(y.numpy(), jy)
    _close(float(aux), float(jaux))


# ------------------------------------------------------------------- the LM

@pytest.mark.parametrize("name", NAMES)
def test_forward_loss_and_adapter_layer_match_reference(name):
    (jmodel, jparams), (model, params) = _pair(j_reduced_config(name))
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, 512, (2, 32))
    labels = rng.integers(0, 512, (2, 32))
    jh, jaux, _ = jmodel.hidden_states(jparams, jnp.asarray(tokens))
    aux = []
    h, _ = model.hidden_states(params, torch.from_numpy(tokens), aux=aux)
    _close(h.detach().numpy(), jh)
    assert len(aux) == model.config.num_layers
    _close(float(aux[0] + aux[1]), float(jaux))
    jloss = jmodel.train_loss(jparams, {"inputs": jnp.asarray(tokens),
                                        "labels": jnp.asarray(labels)})
    w = params["blocks"][0]["moe"]["experts"]["w_up"].requires_grad_(True)
    loss = model.train_loss(params, {"inputs": torch.from_numpy(tokens),
                                     "labels": torch.from_numpy(labels)})
    _close(float(loss), float(jloss))
    (g,) = torch.autograd.grad(loss, [w])
    assert bool(g.abs().sum() > 0)
    w.requires_grad_(False)
    jad, tad = JLMAdapter(jmodel, seq_len=32), LMAdapter(model, seq_len=32)
    jx = jad.embed(jparams, jnp.asarray(tokens))
    tx = tad.embed(params, torch.from_numpy(tokens))
    with torch.no_grad():
        for n in range(model.config.num_layers):
            jx = jad.apply_layer(n, jad.layer_params(jparams, n), jx)
            tx = tad.apply_layer(n, tad.layer_params(params, n), tx)
            _close(tx.numpy(), jx)


def _np(cache):
    return {"k": torch.stack(cache["k"]).numpy(),
            "v": torch.stack(cache["v"]).numpy(),
            "slot_pos": cache["slot_pos"].numpy(),
            "pos": cache["pos"].numpy()}


def test_prefill_decode_and_verify_chunk_match_reference(qwen):
    """Prefill and decode logits and caches within 2e-5; a verify chunk
    of K = 5 against the reference's and against the port's own five
    sequential decode steps (nothing drops: C = 8 >= K tokens)."""
    (jmodel, jparams), (model, params) = qwen
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, 512, (2, 24))
    jcache, jl = jmodel.prefill(jparams, jnp.asarray(prompt), 48)
    cache, lg = model.prefill(params, torch.from_numpy(prompt), 48)
    _close(lg.numpy(), jl)
    for _ in range(3):
        tok = rng.integers(0, 512, (2, 1))
        jcache, jl = jmodel.decode_step(jparams, jcache, jnp.asarray(tok))
        cache, lg = model.decode_step(params, cache, torch.from_numpy(tok))
        _close(lg.numpy(), jl)
    got, want = _np(cache), jax.tree.map(np.asarray, jcache)
    np.testing.assert_array_equal(got["slot_pos"], want["slot_pos"])
    for key in ("k", "v"):
        _close(got[key], want[key])
    chunk = rng.integers(0, 512, (2, 5))
    start = {k: ([t.clone() for t in v] if isinstance(v, list)
                 else v.clone()) for k, v in cache.items()}
    _, jl = jmodel.verify_chunk(jparams, jcache, jnp.asarray(chunk))
    _, lg = model.verify_chunk(params, cache, torch.from_numpy(chunk))
    _close(lg.numpy(), jl)
    seq = [model.decode_step(params, start, torch.from_numpy(
        chunk[:, i:i + 1]))[1][:, 0] for i in range(5)]
    _close(torch.stack(seq, 1).numpy(), lg.numpy())


# -------------------------------------------------------------- the engines

def _requests(lens, new, seed=4):
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, 512, n).astype(np.int32) for n in lens]
    return ([JRequest(uid=i, prompt=jnp.asarray(p), max_new_tokens=m)
             for i, (p, m) in enumerate(zip(prompts, new))],
            [Request(uid=i, prompt=torch.from_numpy(p).long(),
                     max_new_tokens=m)
             for i, (p, m) in enumerate(zip(prompts, new))])


@pytest.fixture(scope="module")
def qwen_art(qwen):
    """Both packages' tile-pattern artifacts, the experts excluded."""
    (_, jparams), (_, params) = qwen
    jart = j_greedy_prune(jparams, JPruneConfig(
        scheme="tile_pattern", exclude=tuple(J_EXCLUDE) + EXPERTS,
        overrides=TILE)).to_artifact(arch="qwen2-moe-a2.7b").pack()
    art = greedy_prune(params, PruneConfig(
        scheme="tile_pattern", exclude=DEFAULT_EXCLUDE + EXPERTS,
        overrides=TILE), device="cpu").pack(device="cpu")
    return jart, art


# left-padded chunks of mixed lengths: pad tokens claim expert capacity
LENS, NEW = (24, 9, 17, 24), (6, 8, 5, 7)


@pytest.mark.parametrize("packed", [False, True])
def test_serve_engine_tokens_match_reference(qwen, qwen_art, packed):
    (jmodel, jparams), (model, params) = qwen
    jart, art = qwen_art
    if packed:
        paths = [p for p, x in tree_items(art.packed) if is_packed(x)]
        assert "lm_head" in paths and "blocks/0/moe/shared/w_up" in paths
        assert not any("experts" in p for p in paths)
    jreqs, reqs = _requests(LENS, NEW)
    kw = dict(batch_size=2, max_seq_len=48)
    want = [r.tokens for r in JServeEngine(
        jmodel, jart if packed else jart.params, packed=packed,
        **kw).generate(jreqs)]
    eng = ServeEngine(model, art if packed else art.params, packed=packed,
                      device="cpu", **kw)
    assert [r.tokens for r in eng.generate(reqs)] == want
    assert [len(t) for t in want] == list(NEW)


def test_continuous_engine_matches_reference_and_solo(qwen):
    (jmodel, jparams), (model, params) = qwen
    jreqs, reqs = _requests(LENS, NEW, seed=5)
    kw = dict(batch_size=2, max_seq_len=48, chunk_steps=4)
    jout = JContinuousEngine(jmodel, jparams, **kw).generate(jreqs)
    out = ContinuousEngine(model, params, device="cpu", **kw).generate(reqs)
    assert [(r.tokens, r.status) for r in out] == \
        [(r.tokens, r.status) for r in jout]
    solo = ServeEngine(model, params, batch_size=1, max_seq_len=48,
                       device="cpu")
    assert [r.tokens for r in out] == [solo.generate([r])[0].tokens
                                       for r in reqs]


def test_speculative_engine_matches_reference(qwen, qwen_art):
    """The packed artifact drafts for its pruned weights bound dense:
    tokens and acceptance stats equal the reference's, tokens equal plain
    decoding's."""
    (jmodel, _), (model, _) = qwen
    jart, art = qwen_art
    jreqs, reqs = _requests(LENS, NEW, seed=6)
    kw = dict(batch_size=2, max_seq_len=48, draft_k=4)
    jeng = JSpeculativeEngine(jmodel, jart.params, jart, **kw)
    eng = SpeculativeEngine(model, art.params, art, device="cpu", **kw)
    got = [r.tokens for r in eng.generate(reqs)]
    assert got == [r.tokens for r in jeng.generate(jreqs)]
    for key in ("rounds", "drafted", "accepted", "acceptance_rate"):
        assert eng.stats[key] == jeng.stats[key], key
    plain = ServeEngine(model, art.params, batch_size=2, max_seq_len=48,
                        device="cpu")
    assert got == [r.tokens for r in plain.generate(reqs)]
