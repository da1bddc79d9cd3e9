"""Serving the hybrid family (hymba), port against reference.

The reduced hymba-1.5b of ``tests/test_torch_hybrid.py`` (the
reference's weights in both packages, fp32), tile-pattern packed with
``.*mamba.*`` excluded at block_p 32 in both packages:

- greedy tokens: ``ServeEngine`` packed and dense identical and equal to
  the reference's, on left-padded mixed-length chunks, one prompt
  wrapping the 32-slot ring; ``ContinuousEngine`` equal to the
  reference's and to solo runs; ``prefill_into_slot`` writes the slot's
  mamba rows of a solo prefill and leaves every other slot's untouched;
  ``SpeculativeEngine`` refuses;
- the launchers: ``launch.prune --arch hymba-1.5b --reduced`` then
  ``launch.serve`` of its artifact, packed and dense alike; a column
  artifact packs the mamba leaves and packed serving refuses it.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as j_reduced_config
from repro.core import DEFAULT_EXCLUDE as J_EXCLUDE
from repro.core import PruneConfig as JPruneConfig
from repro.core import greedy_prune as j_greedy_prune
from repro.models import build_model
from repro.serve import ContinuousEngine as JContinuousEngine
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import params_from_jax
from repro_torch.core import DEFAULT_EXCLUDE, PruneConfig, greedy_prune
from repro_torch.models import LM
from repro_torch.serve import ContinuousEngine, Request, ServeEngine
from repro_torch.serve.speculative import SpeculativeEngine
from repro_torch.sparse import is_packed
from repro_torch.utils.tree import reference_path, tree_items

NAME = "hymba-1.5b"
MAMBA = (r".*mamba.*",)
TILE = {".*": {"tile_block_p": 32}}


@pytest.fixture(scope="module")
def pair():
    jcfg = j_reduced_config(NAME)
    jmodel = build_model(jcfg)
    np_params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(1)))
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    return (jmodel, np_params, jax.tree.map(jnp.asarray, np_params),
            LM(cfg, device="cpu"), params_from_jax(np_params, cfg, "cpu"),
            cfg)


def _tokens(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 512, shape)


# -------------------------------------------------------------- serving

def _requests(lens, new, seed=4):
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, 512, n).astype(np.int32) for n in lens]
    return ([JRequest(uid=i, prompt=jnp.asarray(p), max_new_tokens=m)
             for i, (p, m) in enumerate(zip(prompts, new))],
            [Request(uid=i, prompt=torch.from_numpy(p).long(),
                     max_new_tokens=m)
             for i, (p, m) in enumerate(zip(prompts, new))])


LENS, NEW = (24, 9, 17, 40), (6, 8, 5, 7)     # the 40-token prompt wraps


@pytest.fixture(scope="module")
def arts(pair):
    _, _, jparams, _, params, _ = pair
    kw = dict(scheme="tile_pattern", overrides=TILE)
    jart = j_greedy_prune(jparams, JPruneConfig(
        exclude=tuple(J_EXCLUDE) + MAMBA, **kw)).to_artifact().pack()
    art = greedy_prune(params, PruneConfig(
        exclude=DEFAULT_EXCLUDE + MAMBA, **kw), device="cpu").pack(
            device="cpu")
    return jart, art


def test_serve_engine_packed_equals_dense_and_reference(pair, arts):
    jmodel, _, _, model, _, _ = pair
    jart, art = arts
    packed = {reference_path(p) for p, x in tree_items(art.packed)
              if is_packed(x)}
    assert packed == {"lm_head", *(f"blocks/attn/w{n}" for n in "qkvo"),
                      *(f"blocks/mlp/{n}"
                        for n in ("w_gate", "w_up", "w_down"))}
    jreqs, reqs = _requests(LENS, NEW)
    kw = dict(batch_size=2, max_seq_len=48)
    got = {}
    for p in (False, True):
        want = [r.tokens for r in JServeEngine(
            jmodel, jart if p else jart.params, packed=p,
            **kw).generate(jreqs)]
        got[p] = [r.tokens for r in ServeEngine(
            model, art if p else art.params, packed=p, device="cpu",
            **kw).generate(reqs)]
        assert got[p] == want
    assert got[True] == got[False]
    assert [len(t) for t in got[True]] == list(NEW)


def test_continuous_engine_matches_reference_and_solo(pair, arts):
    jmodel, _, _, model, _, _ = pair
    jart, art = arts
    jreqs, reqs = _requests(LENS, NEW, seed=5)
    kw = dict(batch_size=2, max_seq_len=48, chunk_steps=4)
    jout = JContinuousEngine(jmodel, jart, packed=True, **kw).generate(jreqs)
    out = ContinuousEngine(model, art, packed=True, device="cpu",
                           **kw).generate(reqs)
    assert [(r.tokens, r.status) for r in out] == \
        [(r.tokens, r.status) for r in jout]
    solo = ServeEngine(model, art, packed=True, batch_size=1,
                       max_seq_len=48, device="cpu")
    assert [r.tokens for r in out] == [solo.generate([r])[0].tokens
                                       for r in reqs]


def test_prefill_into_slot_leaves_other_mamba_rows(pair):
    _, _, _, model, params, _ = pair
    cache, _ = model.prefill(params, torch.from_numpy(_tokens((3, 20))), 48)
    before = {k: t.clone() for k, t in cache["mamba"].items()}
    _, lg = model.prefill_into_slot(params, cache, torch.from_numpy(
        _tokens((1, 12), seed=2)), 1)
    solo, want = model.prefill(params, torch.from_numpy(
        _tokens((1, 12), seed=2)), 48)
    assert torch.equal(lg, want)
    for k, t in cache["mamba"].items():
        assert torch.equal(t[:, [0, 2]], before[k][:, [0, 2]]), k
        assert torch.equal(t[:, 1], solo["mamba"][k][:, 0]), k


def test_speculative_engine_refuses(pair):
    _, _, _, model, params, _ = pair
    with pytest.raises(NotImplementedError, match="recurrent state"):
        SpeculativeEngine(model, params, params, batch_size=2,
                          max_seq_len=48, device="cpu")


# ------------------------------------------------------------ launchers

def test_launchers_prune_then_serve(tmp_path):
    """``launch.prune`` (layer-wise, irregular: nothing packs) then
    ``launch.serve`` of the artifact, packed and dense alike; a column
    artifact packs the mamba leaves and its packed serving refuses."""
    from repro_torch.launch import prune, serve

    common = ["--arch", NAME, "--reduced", "--rate", "2", "--iters", "1",
              "--batch", "2", "--seq", "16", "--device", "cpu"]
    argv = ["--arch", NAME, "--reduced", "--requests", "3", "--batch", "2",
            "--prompt-len", "16", "--max-new", "5", "--device", "cpu"]
    for scheme in ("irregular", "column"):
        art = str(tmp_path / scheme)
        prune.main(common + ["--scheme", scheme, "--out",
                             str(tmp_path / f"out_{scheme}"),
                             "--artifact-out", art])
        dense = serve.main(argv + ["--artifact", art])
        assert all(len(r.tokens) == 5 for r in dense)
        if scheme == "irregular":
            packed = serve.main(argv + ["--artifact", art, "--packed"])
            assert [r.tokens for r in packed] == [r.tokens for r in dense]
        else:
            with pytest.raises(TypeError, match="mamba"):
                serve.main(argv + ["--artifact", art, "--packed"])
    with pytest.raises(NotImplementedError, match="recurrent state"):
        serve.main(argv + ["--speculative", str(tmp_path / "irregular")])
