"""The xLSTM family (``ssm``) in the port's ``LM`` against the reference's.

The reduced xlstm-1.3b (8 blocks in 2 groups of 3 mLSTM + 1 sLSTM,
d_model 64, 4 heads of 16, vocab 512, fp32), the reference's weights in
both packages (``convert.params_from_jax``):

- ``hidden_states``, ``train_loss`` and its gradients (``jax.grad``)
  within 2e-5 (gradients 1e-4); ``prefill`` logits and every recurrent
  state of the cache (within 2e-5 absolute plus 2e-5 relative: its
  normalizer sums grow past 10), then 8 ``decode_step`` logits;
- ``convert``: a reference tree, grouped (G, per - 1, ...) mLSTM and
  (G, ...) sLSTM leaves, through the port and back bit-equal;
- ``greedy_prune`` under ``column`` and ``irregular``: the grouped mLSTM
  leaf projected one group at a time as (per - 1, D * F), zeros and masks
  equal to the reference's; ``tile_pattern`` raises the reference's
  ``ValueError`` on that view;
- the refusals: the layer-wise adapter (whole-model pruning runs),
  ``ContinuousEngine``, ``SpeculativeEngine``, ``shallow_drafter``,
  ``prefill_into_slot``, and ``bind`` of a packed sLSTM leaf;
- greedy ``ServeEngine`` tokens, dense and packed (the cells excluded,
  so only ``lm_head`` packs), equal the reference's and each other;
  ``launch.serve --arch xlstm-1.3b`` on random weights and on the
  artifact of ``launch.prune --no-layerwise``.
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
from repro.serve import ContinuousEngine as JContinuousEngine
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro.serve.speculative import shallow_drafter as j_shallow_drafter
from repro.sparse.packed import is_packed as j_is_packed
from repro.utils.tree import tree_paths
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import params_from_jax, tensor_from_numpy, tree_to_jax
from repro_torch.core import (DEFAULT_EXCLUDE, LMAdapter,
                              PrivacyPreservingPruner, PruneConfig, as_key,
                              greedy_prune)
from repro_torch.models import LM
from repro_torch.serve import ContinuousEngine, Request, ServeEngine
from repro_torch.serve.speculative import SpeculativeEngine, shallow_drafter
from repro_torch.sparse import is_packed
from repro_torch.utils.tree import reference_path, tree_items

TOL = 2e-5
NAME = "xlstm-1.3b"
CELLS = (r".*mlstm.*", r".*slstm.*")
TILE = {".*": {"tile_block_p": 32}}


@pytest.fixture(scope="module")
def pair():
    jcfg = j_reduced_config(NAME)
    jmodel = build_model(jcfg)
    np_params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(1)))
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    return (jmodel, np_params, jax.tree.map(jnp.asarray, np_params),
            LM(cfg, device="cpu"), params_from_jax(np_params, cfg, "cpu"))


def _close(got, want, atol=TOL, rtol=0.0):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=atol)


def _ref_flat(tree):
    return dict(zip(tree_paths(tree, is_leaf=j_is_packed),
                    jax.tree.leaves(tree, is_leaf=j_is_packed)))


def _assert_tree_matches(port_tree, ref_tree):
    """Every port leaf bit-equal to its group's slice of the reference's
    stacked leaf; nothing unmatched."""
    ref = _ref_flat(ref_tree)
    seen = set()
    for path, leaf in tree_items(port_tree):
        rpath = reference_path(path)
        if leaf is None:
            assert rpath not in ref, path
            continue
        seen.add(rpath)
        r = np.asarray(ref[rpath])
        if path.startswith("blocks/"):
            r = r[int(path.split("/")[1])]
        want = tensor_from_numpy(r, torch.device("cpu"))
        assert leaf.dtype == want.dtype and torch.equal(leaf, want), path
    assert seen == set(ref)


def _tokens(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 512, shape)


# ------------------------------------------------------------- the forward

def test_structure_and_convert_round_trip(pair):
    jmodel, np_params, _, model, params = pair
    assert len(params["blocks"]) == 2
    assert params["blocks"][0]["mlstm"]["w_up"].shape == (3, 64, 128)
    assert {p: tuple(w.shape) for p, w in tree_items(params)} == \
        model.param_shapes()
    init = model.init(torch.Generator().manual_seed(0))
    assert {p: tuple(w.shape) for p, w in tree_items(init)} == \
        model.param_shapes()
    back = dict(tree_items(tree_to_jax(params)))
    ref = _ref_flat(np_params)
    assert set(back) == set(ref)
    for path, leaf in back.items():
        want = tensor_from_numpy(np.asarray(ref[path]), torch.device("cpu"))
        assert leaf.dtype == want.dtype and torch.equal(leaf, want), path


def test_hidden_states_loss_and_gradients(pair):
    jmodel, _, jparams, model, params = pair
    toks = _tokens((2, 32))
    labels = _tokens((2, 32), seed=1)
    jh, _, _ = jmodel.hidden_states(jparams, jnp.asarray(toks))
    with torch.no_grad():
        h, kv = model.hidden_states(params, torch.from_numpy(toks))
    assert kv is None
    _close(h, jh)
    jbatch = {"inputs": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    jloss, jgrad = jax.value_and_grad(
        lambda p: jmodel.train_loss(p, jbatch))(jparams)
    leaves = {p: w.clone().requires_grad_(True)
              for p, w in tree_items(params)}
    tree = _rebuild(params, leaves)
    loss = model.train_loss(tree, {"inputs": torch.from_numpy(toks),
                                   "labels": torch.from_numpy(labels)})
    loss.backward()
    _close(loss.item(), float(jloss))
    ref = _ref_flat(jax.tree.map(np.asarray, jgrad))
    for path, leaf in leaves.items():
        r = ref[reference_path(path)]
        if path.startswith("blocks/"):
            r = r[int(path.split("/")[1])]
        _close(leaf.grad, r, 1e-4)


def _rebuild(tree, leaves, prefix=""):
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves, f"{prefix}/{k}" if prefix else k)
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_rebuild(v, leaves, f"{prefix}/{i}")
                for i, v in enumerate(tree)]
    return leaves[prefix]


def test_prefill_cache_and_decode(pair):
    jmodel, _, jparams, model, params = pair
    toks = _tokens((2, 32 + 8))
    jcache, jl = jmodel.prefill(jparams, jnp.asarray(toks[:, :32]), 48)
    cache, lg = model.prefill(params, torch.from_numpy(toks[:, :32]), 48)
    _close(lg, jl)
    for t in range(32, 40):
        jcache, jl = jmodel.decode_step(jparams, jcache,
                                        jnp.asarray(toks[:, t:t + 1]))
        cache, lg = model.decode_step(params, cache,
                                      torch.from_numpy(toks[:, t:t + 1]))
        _close(lg, jl)
    np.testing.assert_array_equal(cache["pos"].numpy(),
                                  np.asarray(jcache["pos"]))
    for cell in ("mlstm", "slstm"):
        for k, t in cache[cell].items():
            want = np.asarray(jcache[cell][k])
            assert t.dtype == torch.float32 and t.shape == want.shape
            # the normalizer sums n grow past 10: fp32 rounding is relative
            _close(t, want, rtol=TOL)
    # the same cache tensors, written in place
    before = {k: v.data_ptr() for k, v in tree_items(cache)}
    model.prefill(params, torch.from_numpy(toks[:, :16]), 48, cache=cache)
    assert {k: v.data_ptr() for k, v in tree_items(cache)} == before


# -------------------------------------------------------------- pruning

@pytest.mark.parametrize("scheme", ["column", "irregular"])
def test_greedy_prune_matches_reference(pair, scheme):
    _, _, jparams, _, params = pair
    jres = j_greedy_prune(jparams, JPruneConfig(scheme=scheme, alpha=0.5))
    art = greedy_prune(params, PruneConfig(scheme=scheme, alpha=0.5),
                       device="cpu")
    _assert_tree_matches(art.params, jax.tree.map(np.asarray, jres.params))
    _assert_tree_matches(art.masks, jax.tree.map(np.asarray, jres.masks))
    # the grouped view: one group's (3, 64, 128) leaf as (3, 64 * 128)
    w = art.params["blocks"][0]["mlstm"]["w_up"]
    if scheme == "column":
        kept = (w.reshape(3, -1) != 0).any(dim=0)
        assert float(kept.float().mean()) == pytest.approx(0.5)


def test_tile_pattern_raises_on_the_grouped_view(pair):
    _, _, jparams, _, params = pair
    msg = r"\(P=3, Q=4096\) not divisible by \(block_p=32, group_q=8\)"
    with pytest.raises(ValueError, match=msg):
        j_greedy_prune(jparams, JPruneConfig(scheme="tile_pattern",
                                             overrides=TILE))
    with pytest.raises(ValueError, match=msg):
        greedy_prune(params, PruneConfig(scheme="tile_pattern",
                                         overrides=TILE), device="cpu")


def test_layerwise_refused_whole_model_runs(pair):
    jmodel, _, _, model, params = pair
    with pytest.raises(ValueError, match="whole-model pruning"):
        JLMAdapter(jmodel)
    adapter = LMAdapter(model, seq_len=16)
    assert not adapter.supports_layerwise
    for call in (lambda: adapter.layer_params(params, 0),
                 lambda: adapter.apply_layer(0, None, None)):
        with pytest.raises(ValueError, match="whole-model pruning"):
            call()
    cfg = PruneConfig(scheme="column", alpha=0.5, iterations=1, batch_size=2)
    with pytest.raises(ValueError, match="whole-model pruning"):
        PrivacyPreservingPruner(adapter, cfg).run(as_key(1), params)
    res = PrivacyPreservingPruner(
        adapter, dataclasses.replace(cfg, layerwise=False)).run(
            as_key(1), params)
    assert np.isfinite(res.history["loss"]).all()
    w = res.params["blocks"][1]["slstm"]["w_gates"]
    assert float((w == 0).float().mean()) == pytest.approx(0.5)


def test_engines_and_drafter_refuse(pair):
    jmodel, _, jparams, model, params = pair
    kw = dict(batch_size=2, max_seq_len=32)
    with pytest.raises(NotImplementedError, match="xLSTM"):
        JContinuousEngine(jmodel, jparams, **kw)
    with pytest.raises(NotImplementedError, match="xLSTM"):
        ContinuousEngine(model, params, device="cpu", **kw)
    with pytest.raises(NotImplementedError, match="recurrent state"):
        SpeculativeEngine(model, params, params, device="cpu", **kw)
    with pytest.raises(NotImplementedError, match="truncate"):
        j_shallow_drafter(jmodel, jparams, 4)
    with pytest.raises(NotImplementedError, match="truncate"):
        shallow_drafter(model, params, 4)
    cache = model.init_cache(2, 32)
    with pytest.raises(NotImplementedError, match="xLSTM"):
        model.prefill_into_slot(params, cache, torch.zeros((1, 8),
                                                           dtype=torch.long), 0)


def test_bind_refuses_a_packed_cell_leaf(pair):
    _, _, jparams, model, params = pair
    art = greedy_prune(params, PruneConfig(scheme="column", alpha=0.5),
                       device="cpu").pack(device="cpu")
    assert is_packed(art.packed["blocks"][0]["slstm"]["w_gates"])
    jart = j_greedy_prune(jparams, JPruneConfig(
        scheme="column", alpha=0.5)).to_artifact().pack()
    assert j_is_packed(jart.packed["blocks"]["slstm"]["w_gates"])
    with pytest.raises(TypeError, match="blocks/0/slstm/w_gates"):
        art.bind(model, packed=True)


# -------------------------------------------------------------- serving

def _requests(lens, new, seed=4):
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, 512, n).astype(np.int32) for n in lens]
    return ([JRequest(uid=i, prompt=jnp.asarray(p), max_new_tokens=m)
             for i, (p, m) in enumerate(zip(prompts, new))],
            [Request(uid=i, prompt=torch.from_numpy(p).long(),
                     max_new_tokens=m)
             for i, (p, m) in enumerate(zip(prompts, new))])


def test_serve_engine_dense_and_packed_tokens_match_reference(pair):
    _, _, jparams, model, params = pair
    jmodel = pair[0]
    pcfg = dict(scheme="tile_pattern", overrides=TILE)
    jart = j_greedy_prune(jparams, JPruneConfig(
        exclude=tuple(J_EXCLUDE) + CELLS, **pcfg)).to_artifact().pack()
    art = greedy_prune(params, PruneConfig(
        exclude=DEFAULT_EXCLUDE + CELLS, **pcfg), device="cpu").pack(
            device="cpu")
    assert [p for p, x in tree_items(art.packed) if is_packed(x)] == \
        ["lm_head"]
    assert [p for p, x in _ref_flat(jart.packed).items()
            if j_is_packed(x)] == ["lm_head"]
    jreqs, reqs = _requests((24, 9, 17, 24), (6, 8, 5, 7))
    kw = dict(batch_size=2, max_seq_len=48)
    got = {}
    for packed in (False, True):
        want = [r.tokens for r in JServeEngine(
            jmodel, jart if packed else jart.params, packed=packed,
            **kw).generate(jreqs)]
        got[packed] = [r.tokens for r in ServeEngine(
            model, art if packed else art.params, packed=packed,
            device="cpu", **kw).generate(reqs)]
        assert got[packed] == want
    assert got[True] == got[False]
    assert [len(t) for t in got[True]] == [6, 8, 5, 7]


def test_serve_launcher_serves_xlstm(tmp_path):
    """``launch.serve --arch xlstm-1.3b --reduced``: random weights through
    ``ServeEngine``; an artifact of ``launch.prune --no-layerwise``
    (whole-model, irregular) served packed and dense alike."""
    from repro_torch.launch import prune, serve

    argv = ["--arch", NAME, "--reduced", "--requests", "3", "--batch", "2",
            "--prompt-len", "16", "--max-new", "4", "--device", "cpu"]
    assert all(len(r.tokens) == 4 for r in serve.main(argv))
    art = str(tmp_path / "artifact")
    prune.main(["--arch", NAME, "--reduced", "--scheme", "irregular",
                "--rate", "2", "--iters", "1", "--batch", "2", "--seq",
                "16", "--no-layerwise", "--device", "cpu", "--out",
                str(tmp_path / "out"), "--artifact-out", art])
    dense = serve.main(argv + ["--artifact", art])
    packed = serve.main(argv + ["--artifact", art, "--packed"])
    assert [r.tokens for r in packed] == [r.tokens for r in dense]
