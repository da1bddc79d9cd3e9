"""The hybrid family (hymba: attention beside mamba heads) in the port
against the reference.

The reduced hymba-1.5b (2 layers, d_model 64, 4 / 2 heads of 16, d_ff
128, mamba 4 x 16 with state 8, window 32, vocab 512, fp32), the
reference's weights in both packages:

- the forward, ``train_loss`` and its gradients (``jax.grad``) within
  2e-5 (gradients 1e-4); ``prefill`` and 16 ``decode_step`` logits across
  the 32-slot ring, and the cache (k, v, slot positions, each layer's
  mamba ``h`` and ``conv``), against the reference's;
- ``convert`` and the artifact both ways bit-equal, the mamba leaves
  stacked (L, ...);
- ``tile_pattern`` refuses the mamba leaves (``w_bcdt`` has 2N + 1
  columns) with the reference's ``ValueError``; with ``.*mamba.*``
  excluded, layer-wise ADMM (the mamba branch in every stage) gives the
  reference's masks, history and weights; ``bind`` refuses a packed mamba
  leaf;
- serving: ``tests/test_torch_hybrid_serve.py``.
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
from repro.core import PrivacyPreservingPruner as JPruner
from repro.core import PruneConfig as JPruneConfig
from repro.core import greedy_prune as j_greedy_prune
from repro.models import build_model
from repro.sparse import PrunedArtifact as JPrunedArtifact
from repro.sparse.packed import is_packed as j_is_packed
from repro.utils.tree import tree_paths
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import (packed_from_jax, params_from_jax,
                                 tensor_from_numpy, tree_to_jax)
from repro_torch.core import (DEFAULT_EXCLUDE, LMAdapter,
                              PrivacyPreservingPruner, PruneConfig, as_key,
                              greedy_prune)
from repro_torch.models import LM
from repro_torch.sparse import PrunedArtifact, is_packed
from repro_torch.utils.tree import reference_path, tree_items

TOL = 2e-5
NAME = "hymba-1.5b"
MAMBA = (r".*mamba.*",)
TILE = {".*": {"tile_block_p": 32}}
SEQ, BATCH = 16, 3


@pytest.fixture(scope="module")
def pair():
    jcfg = j_reduced_config(NAME)
    jmodel = build_model(jcfg)
    np_params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(1)))
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    return (jmodel, np_params, jax.tree.map(jnp.asarray, np_params),
            LM(cfg, device="cpu"), params_from_jax(np_params, cfg, "cpu"),
            cfg)


def _close(got, want, atol=TOL, rtol=0.0):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=atol)


def _ref_flat(tree):
    return dict(zip(tree_paths(tree, is_leaf=j_is_packed),
                    jax.tree.leaves(tree, is_leaf=j_is_packed)))


def _layer(path, a):
    a = np.asarray(a)
    return a[int(path.split("/")[1])] if path.startswith("blocks/") else a


def _assert_tree_matches(port_tree, ref_tree):
    """Every port leaf bit-equal (dtype too) to its layer's slice of the
    reference's stacked leaf, packed or dense alike; nothing unmatched."""
    ref = _ref_flat(ref_tree)
    seen = set()
    for path, leaf in tree_items(port_tree):
        rpath = reference_path(path)
        if leaf is None:
            assert rpath not in ref, path
            continue
        seen.add(rpath)
        r = ref[rpath]
        assert is_packed(leaf) == j_is_packed(r), path
        pairs = (zip(leaf.buffers, r.buffers) if is_packed(leaf)
                 else [(leaf, r)])
        for a, b in pairs:
            want = tensor_from_numpy(_layer(path, b), torch.device("cpu"))
            assert a.dtype == want.dtype and torch.equal(a, want), path
    assert seen == set(ref)


def _tokens(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 512, shape)


def _rebuild(tree, leaves, prefix=""):
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves, f"{prefix}/{k}" if prefix else k)
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_rebuild(v, leaves, f"{prefix}/{i}")
                for i, v in enumerate(tree)]
    return leaves[prefix]


# ------------------------------------------------------------- the forward

def test_forward_loss_and_gradients(pair):
    jmodel, _, jparams, model, params, _ = pair
    assert params["blocks"][1]["mamba"]["w_bcdt"].shape == (64, 17)
    assert params["blocks"][1]["mamba"]["a_log"].dtype == torch.float32
    toks, labels = _tokens((2, 32)), _tokens((2, 32), seed=1)
    jh, _, _ = jmodel.hidden_states(jparams, jnp.asarray(toks))
    with torch.no_grad():
        h, _ = model.hidden_states(params, torch.from_numpy(toks))
    _close(h, jh)
    jbatch = {"inputs": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    jloss, jgrad = jax.value_and_grad(
        lambda p: jmodel.train_loss(p, jbatch))(jparams)
    leaves = {p: w.clone().requires_grad_(True)
              for p, w in tree_items(params)}
    loss = model.train_loss(_rebuild(params, leaves), {
        "inputs": torch.from_numpy(toks), "labels": torch.from_numpy(labels)})
    loss.backward()
    _close(loss.item(), float(jloss))
    ref = _ref_flat(jax.tree.map(np.asarray, jgrad))
    for path, leaf in leaves.items():
        _close(leaf.grad, _layer(path, ref[reference_path(path)]), 1e-4)


def test_prefill_and_decode_across_the_ring(pair):
    jmodel, _, jparams, model, params, _ = pair
    toks = _tokens((2, 24 + 16))
    jcache, jl = jmodel.prefill(jparams, jnp.asarray(toks[:, :24]), 48)
    cache, lg = model.prefill(params, torch.from_numpy(toks[:, :24]), 48)
    assert cache["slot_pos"].shape == (2, 32)               # the ring
    _close(lg, jl)
    for t in range(24, 40):                                 # wraps at 32
        jcache, jl = jmodel.decode_step(jparams, jcache,
                                        jnp.asarray(toks[:, t:t + 1]))
        cache, lg = model.decode_step(params, cache,
                                      torch.from_numpy(toks[:, t:t + 1]))
        _close(lg, jl)
    np.testing.assert_array_equal(cache["slot_pos"].numpy(),
                                  np.asarray(jcache["slot_pos"]))
    np.testing.assert_array_equal(cache["pos"].numpy(),
                                  np.asarray(jcache["pos"]))
    for name in ("k", "v"):
        _close(torch.stack(cache[name]), jcache[name])
    for name, t in cache["mamba"].items():
        assert t.dtype == torch.float32
        _close(t, jcache["mamba"][name], rtol=TOL)


# -------------------------------------------------- convert and artifacts

def test_convert_and_artifact_round_trip(pair, tmp_path):
    jmodel, np_params, jparams, model, params, cfg = pair
    back = dict(tree_items(tree_to_jax(params)))
    flat = _ref_flat(np_params)
    assert set(back) == set(flat)
    for path, want in flat.items():
        assert torch.equal(back[path], torch.from_numpy(np.asarray(want)))
    kw = dict(scheme="tile_pattern", overrides=TILE)
    jart = j_greedy_prune(jparams, JPruneConfig(
        exclude=tuple(J_EXCLUDE) + MAMBA, **kw)).to_artifact().pack()
    art = greedy_prune(params, PruneConfig(
        exclude=DEFAULT_EXCLUDE + MAMBA, **kw), device="cpu").pack(
            device="cpu", verify=True)
    _assert_tree_matches(art.packed, jart.packed)
    _assert_tree_matches(packed_from_jax(tree_to_jax(art.packed), cfg,
                                         "cpu"), jart.packed)
    jart.save(str(tmp_path / "ref"))
    got = PrunedArtifact.load(str(tmp_path / "ref"), cfg=cfg, device="cpu")
    for name in ("params", "packed", "masks"):
        _assert_tree_matches(getattr(got, name), getattr(jart, name))
    art.save(str(tmp_path / "port"))
    jgot = JPrunedArtifact.load(str(tmp_path / "port"))
    for name in ("params", "packed", "masks"):
        _assert_tree_matches(getattr(art, name), getattr(jgot, name))
    jgot.bind(jmodel, packed=True)


# -------------------------------------------------------------- pruning

def test_tile_pattern_refuses_the_mamba_leaves(pair):
    _, _, jparams, _, params, _ = pair
    msg = r"\(P=17, Q=64\) not divisible by \(block_p=32, group_q=8\)"
    with pytest.raises(ValueError, match=msg):
        j_greedy_prune(jparams, JPruneConfig(scheme="tile_pattern",
                                             overrides=TILE))
    with pytest.raises(ValueError, match=msg):
        greedy_prune(params, PruneConfig(scheme="tile_pattern",
                                         overrides=TILE), device="cpu")


def test_bind_refuses_a_packed_mamba_leaf(pair):
    _, _, _, model, params, _ = pair
    art = greedy_prune(params, PruneConfig(scheme="column", alpha=0.5),
                       device="cpu").pack(device="cpu")
    assert is_packed(art.packed["blocks"][0]["mamba"]["w_in"])
    with pytest.raises(TypeError, match="packed leaf blocks/0/mamba/w_"):
        art.bind(model, packed=True)


class _Fed:
    """Mixin: ``synthetic_batch`` hands out ``self.fed`` in turn."""

    def synthetic_batch(self, key, batch_size):
        x = self.fed.pop(0)
        assert x.shape[0] == batch_size
        return self.wrap(x)


def test_layerwise_admm_matches_reference(pair):
    """Two iterations of problem (3) under ``tile_pattern`` with the mamba
    heads excluded; each stage runs them beside attention."""
    jmodel, np_params, jparams, model, params, _ = pair
    rng = np.random.default_rng(3)
    batches = [rng.integers(0, 512, (BATCH, SEQ)).astype(np.int32)
               for _ in range(2)]
    J = type("J", (_Fed, JLMAdapter), {"wrap": staticmethod(jnp.asarray)})
    T = type("T", (_Fed, LMAdapter), {"wrap": staticmethod(
        lambda x: torch.from_numpy(x).long())})
    ja, ta = J(jmodel, seq_len=SEQ), T(model, seq_len=SEQ)
    ja.fed, ta.fed = list(batches), list(batches)
    kw = dict(scheme="tile_pattern", overrides=TILE, iterations=2,
              batch_size=BATCH, lr=1e-3, rho_init=1e-3, rho_every_iters=1,
              rho_max=1e-1)
    jres = JPruner(ja, JPruneConfig(exclude=tuple(J_EXCLUDE) + MAMBA,
                                    **kw)).run_layerwise(
        jax.random.PRNGKey(1), jparams)
    tres = PrivacyPreservingPruner(ta, PruneConfig(
        exclude=DEFAULT_EXCLUDE + MAMBA, **kw)).run_layerwise(
            as_key(1), params)
    assert not ja.fed and not ta.fed
    assert tres.history["rho"] == jres.history["rho"]
    for k in ("loss", "residual"):
        want = np.asarray(jres.history[k], np.float64)
        _close(tres.history[k], want, atol=2e-5 * np.abs(want).max(),
               rtol=2e-5)
    masks = dict(tree_items(tree_to_jax(tres.masks)))
    for path, want in _ref_flat(jax.tree.map(np.asarray,
                                             jres.masks)).items():
        np.testing.assert_array_equal(masks[path].float().numpy(),
                                      np.asarray(want, np.float32), path)
    assert not any("mamba" in p for p in masks if masks[p] is not None)
    got = dict(tree_items(tree_to_jax(tres.params)))
    for path, want in _ref_flat(jax.tree.map(np.asarray,
                                             jres.params)).items():
        want = np.asarray(want, np.float64)
        _close(got[path].numpy(), want,
               atol=2e-5 * max(np.abs(want).max(), 1e-30), rtol=2e-5)
