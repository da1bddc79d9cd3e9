"""Pruning, packing and saving the MoE family, port against reference.

The reduced qwen2-moe-a2.7b (2 layers, 8 routed experts (E, D, F) =
(8, 64, 32) a layer, 2 shared, fp32), the reference's weights in both
packages:

- the reference projects one expert leaf onto two sets: its final,
  whole-tree projection takes a layer's (E, D, F) whole, as (E, D * F);
  a layer-wise ADMM update takes it expert by expert. ``greedy_prune``
  zeros are identical to the reference's under ``column`` and
  ``irregular`` (whole), a layer's ``project_tree`` equals the
  reference's per-layer one (per expert), and the two differ;
- ``tile_pattern`` with the experts not excluded raises the reference's
  ``ValueError``; excluded, the same leaves pack in both packages and
  every expert leaf stays dense, under ``column`` too; where E is a
  multiple of block_p the reference packs an expert leaf lossily, and the
  port keeps it dense;
- layer-wise ADMM, 2 iterations on the same fed batches: history, masks
  and pruned weights as the reference's;
- ``convert`` and the artifact, both ways, bit-equal;
- ``launch.prune`` refuses ``tile_pattern`` and serves ``column``.
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
from repro.core import schemes as jschemes
from repro.models import build_model
from repro.sparse import PrunedArtifact as JPrunedArtifact
from repro.sparse.packed import is_packed as j_is_packed
from repro.utils.tree import tree_paths
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import (
    packed_from_jax,
    params_from_jax,
    tensor_from_numpy,
    tree_to_jax,
)
from repro_torch.core import DEFAULT_EXCLUDE, LMAdapter
from repro_torch.core import PrivacyPreservingPruner, PruneConfig
from repro_torch.core import as_key, build_specs, greedy_prune, project_tree
from repro_torch.models import LM
from repro_torch.sparse import PrunedArtifact, is_packed
from repro_torch.utils.tree import reference_path, tree_items

NAME = "qwen2-moe-a2.7b"
EXPERTS = (r".*experts.*",)
TILE = {".*": {"tile_block_p": 32}}
SEQ, BATCH = 16, 3


@pytest.fixture(scope="module")
def pair():
    jcfg = j_reduced_config(NAME)
    jmodel = build_model(jcfg)
    np_params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    return jmodel, np_params, LM(cfg, device="cpu"), cfg


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
            want = tensor_from_numpy(_layer(path, b), "cpu")
            assert a.dtype == want.dtype and torch.equal(a, want), path
    assert seen == set(ref)


# ------------------------------------------------------- the two views

@pytest.mark.parametrize("scheme", ["column", "irregular"])
def test_greedy_zeros_match_reference_and_differ_from_the_layer_view(
        pair, scheme):
    jmodel, np_params, _, cfg = pair
    jres = j_greedy_prune(jax.tree.map(jnp.asarray, np_params),
                          JPruneConfig(scheme=scheme, alpha=0.5))
    params = params_from_jax(np_params, cfg, "cpu")
    art = greedy_prune(params, PruneConfig(scheme=scheme, alpha=0.5),
                       device="cpu")
    _assert_tree_matches(art.params, jax.tree.map(np.asarray, jres.params))
    _assert_tree_matches(art.masks, jax.tree.map(
        lambda m: np.asarray(m), jres.masks))
    # one layer's tree (an ADMM update) projects its experts per expert,
    # as the reference's per-layer specs do
    jlp = jax.tree.map(lambda a: jnp.asarray(a[1]), np_params["blocks"])
    lp = params["blocks"][1]
    jz = jschemes.project_tree(jlp, jschemes.build_specs(
        jlp, JPruneConfig(scheme=scheme, alpha=0.5)))
    z = project_tree(lp, build_specs(lp, PruneConfig(scheme=scheme,
                                                     alpha=0.5)))
    for name in ("w_gate", "w_up", "w_down"):
        per_expert = z["moe"]["experts"][name]
        np.testing.assert_array_equal(
            per_expert.numpy(), np.asarray(jz["moe"]["experts"][name]))
        whole = art.params["blocks"][1]["moe"]["experts"][name]
        assert not torch.equal(per_expert != 0, whole != 0), name
        assert float((whole == 0).float().mean()) == pytest.approx(0.5)


def test_tile_pattern_needs_the_experts_excluded(pair):
    jmodel, np_params, model, cfg = pair
    jparams = jax.tree.map(jnp.asarray, np_params)
    params = params_from_jax(np_params, cfg, "cpu")
    msg = r"\(P=8, Q=2048\) not divisible by \(block_p=32, group_q=8\)"
    with pytest.raises(ValueError, match=msg):
        j_greedy_prune(jparams, JPruneConfig(scheme="tile_pattern",
                                             overrides=TILE))
    with pytest.raises(ValueError, match=msg):
        greedy_prune(params, PruneConfig(scheme="tile_pattern",
                                         overrides=TILE), device="cpu")


@pytest.mark.parametrize("scheme", ["tile_pattern", "column"])
def test_packed_leaves_match_reference_experts_dense(pair, scheme):
    """The same leaves pack in both packages; an expert leaf never does
    (under column the reference's stacked pack keeps almost every row,
    so its ``kmax`` rule leaves the leaf dense)."""
    jmodel, np_params, model, cfg = pair
    excl = EXPERTS if scheme == "tile_pattern" else ()
    kw = dict(scheme=scheme, alpha=0.5, overrides=TILE)
    jart = j_greedy_prune(jax.tree.map(jnp.asarray, np_params), JPruneConfig(
        exclude=tuple(J_EXCLUDE) + excl, **kw)).to_artifact().pack()
    art = greedy_prune(params_from_jax(np_params, cfg, "cpu"), PruneConfig(
        exclude=DEFAULT_EXCLUDE + excl, **kw), device="cpu").pack(
            device="cpu", verify=True)
    _assert_tree_matches(art.packed, jart.packed)
    packed = {reference_path(p) for p, x in tree_items(art.packed)
              if is_packed(x)}
    assert packed == {"lm_head", *(f"blocks/attn/w{n}" for n in "qkvo"),
                      *(f"blocks/moe/shared/{n}"
                        for n in ("w_gate", "w_up", "w_down"))}
    art.bind(model, packed=True)
    assert art.bind_report["fallbacks"] == {}


def test_experts_stay_dense_where_the_reference_packs_them_lossily():
    """With E a multiple of block_p (32 experts at block_p 32) the
    reference's whole-leaf tile projection passes, and its stacked pack
    then packs each (D, F) matrix from lanes it was not projected onto:
    its own ``pack(verify=True)`` fails on the expert leaf. The port
    prunes the same zeros and keeps the leaf dense, so its packed tree
    is exactly the pruned one."""
    jcfg = j_reduced_config("deepseek-moe-16b", num_experts=32)
    jmodel = build_model(jcfg)
    np_params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    jres = j_greedy_prune(jax.tree.map(jnp.asarray, np_params),
                          JPruneConfig(scheme="tile_pattern", overrides=TILE))
    with pytest.raises(AssertionError, match="pack/unpack mismatch"):
        jres.to_artifact().pack(verify=True)
    art = greedy_prune(params_from_jax(np_params, cfg, "cpu"), PruneConfig(
        scheme="tile_pattern", overrides=TILE), device="cpu")
    _assert_tree_matches(art.params, jax.tree.map(np.asarray, jres.params))
    art = art.pack(device="cpu", verify=True)
    experts = [x for p, x in tree_items(art.packed) if "/experts/" in p]
    assert len(experts) == 3 * cfg.num_layers
    assert not any(is_packed(x) for x in experts)


# ---------------------------------------------------------- layer-wise ADMM

class _Fed:
    """Mixin: ``synthetic_batch`` hands out ``self.fed`` in turn."""

    def synthetic_batch(self, key, batch_size):
        x = self.fed.pop(0)
        assert x.shape[0] == batch_size
        return self.wrap(x)


def _close(got, want, what):
    want = np.asarray(want, np.float64)
    atol = 2e-5 * max(float(np.abs(want).max(initial=0.0)), 1e-30)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=2e-5,
                               atol=atol, err_msg=what)


def test_layerwise_admm_matches_reference(pair):
    """Two iterations of problem (3) under ``column``: each layer update
    projects its experts per expert, the final projection whole."""
    jmodel, np_params, model, cfg = pair
    rng = np.random.default_rng(3)
    batches = [rng.integers(0, 512, (BATCH, SEQ)).astype(np.int32)
               for _ in range(2)]
    J = type("J", (_Fed, JLMAdapter), {"wrap": staticmethod(jnp.asarray)})
    T = type("T", (_Fed, LMAdapter), {"wrap": staticmethod(
        lambda x: torch.from_numpy(x).long())})
    ja, ta = J(jmodel, seq_len=SEQ), T(model, seq_len=SEQ)
    ja.fed, ta.fed = list(batches), list(batches)
    kw = dict(scheme="column", alpha=0.5, iterations=2, batch_size=BATCH,
              lr=1e-3, rho_init=1e-3, rho_every_iters=1, rho_max=1e-1)
    jres = JPruner(ja, JPruneConfig(**kw)).run_layerwise(
        jax.random.PRNGKey(1), jax.tree.map(jnp.asarray, np_params))
    tres = PrivacyPreservingPruner(ta, PruneConfig(**kw)).run_layerwise(
        as_key(1), params_from_jax(np_params, cfg, "cpu"))
    assert not ja.fed and not ta.fed
    assert tres.history["rho"] == jres.history["rho"]
    for k in ("loss", "residual"):
        _close(tres.history[k], jres.history[k], k)
    masks = tree_to_jax(tres.masks)
    jmasks = jax.tree.map(np.asarray, jres.masks)
    params = tree_to_jax(tres.params)
    jparams = jax.tree.map(np.asarray, jres.params)
    for path, want in _ref_flat(jmasks).items():
        got = dict(tree_items(masks))[path]
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want, np.float32), path)
    for path, want in _ref_flat(jparams).items():
        _close(dict(tree_items(params))[path].numpy(), want, path)


# ------------------------------------------------------ convert, artifact

def test_convert_round_trips_bit_equal(pair):
    jmodel, np_params, _, cfg = pair
    params = params_from_jax(np_params, cfg, "cpu")
    assert params["blocks"][0]["moe"]["experts"]["w_gate"].shape == \
        (8, 64, 32)
    assert params["blocks"][0]["moe"]["router"].dtype == torch.float32
    back = dict(tree_items(tree_to_jax(params)))
    flat = _ref_flat(np_params)
    assert set(back) == set(flat)
    for path, want in flat.items():
        assert torch.equal(back[path], torch.from_numpy(np.asarray(want)))
    jart = j_greedy_prune(jax.tree.map(jnp.asarray, np_params), JPruneConfig(
        scheme="tile_pattern", exclude=tuple(J_EXCLUDE) + EXPERTS,
        overrides=TILE)).to_artifact().pack()
    jpacked = jax.tree.map(np.asarray, jart.packed)
    packed = packed_from_jax(jpacked, cfg, "cpu")
    _assert_tree_matches(packed, jart.packed)
    _assert_tree_matches(packed_from_jax(tree_to_jax(packed), cfg, "cpu"),
                         jart.packed)


def test_artifact_round_trips_both_ways(pair, tmp_path):
    jmodel, np_params, model, cfg = pair
    kw = dict(scheme="tile_pattern", overrides=TILE)
    jart = j_greedy_prune(jax.tree.map(jnp.asarray, np_params), JPruneConfig(
        exclude=tuple(J_EXCLUDE) + EXPERTS, **kw)).to_artifact().pack()
    art = greedy_prune(params_from_jax(np_params, cfg, "cpu"), PruneConfig(
        exclude=DEFAULT_EXCLUDE + EXPERTS, **kw), device="cpu").pack(
            device="cpu")
    jart.save(str(tmp_path / "ref"))
    got = PrunedArtifact.load(str(tmp_path / "ref"), cfg=cfg, device="cpu")
    for name in ("params", "packed", "masks"):
        _assert_tree_matches(getattr(got, name), getattr(jart, name))
    got.bind(model, packed=True)
    assert got.bind_report["fallbacks"] == {}
    art.save(str(tmp_path / "port"))
    jgot = JPrunedArtifact.load(str(tmp_path / "port"))
    for name in ("params", "packed", "masks"):
        _assert_tree_matches(getattr(art, name), getattr(jgot, name))
    jgot.bind(jmodel, packed=True)
    assert jgot.bind_report["fallbacks"] == {}


# ----------------------------------------------------------- the launchers

def test_prune_launcher_refuses_tile_and_serves_column(tmp_path):
    """No ``--exclude`` flag: ``--scheme tile_pattern`` raises, as the
    reference's launcher does; ``column`` prunes, packs and serves the
    dense-pruned tokens."""
    from repro_torch.launch import prune, serve

    common = ["--arch", NAME, "--reduced", "--rate", "2", "--iters", "1",
              "--batch", "2", "--seq", "16", "--tile-block", "32",
              "--device", "cpu"]
    with pytest.raises(ValueError, match="not divisible"):
        prune.main(common + ["--scheme", "tile_pattern", "--out",
                             str(tmp_path / "tile")])
    art = str(tmp_path / "artifact")
    prune.main(common + ["--scheme", "column", "--out",
                         str(tmp_path / "out"), "--artifact-out", art])
    argv = ["--arch", NAME, "--reduced", "--artifact", art, "--requests",
            "3", "--batch", "2", "--prompt-len", "16", "--max-new", "5",
            "--device", "cpu"]
    packed = serve.main(argv + ["--packed"])
    assert [r.tokens for r in packed] == [r.tokens for r in serve.main(argv)]
    assert all(len(r.tokens) == 5 for r in packed)
