"""hubert-xlarge (``family="audio"``) in the port against the reference.

An encoder: its conv feature extractor is a stub, so it takes (B, S, D)
frame embeddings and has no ``embed`` table; attention runs both ways
(``causal=False``) and its FFN is GELU. It has no decode path: the
reference's dry run and the port serve it as one forward,
``hidden_states`` then ``lm_logits``. The reference's weights for
``reduced_config("hubert-xlarge")`` and the same numpy frames go through
both packages on the CPU:

- the bidirectional forward (a later frame moves an earlier position),
  the serving forward (``use_flash``), ``train_loss`` and ``prefill``
  within fp32 2e-5;
- the plain flash version at hubert's heads (MHA, hd 80, non-causal, a
  ragged S) against the reference's ``ref_attention``;
- the greedy tile-pattern prune (``w_up`` carries the GELU epilogue):
  masks and packed buffers exactly the reference's, packed logits within
  2e-5 of dense-pruned; a port artifact loads bit-equal in the reference;
- the full-width head (1 280 x 504): 504 rows are no multiple of
  ``block_p`` 128, so both packages' tile projection refuses it and both
  packers keep it dense;
- ``launch.prune --arch hubert-xlarge --reduced`` on synthetic frames;
  ``launch.serve`` and the engines refuse an encoder.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced_config as j_reduced_config
from repro.core import DEFAULT_EXCLUDE as J_EXCLUDE
from repro.core import PruneConfig as JPruneConfig
from repro.core import greedy_prune as j_greedy_prune
from repro.core.projections import project_tile_pattern as j_project_tile
from repro.core.schemes import LayerSpec as JLayerSpec
from repro.kernels import ref as j_ref
from repro.models import build_model as j_build_model
from repro.sparse import PrunedArtifact as JPrunedArtifact
from repro.sparse.packed import is_packed as j_is_packed
from repro.sparse.registry import handler_for as j_handler_for
from repro.utils.tree import tree_paths
from repro_torch.configs import get_config, reduced_config
from repro_torch.convert import params_from_jax, tensor_from_numpy
from repro_torch.core import DEFAULT_EXCLUDE, LayerSpec, PruneConfig
from repro_torch.core import greedy_prune
from repro_torch.core.projections import project_tile_pattern
from repro_torch.kernels import flash_attention as t_fa
from repro_torch.models import build_model
from repro_torch.serve import ContinuousEngine, ServeEngine
from repro_torch.sparse import PrunedArtifact, is_packed
from repro_torch.sparse.registry import handler_for
from repro_torch.utils.tree import reference_path, tree_items

TOL = 2e-5
ARCH = "hubert-xlarge"
TILE = {".*": {"tile_block_p": 32}}
B, S = 2, 40


@pytest.fixture(scope="module")
def pair():
    jcfg = j_reduced_config(ARCH)
    jmodel = j_build_model(jcfg)
    np_params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(5)))
    cfg = reduced_config(ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert not cfg.causal and cfg.encoder_only and cfg.ffn_type == "gelu"
    return ((jmodel, jax.tree.map(jnp.asarray, np_params)),
            (build_model(cfg, device="cpu"),
             params_from_jax(np_params, cfg, "cpu")))


def _frames(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape,
                                                       dtype=np.float32)


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=TOL)


def test_bidirectional_forward_and_loss_match_reference(pair):
    (jmodel, jparams), (model, params) = pair
    assert "embed" not in params and "lm_head" in params
    x = _frames((B, S, 64), 0)
    jh, _, _ = jmodel.hidden_states(jparams, jnp.asarray(x))
    h, _ = model.hidden_states(params, torch.from_numpy(x))
    _close(h, jh)
    _close(model.lm_logits(params, h), jmodel.lm_logits(jparams, jh))
    # the serving forward asks for flash (the plain path on the CPU)
    hf, _ = model.hidden_states(params, torch.from_numpy(x), use_flash=True)
    _close(hf, jh)
    # bidirectional: the last frame moves the first position
    y = x.copy()
    y[:, -1] += 1.0
    h2, _ = model.hidden_states(params, torch.from_numpy(y))
    assert float((h2[:, 0] - h[:, 0]).abs().max()) > 1e-4
    labels = np.random.default_rng(1).integers(0, 512, (B, S)).astype(
        np.int32)
    want = jmodel.train_loss(jparams, {"inputs": jnp.asarray(x),
                                       "labels": jnp.asarray(labels)})
    got = model.train_loss(params, {"inputs": torch.from_numpy(x),
                                    "labels": torch.from_numpy(labels)})
    assert abs(float(got) - float(want)) <= TOL


def test_prefill_matches_reference(pair):
    (jmodel, jparams), (model, params) = pair
    x = _frames((B, S, 64), 2)
    jcache, jl = jmodel.prefill(jparams, jnp.asarray(x), 48)
    cache, logits = model.prefill(params, torch.from_numpy(x), 48)
    _close(logits, jl)
    _close(torch.stack(cache["v"]), jcache["v"])


def test_flash_plain_version_at_hubert_heads():
    """MHA, hd 80, non-causal, S = 75 (no multiple of any tile)."""
    rng = np.random.default_rng(7)
    q, k, v = (rng.standard_normal((2, 75, 4, 80)).astype(np.float32)
               for _ in range(3))
    got = t_fa.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                               causal=False)
    want = j_ref.ref_attention(*(jnp.asarray(a) for a in (q, k, v)),
                               causal=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


# ------------------------------------------------------------ prune and pack

def _assert_tree_matches(port_tree, ref_tree):
    ref = dict(zip(tree_paths(ref_tree, is_leaf=j_is_packed),
                   jax.tree.leaves(ref_tree, is_leaf=j_is_packed)))

    def at(path, a):
        a = np.asarray(a)
        return tensor_from_numpy(a[int(path.split("/")[1])]
                                 if path.startswith("blocks/") else a, "cpu")

    seen = set()
    for path, leaf in tree_items(port_tree):
        if leaf is None:
            continue
        seen.add(reference_path(path))
        r = ref[reference_path(path)]
        assert is_packed(leaf) == j_is_packed(r), path
        pairs = (zip(leaf.buffers, r.buffers) if is_packed(leaf)
                 else [(leaf, r)])
        for a, b in pairs:
            want = at(path, b)
            assert a.dtype == want.dtype and torch.equal(a, want), path
    assert seen == set(ref)


def test_prune_pack_and_artifact_match_reference(pair, tmp_path):
    (jmodel, jparams), (model, params) = pair
    jart = j_greedy_prune(jparams, JPruneConfig(
        scheme="tile_pattern", exclude=tuple(J_EXCLUDE),
        overrides=TILE)).to_artifact(arch=ARCH).pack()
    art = greedy_prune(params, PruneConfig(
        scheme="tile_pattern", exclude=DEFAULT_EXCLUDE, overrides=TILE),
        device="cpu").pack(device="cpu")
    _assert_tree_matches(art.masks, jart.masks)
    _assert_tree_matches(art.packed, jart.packed)
    assert is_packed(art.packed["blocks"][0]["mlp"]["w_up"])
    x = torch.from_numpy(_frames((B, S, 64), 4))
    with torch.no_grad():
        h, _ = model.hidden_states(art.params, x)
        want = model.lm_logits(art.params, h)
        packed = art.bind(model, packed=True)
        hp, _ = model.hidden_states(packed, x, use_flash=True)
        got = model.lm_logits(packed, hp)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=TOL)
    art.save(str(tmp_path / "art"))
    loaded = JPrunedArtifact.load(str(tmp_path / "art"))
    assert "embed" not in loaded.params
    _assert_tree_matches(art.packed, loaded.packed)
    loaded.bind(jmodel, packed=True)


def test_full_width_head_stays_dense_in_both_packages():
    cfg, jcfg = get_config(ARCH), j_get_config(ARCH)
    D, V = cfg.d_model, cfg.vocab_size
    assert (D, V) == (jcfg.d_model, jcfg.vocab_size) == (1280, 504)
    w = np.random.default_rng(0).standard_normal((D, V)).astype(np.float32)
    # the projections take the (out, in) view: 504 rows, 504 % 128 = 120
    with pytest.raises(ValueError, match="not divisible"):
        project_tile_pattern(torch.from_numpy(w.T), block_p=128)
    with pytest.raises(ValueError, match="not divisible"):
        j_project_tile(jnp.asarray(w.T), block_p=128)
    spec = dict(scheme="tile_pattern", tile_block_p=128)
    assert handler_for("tile_pattern").pack(torch.from_numpy(w),
                                            LayerSpec(**spec)) is None
    assert j_handler_for("tile_pattern").pack(jnp.asarray(w),
                                              JLayerSpec(**spec)) is None


# --------------------------------------------------------------- launchers

def test_prune_launcher_prunes_on_synthetic_frames(tmp_path):
    from repro_torch.launch import prune

    result = prune.main(["--arch", ARCH, "--reduced", "--scheme",
                         "tile_pattern", "--rate", "2", "--iters", "2",
                         "--batch", "2", "--seq", "16", "--tile-block", "32",
                         "--out", str(tmp_path / "out"), "--artifact-out",
                         str(tmp_path / "artifact"), "--device", "cpu"])
    assert result.provenance["generator"] == "normal_embeddings"
    art = PrunedArtifact.load(str(tmp_path / "artifact"),
                              cfg=reduced_config(ARCH), device="cpu")
    assert art.summary()["packed_leaves"] > 0


def test_serve_launcher_and_engines_refuse_an_encoder(pair):
    from repro_torch.launch import serve

    with pytest.raises(SystemExit, match="encoder-only"):
        serve.main(["--arch", ARCH, "--reduced", "--device", "cpu"])
    _, (model, params) = pair
    for cls in (ServeEngine, ContinuousEngine):
        with pytest.raises(ValueError, match="hidden_states then"):
            cls(model, params, batch_size=2, max_seq_len=32, device="cpu")
