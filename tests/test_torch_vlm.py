"""pixtral-12b (``family="vlm"``) in the port against the reference.

The model's image front end is a stub: it takes (B, S, D) patch
embeddings, so its tree has no ``embed`` table and its decode steps take
(B, 1, D) embeddings, as the reference's dry run drives it. The reference's
weights for ``reduced_config("pixtral-12b")`` (made from a seed, carried
across with ``convert.params_from_jax``) and the same numpy embeddings go
through both packages on the CPU:

- ``hidden_states``, ``lm_logits`` and ``train_loss`` within fp32 2e-5;
- ``prefill`` on embeddings, then 4 ``decode_step``s and a
  ``verify_chunk`` on embeddings, logits within 2e-5, cache positions
  exact;
- the greedy tile-pattern prune: masks and packed buffers exactly the
  reference's; packed logits within 2e-5 of the dense-pruned ones;
- the artifact saved by either package loads bit-equal in the other, and
  has no ``embed`` leaf;
- ``launch.prune --arch pixtral-12b --reduced`` prunes on N(0, 1)
  synthetic embeddings and writes a packed artifact;
- ``launch.serve`` and the three engines refuse the model: decoding feeds
  sampled token ids back, and the model has no table for them.
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
from repro.models import build_model as j_build_model
from repro.sparse import PrunedArtifact as JPrunedArtifact
from repro.sparse.packed import is_packed as j_is_packed
from repro.utils.tree import tree_paths
from repro_torch.configs import reduced_config
from repro_torch.convert import params_from_jax, tensor_from_numpy
from repro_torch.core import DEFAULT_EXCLUDE, PruneConfig, greedy_prune
from repro_torch.models import build_model
from repro_torch.serve import ContinuousEngine, ServeEngine
from repro_torch.serve.speculative import SpeculativeEngine
from repro_torch.sparse import PrunedArtifact, is_packed
from repro_torch.utils.tree import reference_path, tree_items

TOL = 2e-5
ARCH = "pixtral-12b"
TILE = {".*": {"tile_block_p": 32}}
B, S, SEQ = 2, 24, 40


@pytest.fixture(scope="module")
def pair():
    """(reference model, params), (port model, params): same weights."""
    jcfg = j_reduced_config(ARCH)
    jmodel = j_build_model(jcfg)
    np_params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(3)))
    cfg = reduced_config(ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    return ((jmodel, jax.tree.map(jnp.asarray, np_params)),
            (build_model(cfg, device="cpu"),
             params_from_jax(np_params, cfg, "cpu")))


def _emb(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape,
                                                       dtype=np.float32)


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=TOL)


def test_tree_has_no_embedding_table(pair):
    (_, jparams), (model, params) = pair
    assert "embed" not in params and "embed" not in jparams
    assert set(model.param_shapes()) == {p for p, _ in tree_items(params)}
    assert model.lm_head_weight(params) is params["lm_head"]
    cfg = model.config
    assert cfg.attn_dim == cfg.num_heads * cfg.head_dim


def test_forward_and_loss_match_reference(pair):
    (jmodel, jparams), (model, params) = pair
    x = _emb((B, S, 64), 0)
    labels = np.random.default_rng(1).integers(0, 512, (B, S)).astype(
        np.int32)
    jh, _, _ = jmodel.hidden_states(jparams, jnp.asarray(x))
    h, _ = model.hidden_states(params, torch.from_numpy(x))
    _close(h, jh)
    _close(model.lm_logits(params, h), jmodel.lm_logits(jparams, jh))
    batch = {"inputs": x, "labels": labels}
    want = jmodel.train_loss(jparams, jax.tree.map(jnp.asarray, batch))
    got = model.train_loss(params, {"inputs": torch.from_numpy(x),
                                    "labels": torch.from_numpy(labels)})
    assert abs(float(got) - float(want)) <= TOL


def test_embeddings_of_the_wrong_shape_raise(pair):
    _, (model, params) = pair
    with pytest.raises(ValueError, match="embeddings"):
        model.hidden_states(params, torch.zeros((B, S), dtype=torch.int64))


def test_prefill_decode_and_verify_on_embeddings_match_reference(pair):
    (jmodel, jparams), (model, params) = pair
    x = _emb((B, S, 64), 2)
    jcache, jl = jmodel.prefill(jparams, jnp.asarray(x), SEQ)
    cache, logits = model.prefill(params, torch.from_numpy(x), SEQ)
    _close(logits, jl)
    for step in range(4):
        e = _emb((B, 1, 64), 10 + step)
        jcache, jl = jmodel.decode_step(jparams, jcache, jnp.asarray(e))
        cache, logits = model.decode_step(params, cache, torch.from_numpy(e))
        _close(logits, jl)
    e = _emb((B, 3, 64), 20)
    jcache, jl = jmodel.verify_chunk(jparams, jcache, jnp.asarray(e))
    cache, logits = model.verify_chunk(params, cache, torch.from_numpy(e))
    _close(logits, jl)
    np.testing.assert_array_equal(cache["pos"].numpy(),
                                  np.asarray(jcache["pos"]))
    np.testing.assert_array_equal(cache["slot_pos"].numpy(),
                                  np.asarray(jcache["slot_pos"]))
    _close(torch.stack(cache["k"]), jcache["k"])


# ------------------------------------------------------------ prune and pack

@pytest.fixture(scope="module")
def arts(pair):
    (_, jparams), (_, params) = pair
    jart = j_greedy_prune(jparams, JPruneConfig(
        scheme="tile_pattern", exclude=tuple(J_EXCLUDE),
        overrides=TILE)).to_artifact(arch=ARCH).pack()
    art = greedy_prune(params, PruneConfig(
        scheme="tile_pattern", exclude=DEFAULT_EXCLUDE, overrides=TILE),
        device="cpu").pack(device="cpu")
    return jart, art


def _assert_tree_matches(port_tree, ref_tree):
    """Every port leaf bit-equal (dtype included) to the reference's leaf
    at its path (its layer's slice of a stacked block leaf), packed
    buffers included; no reference leaf left unmatched."""
    ref = dict(zip(tree_paths(ref_tree, is_leaf=j_is_packed),
                   jax.tree.leaves(ref_tree, is_leaf=j_is_packed)))

    def at(path, a):
        a = np.asarray(a)
        return tensor_from_numpy(a[int(path.split("/")[1])]
                                 if path.startswith("blocks/") else a, "cpu")

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
            want = at(path, b)
            assert a.dtype == want.dtype and torch.equal(a, want), path
    assert seen == set(ref)


def test_greedy_masks_and_packed_buffers_equal_reference(arts):
    jart, art = arts
    _assert_tree_matches(art.masks, jart.masks)
    _assert_tree_matches(art.params, jart.params)
    _assert_tree_matches(art.packed, jart.packed)
    packed = {p for p, x in tree_items(art.packed) if is_packed(x)}
    # wq (64 -> 64), wk / wv (64 -> 32) and wo (64 -> 64) at attn_dim
    # 64, the FFN and the head all pack
    assert {p.split("/", 2)[-1] for p in packed if p.startswith("blocks/")} \
        == {"attn/wq", "attn/wk", "attn/wv", "attn/wo", "mlp/w_gate",
            "mlp/w_up", "mlp/w_down"}
    assert "lm_head" in packed


def test_packed_logits_match_dense_pruned(pair, arts):
    _, (model, _) = pair
    _, art = arts
    x = torch.from_numpy(_emb((B, S, 64), 4))
    with torch.no_grad():
        h, _ = model.hidden_states(art.params, x)
        want = model.lm_logits(art.params, h)
        packed = art.bind(model, packed=True)
        hp, _ = model.hidden_states(packed, x)
        got = model.lm_logits(packed, hp)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=TOL)
    cache, want = model.prefill(art.params, x, SEQ)
    pcache, got = model.prefill(packed, x, SEQ)
    e = torch.from_numpy(_emb((B, 1, 64), 5))
    want = model.decode_step(art.params, cache, e)[1]
    got = model.decode_step(packed, pcache, e)[1]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=TOL)


def test_artifacts_load_bit_equal_across_packages(pair, arts, tmp_path):
    (jmodel, _), (model, _) = pair
    jart, art = arts
    art.save(str(tmp_path / "port"))
    got = JPrunedArtifact.load(str(tmp_path / "port"))
    assert "embed" not in got.params
    _assert_tree_matches(art.params, got.params)
    _assert_tree_matches(art.packed, got.packed)
    _assert_tree_matches(art.masks, got.masks)
    got.bind(jmodel, packed=True)
    jart.save(str(tmp_path / "ref"))
    back = PrunedArtifact.load(str(tmp_path / "ref"),
                               cfg=reduced_config(ARCH), device="cpu")
    assert "embed" not in back.params
    _assert_tree_matches(back.params, jart.params)
    _assert_tree_matches(back.packed, jart.packed)
    back.bind(model, packed=True)
    assert back.bind_report["fallbacks"] == {}


# --------------------------------------------------------------- launchers

def test_prune_launcher_prunes_on_synthetic_embeddings(tmp_path):
    from repro_torch.launch import prune

    art = str(tmp_path / "artifact")
    result = prune.main(["--arch", ARCH, "--reduced", "--scheme",
                         "tile_pattern", "--rate", "2", "--iters", "2",
                         "--batch", "2", "--seq", "16", "--tile-block", "32",
                         "--out", str(tmp_path / "out"), "--artifact-out",
                         art, "--device", "cpu"])
    assert result.provenance["data"] == "synthetic"
    assert result.provenance["generator"] == "normal_embeddings"
    loaded = PrunedArtifact.load(art, cfg=reduced_config(ARCH), device="cpu")
    assert loaded.summary()["packed_leaves"] > 0
    assert "embed" not in loaded.params
    assert loaded.privacy["generator"] == "normal_embeddings"


def test_serve_launcher_and_engines_refuse_the_model(pair):
    from repro_torch.launch import serve

    with pytest.raises(SystemExit, match="stub front end"):
        serve.main(["--arch", ARCH, "--reduced", "--device", "cpu"])
    _, (model, params) = pair
    kw = dict(batch_size=2, max_seq_len=32, device="cpu")
    for make in (lambda: ServeEngine(model, params, **kw),
                 lambda: ContinuousEngine(model, params, **kw),
                 lambda: SpeculativeEngine(model, params, params, **kw)):
        with pytest.raises(ValueError, match="token ids back"):
            make()
    tokens_model = build_model(dataclasses.replace(
        model.config, input_kind="tokens", name="tokens"), device="cpu")
    with pytest.raises(ValueError, match=r"SpeculativeEngine \(drafter\)"):
        SpeculativeEngine(tokens_model, params, params, draft_model=model,
                          **kw)
