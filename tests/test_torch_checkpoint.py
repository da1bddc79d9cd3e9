"""Checkpoints and artifacts on disk: the port against the reference.

Artifacts are built by both packages from the same reference init (handed
over as numpy through ``repro_torch.convert``), at ``reduced_config
("qwen2-1.5b")`` (2 layers, d_model 64, tile_block_p 32) tile-pattern
packed in bf16 and fp32 and column packed in fp32, and for a
pattern-shared VGG-16 at width 0.125. What one package saves, the other
loads with bit-equal buffers (bf16 through its uint16 bits), specs, meta
and masks; the reference serves the port's saved fp32 artifacts to the
port's own greedy tokens; every damaged directory raises ``ArtifactError``
in both packages.
"""

import dataclasses
import json
import os
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ArtifactError as JArtifactError
from repro.checkpoint import load_pytree as j_load_pytree
from repro.checkpoint import save_pytree as j_save_pytree
from repro.configs import reduced_config as j_reduced_config
from repro.core import DEFAULT_EXCLUDE as J_EXCLUDE
from repro.core import PruneConfig as JPruneConfig
from repro.core import greedy_prune as j_greedy_prune
from repro.core import masks as j_masks
from repro.models import build_model
from repro.models.cnn import vgg16 as j_vgg16
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro.sparse import PrunedArtifact as JPrunedArtifact
from repro.sparse.packed import is_packed as j_is_packed
from repro.core.schemes import LayerSpec as JLayerSpec
from repro.utils.tree import tree_map_with_path_str, tree_paths
from repro_torch.checkpoint import (
    ArtifactError,
    load_pytree,
    restore_pytree,
    save_pytree,
    verify_checkpoint,
)
from repro_torch.configs import reduced_config
from repro_torch.convert import params_from_jax, tensor_from_numpy, tree_to_jax
from repro_torch.core import (
    DEFAULT_EXCLUDE,
    PruneConfig,
    apply_mask,
    compression_rate,
    greedy_prune,
    mask_from_params,
    mask_gradients,
    sparsity,
)
from repro_torch.models import LM, vgg16
from repro_torch.serve import Request, ServeEngine
from repro_torch.sparse import PrunedArtifact, is_packed
from repro_torch.utils.tree import reference_path, tree_items, tree_map_with_path

TILE = {".*": {"tile_block_p": 32, "tile_group_q": 8, "tile_keep": 4}}
# name -> (scheme, param dtype, overrides); "vgg16" is the CNN case
CASES = {"tile_bf16": ("tile_pattern", "bfloat16", TILE),
         "tile_fp32": ("tile_pattern", "float32", TILE),
         "column_fp32": ("column", "float32", {}),
         "vgg16": ("pattern_shared", "float32", {})}
CNN_KW = dict(num_classes=10, width_mult=0.125, image_hwc=(16, 16, 3))


def _build(name):
    """(reference model, reference artifact, port model, port artifact,
    port config or None)."""
    scheme, dtype, overrides = CASES[name]
    if name == "vgg16":
        jmodel = j_vgg16(**CNN_KW)
        tmodel, tcfg = vgg16(**CNN_KW, device="cpu"), None
        jpcfg = JPruneConfig(scheme=scheme, alpha=0.25)
        tpcfg = PruneConfig(scheme=scheme, alpha=0.25)
    else:
        jcfg = j_reduced_config("qwen2-1.5b", param_dtype=dtype)
        jmodel = build_model(jcfg)
        tcfg = reduced_config("qwen2-1.5b", param_dtype=dtype)
        tmodel = LM(tcfg, device="cpu")
        jpcfg = JPruneConfig(scheme=scheme, alpha=0.5,
                             exclude=tuple(J_EXCLUDE), overrides=overrides)
        tpcfg = PruneConfig(scheme=scheme, alpha=0.5,
                            exclude=DEFAULT_EXCLUDE, overrides=overrides)
    np_params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    jart = j_greedy_prune(jax.tree.map(jnp.asarray, np_params),
                          jpcfg).to_artifact().pack()
    tart = greedy_prune(params_from_jax(np_params, tcfg, "cpu"), tpcfg,
                        device="cpu").pack(device="cpu")
    return jmodel, jart, tmodel, tart, tcfg


@pytest.fixture(scope="module")
def built():
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = _build(name)
        return cache[name]

    return get


def _ref_flat(tree):
    """'/'-path -> leaf of a reference tree (None leaves left out)."""
    return dict(zip(tree_paths(tree, is_leaf=j_is_packed),
                    jax.tree.leaves(tree, is_leaf=j_is_packed)))


def _layer_slice(path, a, stacked):
    if stacked and path.startswith("blocks/"):
        return np.asarray(a)[int(path.split("/")[1])]
    return np.asarray(a)


def _assert_tree_matches(port_tree, ref_tree, stacked):
    """Every port leaf bit-equal (dtype included) to the reference's leaf
    at its reference path (its layer's slice for stacked blocks), and no
    reference leaf left unmatched."""
    ref = _ref_flat(ref_tree)
    seen = set()
    for path, leaf in tree_items(port_tree):
        rpath = reference_path(path) if stacked else path
        if leaf is None:
            assert rpath not in ref, path
            continue
        seen.add(rpath)
        r = ref[rpath]
        if is_packed(leaf):
            assert j_is_packed(r), path
            assert leaf.scheme == r.scheme and leaf.names == tuple(r.names)
            want_shape = tuple(r.shape)[1:] if stacked and path.startswith(
                "blocks/") else tuple(r.shape)
            assert tuple(leaf.shape) == want_shape, path
            for a, b in zip(leaf.buffers, r.buffers):
                want = tensor_from_numpy(_layer_slice(path, b, stacked),
                                         "cpu")
                assert a.dtype == want.dtype and torch.equal(a, want), path
            continue
        assert not j_is_packed(r), path
        want = tensor_from_numpy(_layer_slice(path, r, stacked), "cpu")
        assert leaf.dtype == want.dtype and torch.equal(leaf, want), path
    assert seen == set(ref)


def _assert_specs_meta_match(tart, jart, stacked):
    jspecs = {}
    tree_map_with_path_str(lambda p, s: jspecs.__setitem__(p, s), jart.specs,
                           is_leaf=lambda x: x is None or isinstance(
                               x, JLayerSpec))
    for path, spec in tree_items(tart.specs):
        want = jspecs[reference_path(path) if stacked else path]
        assert (spec is None) == (want is None), path
        if spec is not None:
            assert dataclasses.asdict(spec) == dataclasses.asdict(want), path
    assert json.loads(json.dumps(tart.meta)) == json.loads(
        json.dumps(jart.meta))


@pytest.mark.parametrize("name", sorted(CASES))
def test_reference_artifact_loads_bit_equal(built, name, tmp_path):
    _, jart, tmodel, _, tcfg = built(name)
    jart.save(str(tmp_path / "art"))
    got = PrunedArtifact.load(str(tmp_path / "art"), cfg=tcfg, device="cpu")
    stacked = tcfg is not None
    _assert_tree_matches(got.params, jart.params, stacked)
    _assert_tree_matches(got.packed, jart.packed, stacked)
    _assert_tree_matches(got.masks, jart.masks, stacked)
    _assert_specs_meta_match(got, jart, stacked)
    assert got.source_dir == str(tmp_path / "art")
    got.bind(tmodel, packed=True)
    assert got.bind_report["fallbacks"] == {}
    assert got.summary()["packed_leaves"] > 0


@pytest.mark.parametrize("name", sorted(CASES))
def test_port_artifact_loads_bit_equal_in_reference(built, name, tmp_path):
    jmodel, jart, _, tart, tcfg = built(name)
    stacked = tcfg is not None
    # the two packages pruned the same weights to the same artifact
    _assert_tree_matches(tart.params, jart.params, stacked)
    _assert_tree_matches(tart.masks, jart.masks, stacked)
    tart.save(str(tmp_path / "art"))
    got = JPrunedArtifact.load(str(tmp_path / "art"))
    _assert_tree_matches(tart.params, got.params, stacked)
    _assert_tree_matches(tart.packed, got.packed, stacked)
    _assert_tree_matches(tart.masks, got.masks, stacked)
    _assert_specs_meta_match(tart, got, stacked)
    got.bind(jmodel, packed=True)
    assert got.bind_report["fallbacks"] == {}


@pytest.mark.parametrize("name", ["tile_fp32", "column_fp32"])
def test_port_artifact_served_by_reference_to_the_same_tokens(built, name,
                                                              tmp_path):
    jmodel, _, tmodel, tart, tcfg = built(name)
    tart.save(str(tmp_path / "art"))
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, tcfg.vocab_size, n).astype(np.int32)
               for n in (7, 7, 4, 9)]
    jengine = JServeEngine(jmodel, JPrunedArtifact.load(str(tmp_path / "art")),
                           batch_size=2, max_seq_len=32, packed=True)
    want = [r.tokens for r in jengine.generate(
        [JRequest(uid=i, prompt=jnp.asarray(p), max_new_tokens=5)
         for i, p in enumerate(prompts)])]
    reqs = [Request(uid=i, prompt=torch.from_numpy(p), max_new_tokens=5)
            for i, p in enumerate(prompts)]
    for art in (tart, PrunedArtifact.load(str(tmp_path / "art"), cfg=tcfg,
                                          device="cpu")):
        engine = ServeEngine(tmodel, art, batch_size=2, max_seq_len=32,
                             packed=True, device="cpu")
        assert [r.tokens for r in engine.generate(reqs)] == want


def test_verify_integrity_reports_match(built, tmp_path):
    _, jart, _, tart, tcfg = built("tile_bf16")
    tart.save(str(tmp_path / "art"))
    want = JPrunedArtifact.load(str(tmp_path / "art")).verify_integrity()
    got = PrunedArtifact.load(str(tmp_path / "art"), cfg=tcfg,
                              device="cpu").verify_integrity()
    assert got["disk"] == want["disk"]
    # the reference counts one stacked leaf per GEMM, the port one per layer
    assert got["packed_bad"] == want["packed_bad"] == {}
    assert got["packed_ok"] == 7 * tcfg.num_layers + 1
    assert want["packed_ok"] == 7 + 1
    assert set(got["disk"]) == {"params", "masks", "packed"}


# ------------------------------------------------------------- damaged dirs

def _first_buffer(directory):
    sub = os.path.join(directory, "packed")
    names = sorted(f for f in os.listdir(sub) if f.endswith(".npy"))
    return os.path.join(sub, names[0])


def _flip(directory):
    path = _first_buffer(directory)
    data = bytearray(open(path, "rb").read())
    data[-1] ^= 0x01
    open(path, "wb").write(bytes(data))


def _truncate_json(directory):
    path = os.path.join(directory, "artifact.json")
    data = open(path).read()
    open(path, "w").write(data[: len(data) // 2])


def _future_artifact_schema(directory):
    path = os.path.join(directory, "artifact.json")
    doc = json.load(open(path))
    doc["schema_version"] = 99
    json.dump(doc, open(path, "w"))


def _future_manifest_schema(directory):
    path = os.path.join(directory, "params", "manifest.json")
    doc = json.load(open(path))
    doc["schema_version"] = 3
    json.dump(doc, open(path, "w"))


def _missing_buffer(directory):
    os.remove(_first_buffer(directory))


DAMAGE = {"flipped_byte": _flip, "truncated_artifact_json": _truncate_json,
          "future_artifact_schema": _future_artifact_schema,
          "future_manifest_schema": _future_manifest_schema,
          "missing_buffer": _missing_buffer}


@pytest.mark.parametrize("loader", ["reference", "port"])
@pytest.mark.parametrize("damage", sorted(DAMAGE))
def test_damaged_artifact_raises_artifact_error(built, damage, loader,
                                                tmp_path):
    _, _, _, tart, tcfg = built("tile_bf16")
    d = str(tmp_path / "art")
    tart.save(d)
    DAMAGE[damage](d)
    if loader == "reference":
        with pytest.raises(JArtifactError) as err:
            JPrunedArtifact.load(d)
    else:
        with pytest.raises(ArtifactError) as err:
            PrunedArtifact.load(d, cfg=tcfg, device="cpu")
    assert err.value.field is not None and err.value.path is not None


def test_bit_flip_after_load_fails_verify_integrity(built, tmp_path):
    _, _, _, tart, tcfg = built("tile_bf16")
    d = str(tmp_path / "art")
    tart.save(d)
    art = PrunedArtifact.load(d, cfg=tcfg, device="cpu")
    _flip(d)
    with pytest.raises(ArtifactError, match="crc32"):
        art.verify_integrity()


def test_artifact_that_does_not_fit_the_config_raises(built, tmp_path):
    _, _, _, tart, tcfg = built("tile_fp32")
    tart.save(str(tmp_path / "art"))
    deeper = dataclasses.replace(tcfg, num_layers=tcfg.num_layers + 1)
    with pytest.raises(ArtifactError):
        PrunedArtifact.load(str(tmp_path / "art"), cfg=deeper, device="cpu")


# ------------------------------------------------------------- checkpoints

def _tree():
    g = torch.Generator().manual_seed(0)
    return {"w": torch.randn(3, 5, generator=g).to(torch.bfloat16),
            "idx": torch.arange(6, dtype=torch.int32).reshape(2, 3),
            "flags": torch.tensor([True, False]),
            "seq": [torch.ones(2), None, (torch.zeros(1, dtype=torch.int64),)],
            "10": torch.full((2,), 3.0), "2": torch.full((1,), 2.0)}


def _assert_equal_trees(a, b):
    """Same paths (a load rebuilds dicts in sorted key order), same leaves."""
    ia, ib = dict(tree_items(a)), dict(tree_items(b))
    assert set(ia) == set(ib)
    for p, x in ia.items():
        y = ib[p]
        assert (x is None) == (y is None), p
        if x is not None:
            assert x.dtype == y.dtype and torch.equal(x, y), p


def test_pytree_round_trip_and_restore(tmp_path):
    tree = _tree()
    save_pytree(str(tmp_path / "c"), tree, extra={"step": 3})
    got = load_pytree(str(tmp_path / "c"), device="cpu")
    assert isinstance(got["seq"], list) and isinstance(got["seq"][2], tuple)
    _assert_equal_trees(tree, got)
    like = {**tree, "w": torch.zeros(3, 5, dtype=torch.bfloat16)}
    _assert_equal_trees(tree, restore_pytree(str(tmp_path / "c"), like))
    stats = verify_checkpoint(str(tmp_path / "c"))
    assert stats == {"leaves": 7, "buffers": 7, "schema_version": 2}
    manifest = json.load(open(tmp_path / "c" / "manifest.json"))
    assert manifest["extra"] == {"step": 3}
    with pytest.raises(ArtifactError):
        restore_pytree(str(tmp_path / "c"), {"w": like["w"]})


def test_pytree_crosses_packages_both_ways(tmp_path):
    tree = _tree()
    save_pytree(str(tmp_path / "port"), tree)
    back = j_load_pytree(str(tmp_path / "port"))
    assert str(back["w"].dtype) == "bfloat16"
    assert isinstance(back["seq"][2], tuple) and back["seq"][1] is None
    for path, leaf in tree_items(tree):
        if leaf is not None:
            ref = _ref_flat(back)[path]
            assert torch.equal(tensor_from_numpy(ref, "cpu"), leaf), path
    j_save_pytree(str(tmp_path / "ref"), back)
    _assert_equal_trees(tree, load_pytree(str(tmp_path / "ref"),
                                          device="cpu"))


def test_schema_v1_manifest_loads(tmp_path):
    """A pre-checksum manifest (no schema_version, no crc32) loads and
    verifies nothing."""
    tree = _tree()
    save_pytree(str(tmp_path / "c"), tree)
    path = tmp_path / "c" / "manifest.json"
    doc = json.load(open(path))
    del doc["schema_version"]
    for leaf in doc["leaves"]:
        leaf.pop("crc32")
    json.dump(doc, open(path, "w"))
    _assert_equal_trees(tree, load_pytree(str(tmp_path / "c"), device="cpu"))
    assert verify_checkpoint(str(tmp_path / "c"))["buffers"] == 0


def test_crc_covers_the_whole_file(tmp_path):
    save_pytree(str(tmp_path / "c"), {"a": torch.arange(4)})
    doc = json.load(open(tmp_path / "c" / "manifest.json"))
    entry = doc["leaves"][0]
    data = open(tmp_path / "c" / entry["file"], "rb").read()
    assert entry["crc32"] == zlib.crc32(data) & 0xFFFFFFFF
    assert entry["dtype"] == "int64" and entry["shape"] == [4]


# ------------------------------------------------------------------- masks

def test_mask_functions_match_reference(built):
    _, jart, _, tart, _ = built("tile_fp32")
    assert sparsity(tart.masks) == pytest.approx(j_masks.sparsity(jart.masks),
                                                 abs=1e-12)
    assert compression_rate(tart.masks) == pytest.approx(
        j_masks.compression_rate(jart.masks), rel=1e-12)
    g = torch.Generator().manual_seed(1)
    grads = tree_map_with_path(lambda _, w: torch.randn(w.shape, generator=g),
                               tart.params)
    stacked = _ref_flat(tree_to_jax(grads))
    jgrads = tree_map_with_path_str(
        lambda p, _: jnp.asarray(stacked[p].numpy()), jart.params)
    want = _ref_flat(j_masks.mask_gradients(jgrads, jart.masks))
    for path, leaf in tree_items(mask_gradients(grads, tart.masks)):
        r = _layer_slice(path, want[reference_path(path)], True)
        assert torch.equal(leaf, torch.from_numpy(np.array(r))), path
    # the pruned weights are exactly sparse: masking leaves them as they are
    for (p, a), (_, b) in zip(tree_items(apply_mask(tart.params, tart.masks)),
                              tree_items(tart.params)):
        assert torch.equal(a, b), p
    assert all(m.dtype == torch.bfloat16
               for _, m in tree_items(mask_from_params(tart.params)))


def test_column_layers_of_unequal_width_round_trip(built, tmp_path):
    """Layers that keep different row counts are padded when stacked (as
    the reference pads them); the port's load cuts each layer back to what
    it packed, so the round trip is bit-equal and serves the same tokens,
    and the reference serves the padded artifact to them too."""
    jmodel, _, tmodel, tart, tcfg = built("column_fp32")
    params = {**tart.params, "blocks": [dict(b) for b in tart.params["blocks"]]}
    mlp = dict(params["blocks"][0]["mlp"])
    w = mlp["w_up"].clone()
    w[int(torch.nonzero(w.any(dim=1))[3])] = 0.0     # one more row pruned
    mlp["w_up"] = w
    params["blocks"][0]["mlp"] = mlp
    art = dataclasses.replace(tart, params=params, packed=None).pack(
        device="cpu")
    kept = [b["mlp"]["w_up"].buf("kept_idx").shape[0]
            for b in art.packed["blocks"]]
    assert kept[0] == kept[1] - 1
    art.save(str(tmp_path / "art"))
    got = PrunedArtifact.load(str(tmp_path / "art"), cfg=tcfg, device="cpu")
    for (p, a), (_, b) in zip(tree_items(art.packed), tree_items(got.packed)):
        if is_packed(a):
            assert all(torch.equal(x, y) for x, y in zip(a.buffers, b.buffers))
        else:
            assert torch.equal(a, b), p
    jart = JPrunedArtifact.load(str(tmp_path / "art"))
    assert jart.packed["blocks"]["mlp"]["w_up"].buffers[1].shape == (2, kept[1])
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, tcfg.vocab_size, 6).astype(np.int32)
               for _ in range(2)]
    reqs = [Request(uid=i, prompt=torch.from_numpy(p), max_new_tokens=4)
            for i, p in enumerate(prompts)]
    tokens = [[r.tokens for r in ServeEngine(
        tmodel, a, batch_size=2, max_seq_len=16, packed=True,
        device="cpu").generate(reqs)] for a in (art, got)]
    want = [r.tokens for r in JServeEngine(
        jmodel, jart, batch_size=2, max_seq_len=16, packed=True).generate(
        [JRequest(uid=i, prompt=jnp.asarray(p), max_new_tokens=4)
         for i, p in enumerate(prompts)])]
    assert tokens[0] == tokens[1] == want
