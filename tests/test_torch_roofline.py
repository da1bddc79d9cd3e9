"""The port's roofline model and attribution (``repro_torch/roofline``)
against the reference's ``repro/roofline`` on the CPU:

* ``RooflineTerms``, ``roofline_terms`` and ``model_flops_*`` keep the
  reference's formulas (the port's constants are the H100's);
* ``model_packed_costs`` of the same tile, column and pattern-conv leaves
  (packed from the same seeded numpy weights) gives the reference's flops
  and bytes exactly at itemsize 4, and halves the activation bytes at 2;
* ``attribute`` on the reference's profile rows, with the reference's
  ``peak_flops`` / ``hbm_bw``, gives the reference's rows within 1e-12
  relative, and ``render_report`` the same text;
* ``profile_packed_tree`` on the reference test's reduced artifact
  (``tests/test_profiler.py::TestAttribution``) gives the reference's
  (kind, scheme, bucket) keys and sample counts (the reference in
  interpret mode), a conv tree is profiled on its own channel count, and
  the report survives ``write_report`` / ``read_report``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JModelConfig
from repro.core import DEFAULT_EXCLUDE as J_DEFAULT_EXCLUDE
from repro.core import PruneConfig as JPruneConfig
from repro.core import greedy_prune as j_greedy_prune
from repro.core.schemes import LayerSpec as JLayerSpec
from repro.models import build_model as j_build_model
from repro.roofline import attribution as j_attr
from repro.roofline import hw as j_hw
from repro.sparse.registry import handler_for as j_handler_for
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import params_from_jax
from repro_torch.core import DEFAULT_EXCLUDE, LayerSpec, PruneConfig
from repro_torch.core import greedy_prune
from repro_torch.models import LM, vgg16
from repro_torch.roofline import attribution as attr
from repro_torch.roofline import hw
from repro_torch.sparse.registry import handler_for

CFG = dict(name="t", family="dense", num_layers=2, d_model=128, num_heads=4,
           num_kv_heads=2, head_dim=32, d_ff=256, vocab_size=512,
           param_dtype="float32")
TILE = {"tile_block_p": 64, "tile_group_q": 8, "tile_keep": 4}


def _rel_close(got, want, rtol=1e-12):
    assert abs(got - want) <= rtol * max(abs(want), 1e-300), (got, want)


# ------------------------------------------------------------------ hw

@pytest.mark.parametrize("flops,nbytes,coll", [
    (1e12, 1e9, 0.0), (1e9, 1e12, 1e6), (0.0, 0.0, 5e9), (3.0, 3.0, 3.0)])
def test_roofline_terms_keep_the_reference_formulas(flops, nbytes, coll):
    """Per-card terms are the work over the card's rates; the dominant
    term, the step time and the dict are the reference's for the same
    seconds; chips divide only when ``per_device`` is off."""
    t = hw.roofline_terms(flops, nbytes, coll)
    assert t.compute_s == flops / hw.PEAK_FLOPS_BF16
    assert t.memory_s == nbytes / hw.HBM_BW
    assert t.collective_s == coll / hw.NVLINK_BW
    ref = j_hw.RooflineTerms(t.compute_s, t.memory_s, t.collective_s)
    assert t.dominant == ref.dominant and t.step_s == ref.step_s
    assert t.as_dict() == ref.as_dict()
    four = hw.roofline_terms(flops, nbytes, coll, per_device=False, chips=4)
    assert four.compute_s == flops / (4 * hw.PEAK_FLOPS_BF16)
    assert hw.roofline_terms(flops, nbytes, coll, chips=4) == t
    fp32 = hw.roofline_terms(flops, nbytes, coll,
                             peak_flops=hw.PEAK_FLOPS_FP32)
    assert fp32.compute_s == flops / 67e12


def test_h100_constants_and_model_flops():
    assert (hw.PEAK_FLOPS_BF16, hw.PEAK_FLOPS_FP32, hw.HBM_BW) == (
        989e12, 67e12, 3.35e12)
    assert hw.NVLINK_BW == 450e9
    for n, d in ((1_543_714_304, 4096), (7, 3), (0, 10)):
        assert hw.model_flops_train(n, d) == j_hw.model_flops_train(n, d)
        assert hw.model_flops_infer(n, d) == j_hw.model_flops_infer(n, d)


# ----------------------------------------------------------- cost model

def _leaf_pair(scheme, shape, seed, **spec_kw):
    """The same seeded numpy weight packed by both registries."""
    w = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    jspec = JLayerSpec(scheme=scheme, **spec_kw)
    tspec = LayerSpec(scheme=scheme, **spec_kw)
    jpt = j_handler_for(scheme).pack(jspec.project(jnp.asarray(w)), jspec)
    tpt = handler_for(scheme).pack(tspec.project(torch.from_numpy(w)), tspec)
    return jpt, tpt


LEAVES = {
    "tile": ("tile_pattern", (256, 128), dict(tile_block_p=64,
                                              tile_group_q=8, tile_keep=4)),
    "column": ("column", (192, 96), dict(alpha=0.5)),
    "pattern_conv": ("pattern_shared", (32, 16, 3, 3), dict(alpha=0.25)),
}


@pytest.mark.parametrize("which", sorted(LEAVES))
@pytest.mark.parametrize("m", [1, 8, 32, 512])
def test_model_packed_costs_equal_reference(which, m):
    scheme, shape, kw = LEAVES[which]
    jpt, tpt = _leaf_pair(scheme, shape, 5, **kw)
    assert tpt.packed_bytes() == jpt.packed_bytes()
    want = j_attr.model_packed_costs(jpt, m)
    got = attr.model_packed_costs(tpt, m)
    assert (got.flops, got.bytes) == (want.flops, want.bytes)
    assert got.collective_total == 0.0
    half = attr.model_packed_costs(tpt, m, itemsize=2)
    acts = m * (tpt.shape[-2] + tpt.shape[-1])
    assert half.flops == got.flops and half.bytes == got.bytes - 2 * acts


# ------------------------------------------------------------- the join

def _artifacts():
    """The reference test's reduced tile artifact in both packages."""
    jcfg = JModelConfig(**CFG)
    jparams = j_build_model(jcfg).init(jax.random.PRNGKey(0))
    jpcfg = JPruneConfig(scheme="tile_pattern",
                         exclude=tuple(J_DEFAULT_EXCLUDE),
                         overrides={".*": TILE})
    jart = j_greedy_prune(jparams, jpcfg).to_artifact(arch="t").pack()
    cfg = ModelConfig(**CFG)
    LM(cfg, device="cpu")
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    pcfg = PruneConfig(scheme="tile_pattern", exclude=tuple(DEFAULT_EXCLUDE),
                       overrides={".*": TILE})
    art = greedy_prune(params, pcfg, device="cpu").pack(device="cpu")
    return jart, art


@pytest.fixture(scope="module")
def artifacts():
    return _artifacts()


def _keys(rows):
    return sorted((r["kind"], r["scheme"], r["bucket"], r["plan"],
                   r["events"], r["samples"]) for r in rows)


@pytest.mark.parametrize("ms,samples,warmup", [((8,), 2, 1),
                                               ((8, 256), 3, 2)])
def test_profile_keys_and_samples_equal_reference(artifacts, ms, samples,
                                                  warmup):
    jart, art = artifacts
    want = j_attr.profile_packed_tree(jart.packed, ms=ms, samples=samples,
                                      warmup=warmup, interpret=True)
    got = attr.profile_packed_tree(art.packed, ms=ms, samples=samples,
                                   warmup=warmup, device="cpu")
    assert _keys(got) == _keys(want) and got
    for r in got:
        assert r["measured_ns"] > 0
    # one leaf per reference path: layer 0 of each stacked GEMM
    paths = [p for p, _ in attr.packed_leaves(art.packed)]
    assert paths == sorted(set(paths), key=paths.index)
    assert all(not p.startswith("blocks/1/") for p in paths)


def test_profile_wants_the_card_by_default(artifacts):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError):
        attr.profile_packed_tree(artifacts[1].packed, ms=(8,))


@pytest.mark.parametrize("itemsize", [4, 2])
def test_attribute_rows_equal_reference(artifacts, itemsize):
    """The reference's rows on its own profile, the port's on the same
    rows: equal within 1e-12 relative (itemsize 4); at itemsize 2 the
    port models half the activation bytes."""
    jart, art = artifacts
    rows = j_attr.profile_packed_tree(jart.packed, ms=(8, 64), samples=2,
                                      warmup=1, interpret=True)
    rows = rows + [{"kind": "prefill", "scheme": "engine:chunked",
                    "bucket": 512, "plan": "-", "samples": 3,
                    "measured_ns": 1.5e6, "bytes_per_call": 1e6}]
    kw = dict(threshold=0.05, peak_flops=j_hw.PEAK_FLOPS_BF16,
              hbm_bw=j_hw.HBM_BW)
    want = j_attr.attribute(rows, jart.packed, **kw)
    got = attr.attribute(rows, art.packed, itemsize=itemsize, **kw)
    assert [sorted(r) for r in got] == [sorted(r) for r in want]
    modeled = ("modeled_ns", "achieved_fraction", "model_bytes",
               "arithmetic_intensity", "flagged", "bound")
    for g, w in zip(got, want):
        for k, v in w.items():
            if itemsize == 2 and k in modeled:
                continue
            if isinstance(v, float):
                _rel_close(g[k], v)
            else:
                assert g[k] == v, k
        if itemsize == 2 and w["modeled_ns"] is not None:
            assert g["model_bytes"] < w["model_bytes"]
    if itemsize == 4:
        assert attr.render_report(got) == j_attr.render_report(want)
        assert "roofline" in attr.render_report(got)


def test_attribute_on_the_card_constants(artifacts, tmp_path):
    """Defaults are the H100's; every modeled row has a fraction > 0 and a
    bound; the report round-trips through ``write_report`` /
    ``read_report`` as the reference's does."""
    _, art = artifacts
    rows = attr.profile_packed_tree(art.packed, ms=(8,), samples=2,
                                    warmup=1, device="cpu")
    report = attr.attribute(rows, art.packed)
    assert report
    for r in report:
        assert r["modeled_ns"] is not None and r["achieved_fraction"] > 0
        assert r["bound"] in ("memory", "compute")
    path = str(tmp_path / "attribution.json")
    attr.write_report(path, report, extra_field=7)
    doc = attr.read_report(path)
    assert doc["schema"] == 1 and doc["extra_field"] == 7
    assert doc["rows"] == report


def test_profile_conv_tree_on_its_channels():
    """A VGG-16 tree's packed convs are dispatched on NHWC images with
    each conv's own input channels, one image of side ceil(sqrt(M))."""
    model = vgg16(10, width_mult=0.125, image_hwc=(16, 16, 3), device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    art = greedy_prune(params, PruneConfig(scheme="pattern_shared",
                                           alpha=0.25), device="cpu")
    packed = art.pack(device="cpu").packed
    rows = attr.profile_packed_tree(packed, ms=(16, 64), samples=1,
                                    warmup=1, device="cpu")
    leaves = attr.packed_leaves(packed)
    assert {(r["kind"], r["scheme"], r["bucket"]) for r in rows} == {
        ("conv", "pattern", 32), ("conv", "pattern", 64)}
    # per M: every leaf dispatched twice, the first wall of the key dropped
    assert sum(r["samples"] for r in rows) == 2 * (len(leaves) * 2 - 1)
    report = attr.attribute(rows, packed, itemsize=2)
    assert all(r["achieved_fraction"] > 0 for r in report)


def test_hw_module_states_no_tpu_number():
    src = open(hw.__file__).read()
    for tpu in ("197e12", "819e9", "ICI", "TPU", "v5e"):
        assert tpu not in src
    assert "H100" in hw.__doc__ and dataclasses.is_dataclass(
        hw.RooflineTerms)
