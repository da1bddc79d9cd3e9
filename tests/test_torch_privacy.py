"""The port's privacy evaluation (``repro_torch.privacy``, the
``LMAdapter.per_example_loss`` hook and ``launch.train.make_train_step``)
against the JAX reference.

Tolerances:

* the attack math (``mia``: ranks, AUC, thresholds, bootstrap CIs, the
  logistic attack, both attacks) is the reference's float64 numpy code,
  so it must be bit-equal on the same inputs;
* ``posterior_features`` / ``sequence_features`` from the same fp32
  logits: float64 on the tensor's device against the reference's numpy,
  within 1e-12 absolute (summation order only);
* ``per_example_loss`` and two ``make_train_step`` steps (with and without
  masks) on the reduced qwen2-1.5b in fp32: ``rtol = 2e-5`` with ``atol
  = 2e-5 * max|reference|``; masked weights exactly 0. The steps use SGD
  with momentum: AdamW turns a gradient that is zero up to rounding (the
  key bias's, a shift shared by a whole softmax row) into a full +-lr
  step whose sign is the rounding noise of each package;
* ``three_way`` on VGG-16 (width 0.125, 16 x 16) and on the reduced
  qwen2-1.5b, both packages fed the same numpy batches and initial
  weights: member / non-member losses
  within 1e-4 relative (plus 1e-4 absolute, the rows' rounding unit);
  attack AUC and accuracy within 1 / min(n_member, n_nonmember), one
  example's rank; ``prune_data`` and ``comp_rate`` equal.
"""

import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jopt
from repro.configs import reduced_config as j_reduced_config
from repro.core import LMAdapter as JLMAdapter
from repro.launch.train import make_train_step as j_make_train_step
from repro.models import build_model
from repro.models.cnn import vgg16 as j_vgg16
from repro.privacy import mia as jmia
from repro.privacy import report as jreport
from repro.sparse.artifact import PrunedArtifact as JPrunedArtifact
from repro_torch import optim as topt
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import params_from_jax, tree_to_jax
from repro_torch.core import LMAdapter, PruneConfig, greedy_prune
from repro_torch.launch.train import make_train_step
from repro_torch.models import LM, vgg16
from repro_torch.privacy import mia as tmia
from repro_torch.privacy import report as treport
from repro_torch.sparse import PrunedArtifact
from repro_torch.utils.tree import (
    reference_path,
    tree_items,
    tree_map_with_path,
)

RTOL = 2e-5


def _close(got, want, what="", rtol=RTOL):
    want = np.asarray(want, dtype=np.float64)
    got = np.asarray(got, dtype=np.float64)
    atol = rtol * max(float(np.abs(want).max(initial=0.0)), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=what)


# --------------------------------------------------------- attack math


def _scores(seed=0, n_m=37, n_n=41):
    rng = np.random.default_rng(seed)
    m = rng.standard_normal(n_m) + 0.4
    n = rng.standard_normal(n_n)
    m[:5] = n[:5]                       # ties across the pools
    return m, n


def _feats(seed=1, n=40, shift=0.3):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, 4)) + shift


MIA_CASES = {
    "average_ranks": lambda mod: mod._average_ranks(
        np.concatenate(_scores())),
    "auc": lambda mod: mod.auc(*_scores()),
    "auc_empty": lambda mod: mod.auc([], _scores()[1]),
    "best_threshold": lambda mod: mod.best_threshold(*_scores()),
    "threshold_accuracy": lambda mod: mod.threshold_accuracy(
        *_scores(), 0.2),
    "bootstrap_ci": lambda mod: mod.bootstrap_ci(
        mod.auc, *_scores(), n_boot=50, seed=3),
    "confidence_attack": lambda mod: mod.confidence_attack(
        _feats(1), _feats(2, shift=0.0), feature=2, n_boot=30,
        seed=4).as_dict(),
    "fit_logistic": lambda mod: dataclasses.astuple(mod.fit_logistic(
        np.concatenate([_feats(1), _feats(2, shift=0.0)]),
        np.r_[np.ones(40), np.zeros(40)], steps=100)),
    "shadow_attack": lambda mod: mod.shadow_attack(
        _feats(1), _feats(2, shift=0.0), _feats(3), _feats(4, shift=0.0),
        n_boot=30, seed=5).as_dict(),
    "shadow_model_attack": lambda mod: mod.shadow_model_attack(
        _feats(1), _feats(2, shift=0.0),
        shadow_features=lambda i: (_feats(10 + i), _feats(20 + i, shift=0.0)),
        num_shadows=2, n_boot=30, seed=6).as_dict(),
}


def _assert_bit_equal(a, b, path="result"):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_bit_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_bit_equal(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif isinstance(a, float) and np.isnan(a):
        assert np.isnan(b), path
    else:
        assert a == b and type(a) is type(b), path


@pytest.mark.parametrize("case", sorted(MIA_CASES))
def test_attack_math_bit_equal_to_reference(case):
    _assert_bit_equal(MIA_CASES[case](tmia), MIA_CASES[case](jmia))


def test_feature_names_match_reference():
    assert tmia.FEATURE_NAMES == jmia.FEATURE_NAMES


def test_posterior_and_sequence_features_match_reference():
    rng = np.random.default_rng(7)
    logits = (rng.standard_normal((3, 5, 512)) * 6).astype(np.float32)
    labels = rng.integers(0, 512, (3, 5))
    got = tmia.sequence_features(torch.from_numpy(logits),
                                 torch.from_numpy(labels))
    want = jmia.sequence_features(jnp.asarray(logits), labels)
    assert got.dtype == np.float64 and got.shape == (3, 4)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    flat = tmia.posterior_features(torch.from_numpy(logits[0]),
                                   torch.from_numpy(labels[0]))
    np.testing.assert_allclose(flat, jmia.posterior_features(
        logits[0], labels[0]), rtol=0, atol=1e-12)
    # bf16 logits convert exactly to float64 in both packages
    bf = torch.from_numpy(logits[1]).to(torch.bfloat16)
    np.testing.assert_allclose(
        tmia.posterior_features(bf, torch.from_numpy(labels[1])),
        jmia.posterior_features(jnp.asarray(logits[1]).astype(jnp.bfloat16),
                                labels[1]), rtol=0, atol=1e-12)


# ------------------------------------------------- LM hooks and training


@functools.lru_cache(maxsize=None)
def _lm_pair():
    jcfg = j_reduced_config("qwen2-1.5b")
    jmodel = build_model(jcfg)
    np_params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    tmodel = LM(ModelConfig(**dataclasses.asdict(jcfg)), device="cpu")
    return jmodel, tmodel, np_params


def _tokens(seed, B=3, S=16):
    toks = np.random.default_rng(seed).integers(0, 512, (B, S + 1))
    return {"inputs": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32)}


def _t_batch(b):
    return {k: torch.from_numpy(v).long() for k, v in b.items()}


def test_per_example_loss_matches_reference():
    jmodel, tmodel, np_params = _lm_pair()
    b = _tokens(11)
    want = JLMAdapter(jmodel, seq_len=16).per_example_loss(
        jax.tree.map(jnp.asarray, np_params), jnp.asarray(b["inputs"]),
        jnp.asarray(b["labels"]))
    got = LMAdapter(tmodel, seq_len=16).per_example_loss(
        params_from_jax(np_params, tmodel.config, "cpu"),
        *_t_batch(b).values())
    assert got.shape == (3,) and got.dtype == torch.float32
    _close(got.detach().numpy(), want, "per_example_loss")


def _np_masks(np_params, seed=5):
    """{0, 1} masks for every block GEMM weight, None elsewhere (the
    reference's layout)."""
    rng = np.random.default_rng(seed)

    def mask(path, w):
        if path.startswith("blocks/") and path.split("/")[-1].startswith(
                "w"):
            return (rng.random(w.shape) < 0.5).astype(np.float32)
        return None

    return {k: (mask(k, v) if not isinstance(v, dict) else
                {kk: (mask(f"{k}/{kk}", vv) if not isinstance(vv, dict)
                      else {n: mask(f"{k}/{kk}/{n}", x)
                            for n, x in vv.items()})
                 for kk, vv in v.items()})
            for k, v in np_params.items()}


@pytest.mark.parametrize("masked", [False, True])
def test_make_train_step_matches_reference(masked):
    jmodel, tmodel, np_params = _lm_pair()
    np_masks = _np_masks(np_params) if masked else None
    batches = [_tokens(20), _tokens(21)]

    jstep = jax.jit(j_make_train_step(
        jmodel, jopt.momentum(0.5),
        masks=(jax.tree.map(jnp.asarray, np_masks) if masked else None)))
    jparams = jax.tree.map(jnp.asarray, np_params)
    jstate = {"params": jparams, "opt": jopt.momentum(0.5).init(jparams),
              "step": jnp.zeros((), jnp.int32)}
    jlosses = []
    for b in batches:
        jstate, m = jstep(jstate, jax.tree.map(jnp.asarray, b))
        jlosses.append(float(m["loss"]))

    tmasks = None
    if masked:
        flat = {p: m for p, m in _flat_np(np_masks)}
        tmasks = tree_map_with_path(
            lambda path, w: _layer_mask(flat, path), params_from_jax(
                np_params, tmodel.config, "cpu"))
    opt = topt.momentum(0.5)
    tparams = params_from_jax(np_params, tmodel.config, "cpu")
    step = make_train_step(tmodel, opt, masks=tmasks)
    state = {"params": tparams, "opt": opt.init(tparams), "step": 0}
    tlosses = []
    for b in batches:
        state, m = step(state, _t_batch(b))
        tlosses.append(float(m["loss"]))
    assert state["step"] == 2
    _close(tlosses, jlosses, "losses")
    want = dict(_flat_np(jax.tree.map(np.asarray, jstate["params"])))
    for path, w in tree_items(tree_to_jax(state["params"])):
        assert w.dtype == torch.float32, path
        _close(w.numpy(), want[path], path)
    if masked:
        for path, w in tree_items(state["params"]):
            m = _layer_mask(flat, path)
            if m is not None:
                assert bool((w[m == 0] == 0).all()), path


def _flat_np(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat_np(tree[k], f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix, tree


def _layer_mask(flat, path):
    m = flat.get(reference_path(path))
    if m is None:
        return None
    if path.startswith("blocks/"):
        m = m[int(path.split("/")[1])]
    return torch.from_numpy(np.ascontiguousarray(m)).to(torch.bfloat16)


# ------------------------------------------------- three-way, numpy-fed

HWC = (16, 16, 3)
TINY = dict(teacher_steps=2, prune_iters=2, retrain_steps=2, shadows=1,
            member_batches=1, cnn_batch=32, lm_batch=8, seq_len=16,
            n_boot=20)
# the LM's member pool: 2 batches of 8 sequences
LM_TINY = dict(TINY, member_batches=2)


def _images(seed, n):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (n, *HWC)) / 255.0).astype(np.float32)


def _labelled(step):
    """The client's image batch at ``step``: numpy images and labels, a
    pure function of the step (stands in for both packages' pipelines)."""
    x = _images(step % (2 ** 32), TINY["cnn_batch"])
    y = np.random.default_rng(step + 7).integers(0, 10, TINY["cnn_batch"])
    return x, y.astype(np.int32)


def _token_batch(step):
    """The client's token batch at ``step``, numpy."""
    toks = np.random.default_rng(step).integers(
        0, 512, (TINY["lm_batch"], TINY["seq_len"] + 1)).astype(np.int32)
    return toks[:, :-1], toks[:, 1:]


@functools.lru_cache(maxsize=None)
def _vgg_init_np(seed):
    """Initial VGG weights by seed, the port's init handed over as numpy
    with nonzero biases."""
    t = vgg16(10, width_mult=0.125, image_hwc=HWC, device="cpu")
    params = jax.tree.map(lambda a: a.numpy(), t.init(
        torch.Generator().manual_seed(seed)))
    rng = np.random.default_rng(seed + 1)
    for lp in params["layers"]:
        lp["bias"] = (rng.standard_normal(lp["bias"].shape) * 0.1).astype(
            np.float32)
    return params


@functools.lru_cache(maxsize=None)
def _lm_init_np(seed):
    """Initial reduced-LM weights by seed, the reference's init as numpy."""
    jmodel = build_model(j_reduced_config("qwen2-1.5b"))
    return jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(seed)))


def _key_seed(key):
    return int(jax.random.key_data(key)[-1])


class _Pipe:
    """Both pipelines' ``batch_at``, numpy-fed; ``wrap`` makes the
    package's arrays."""

    def __init__(self, *a, **k):
        pass


class _JPipe(_Pipe):
    def batch_at(self, step):
        x, y = _labelled(step)
        return jnp.asarray(x), jnp.asarray(y)


class _TPipe(_Pipe):
    def batch_at(self, step):
        x, y = _labelled(step)
        return torch.from_numpy(x), torch.from_numpy(y).long()


class _JTokPipe(_Pipe):
    def batch_at(self, step):
        x, y = _token_batch(step)
        return {"inputs": jnp.asarray(x), "labels": jnp.asarray(y)}


class _TTokPipe(_Pipe):
    def batch_at(self, step):
        x, y = _token_batch(step)
        return {"inputs": torch.from_numpy(x).long(),
                "labels": torch.from_numpy(y).long()}


class _Fed:
    """Mixin: synthetic batches handed out in turn, the same numpy in both
    packages (images for a CNN, tokens for the LM adapter)."""

    drawn = 0

    def synthetic_batch(self, key, batch_size):
        self.drawn += 1
        if hasattr(self, "image_hwc"):
            return self.wrap(_images(10_000 + self.drawn, batch_size)
                             * 255.0)
        return self.wrap(np.random.default_rng(20_000 + self.drawn).integers(
            0, 512, (batch_size, self.seq_len)).astype(np.int32))


def _fed_vgg(pkg):
    if pkg == "port":
        model = vgg16(10, width_mult=0.125, image_hwc=HWC, device="cpu")
        cls = type("T", (_Fed, type(model)), {
            "wrap": staticmethod(torch.from_numpy),
            "init": lambda self, gen: params_from_jax(
                _vgg_init_np(gen.initial_seed()), None, "cpu")})
    else:
        model = j_vgg16(10, width_mult=0.125, image_hwc=HWC)
        cls = type("J", (_Fed, type(model)), {
            "wrap": staticmethod(jnp.asarray),
            "init": lambda self, key: jax.tree.map(
                jnp.asarray, _vgg_init_np(_key_seed(key)))})
    return cls(**{f.name: getattr(model, f.name)
                  for f in dataclasses.fields(model)})


def _patch_cnn(mod, pkg, monkeypatch):
    model = _fed_vgg(pkg)
    monkeypatch.setattr(mod, "vgg16", lambda *a, **k: model)
    monkeypatch.setattr(mod, "ClassificationPipeline",
                        _TPipe if pkg == "port" else _JPipe)
    return [model]


def _patch_lm(mod, pkg, monkeypatch):
    """The report module's LM, adapter and token pipeline, numpy-fed; the
    adapters it builds are collected in the returned list."""
    made = []
    if pkg == "port":
        model_cls = type("TL", (LM,), {
            "init": lambda self, gen: params_from_jax(
                _lm_init_np(gen.initial_seed()), self.config, "cpu")})
        adapter_cls = type("TA", (_Fed, LMAdapter), {
            "wrap": staticmethod(lambda x: torch.from_numpy(x).long())})
        monkeypatch.setattr(mod, "LM", model_cls)
        monkeypatch.setattr(mod, "TokenPipeline", _TTokPipe)
    else:
        model_cls = type("JL", (type(build_model(j_reduced_config(
            "qwen2-1.5b"))),), {
            "init": lambda self, key: jax.tree.map(
                jnp.asarray, _lm_init_np(_key_seed(key)))})
        adapter_cls = type("JA", (_Fed, JLMAdapter), {
            "wrap": staticmethod(jnp.asarray)})
        monkeypatch.setattr(mod, "build_model", model_cls)
        monkeypatch.setattr(mod, "TokenPipeline", _JTokPipe)

    def adapter(*a, **k):
        made.append(adapter_cls(*a, **k))
        return made[-1]

    monkeypatch.setattr(mod, "LMAdapter", adapter)
    return made


def _three_way(mod, pkg, arch, monkeypatch):
    cnn = arch == "vgg16"
    fed = (_patch_cnn if cnn else _patch_lm)(mod, pkg, monkeypatch)
    cfg = mod.ReportConfig.for_mode(True, **(TINY if cnn else LM_TINY))
    kw = {"device": "cpu"} if pkg == "port" else {}
    rows = mod.three_way(mod.make_ops(arch, cfg, **kw), cfg)
    # one synthetic batch per ADMM iteration, from the one fed model
    assert [f.drawn for f in fed] == [cfg.prune_iters]
    return rows


@pytest.mark.parametrize("arch", ["vgg16", "qwen2-1.5b"])
def test_three_way_matches_reference(arch, monkeypatch):
    trows = _three_way(treport, "port", arch, monkeypatch)
    jrows = _three_way(jreport, "reference", arch, monkeypatch)
    assert [r["method"] for r in trows] == list(treport.METHODS)
    for t, j in zip(trows, jrows):
        assert t.keys() == j.keys()
        what = t["method"]
        for k in ("model", "arch", "method", "prune_data", "comp_rate",
                  "n_member", "n_nonmember", "shadows", "quick"):
            assert t[k] == j[k], (what, k)
        np.testing.assert_allclose(
            [t["member_loss"], t["nonmember_loss"]],
            [j["member_loss"], j["nonmember_loss"]], rtol=1e-4, atol=1e-4,
            err_msg=what)
        one_rank = 1.0 / min(t["n_member"], t["n_nonmember"])
        for k in ("mia_auc", "mia_acc", "mia_auc_shadow", "mia_acc_shadow"):
            assert abs(t[k] - j[k]) <= one_rank + 1e-9, (what, k, t[k], j[k])
    assert trows[2]["prune_data"] == "synthetic"
    assert trows[1]["prune_data"] == "real" and trows[0]["comp_rate"] == 1.0


# ------------------------------------------------- the manifest's block


def test_with_params_and_with_privacy_round_trip(tmp_path):
    """``with_privacy`` merges into the manifest's block and ``with_params``
    drops the packing, as the reference's do; the block survives a save
    by either package and a load by the other."""
    model = vgg16(10, width_mult=0.125, image_hwc=HWC, device="cpu")
    art = greedy_prune(model.init(torch.Generator().manual_seed(0)),
                       PruneConfig(scheme="pattern_shared", alpha=0.25),
                       device="cpu").pack(device="cpu")
    stamped = art.with_privacy(mia={"attack_auc": 0.5}).with_privacy(
        retrained_on="client_confidential")
    assert stamped.privacy == {**art.privacy, "mia": {"attack_auc": 0.5},
                               "retrained_on": "client_confidential"}
    assert art.privacy["data"] == "none" and "mia" not in art.privacy
    doubled = stamped.with_params(
        {**stamped.params, "head": {k: v * 2 for k, v in
                                    stamped.params["head"].items()}})
    assert doubled.packed is None and stamped.packed is not None
    assert doubled.privacy == stamped.privacy
    doubled.pack(device="cpu").save(str(tmp_path / "port"))
    jart = JPrunedArtifact.load(str(tmp_path / "port"))
    assert jart.privacy == stamped.privacy
    assert jart.with_params(jart.params).packed is None
    jart.with_privacy(mia={"attack_auc": 0.6}).save(str(tmp_path / "ref"))
    back = PrunedArtifact.load(str(tmp_path / "ref"), device="cpu")
    assert back.privacy == {**stamped.privacy, "mia": {"attack_auc": 0.6}}
    assert torch.equal(back.params["head"]["w"],
                       stamped.params["head"]["w"] * 2)


# ------------------------------------------------------------ the bench


def test_write_bench_merges_by_model_and_method(tmp_path):
    path = str(tmp_path / "sub" / "bench.json")

    def row(model, method, auc):
        return {"model": model, "method": method, "mia_auc": auc}

    assert treport.write_bench([row("lm", "admm_synthetic", 0.6),
                                row("lm", "dense", 0.5)], path) == path
    treport.write_bench([row("cnn", "admm_real", 0.7),
                         row("lm", "dense", 0.55)], path)
    got = json.load(open(path))
    assert [(r["model"], r["method"], r["mia_auc"]) for r in got] == [
        ("cnn", "admm_real", 0.7), ("lm", "dense", 0.55),
        ("lm", "admm_synthetic", 0.6)]
    # the reference merges the same rows into the same file
    jpath = str(tmp_path / "ref.json")
    jreport.write_bench([row("lm", "admm_synthetic", 0.6),
                         row("lm", "dense", 0.5)], jpath)
    jreport.write_bench([row("cnn", "admm_real", 0.7),
                         row("lm", "dense", 0.55)], jpath)
    assert json.load(open(jpath)) == got
    # a corrupt file is replaced, not merged
    with open(path, "w") as f:
        f.write("{not json")
    treport.write_bench([row("cnn", "dense", 0.5)], path)
    assert json.load(open(path)) == [row("cnn", "dense", 0.5)]
    assert os.path.basename(treport.BENCH_PATH) != os.path.basename(
        jreport.BENCH_PATH)


def test_report_config_matches_reference():
    for quick in (False, True):
        t = dataclasses.asdict(treport.ReportConfig.for_mode(quick, rate=2))
        j = dataclasses.asdict(jreport.ReportConfig.for_mode(quick, rate=2))
        assert t == j
    assert (treport._NONMEMBER_BASE, treport._SHADOW_STRIDE,
            treport._SHADOW_HOLDOUT) == (jreport._NONMEMBER_BASE,
                                         jreport._SHADOW_STRIDE,
                                         jreport._SHADOW_HOLDOUT)
