"""The port's ADMM engine and privacy-preserving pruner against the JAX
reference (``repro.core.admm`` / ``pruner`` / ``lm_adapter``).

Both packages get the same weights (the reference's init, handed over as
numpy through ``repro_torch.convert``; the port's init for the CNNs) and
the same inputs (numpy, from a seed). Synthetic batches cannot match
across the two PRNGs, so each pruner run uses an adapter subclass, in each package, whose
``synthetic_batch`` returns the same numpy batches in turn. Models: the
reduced qwen2-1.5b at 2 layers in fp32, VGG-16 and ResNet-18 at width
0.125 on 16 x 16 images.

Tolerances: fp32 ``rtol = 2e-5`` with ``atol = 2e-5 * max|reference|``
for losses, activations and weights (Uniform[0, 255]-scale pixels make
the CNN losses large). Masks, the rho history and the provenance are
exact.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as j_reduced_config
from repro.core import LMAdapter as JLMAdapter
from repro.core import PrivacyPreservingPruner as JPruner
from repro.core import PruneConfig as JPruneConfig
from repro.core import admm as jadmm
from repro.core import schemes as jschemes
from repro.models import build_model
from repro.models.cnn import resnet18 as j_resnet18
from repro.models.cnn import vgg16 as j_vgg16
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import params_from_jax, tree_to_jax
from repro_torch.core import LMAdapter, PrivacyPreservingPruner, PruneConfig
from repro_torch.core import admm, as_key, build_specs, project_tree
from repro_torch.models import LM, resnet18, vgg16

RTOL = 2e-5
HWC = (16, 16, 3)
BATCH = 3
SEQ = 16


def _close(got, want, what=""):
    want = np.asarray(want, dtype=np.float64)
    got = np.asarray(got, dtype=np.float64)
    atol = RTOL * max(float(np.abs(want).max(initial=0.0)), 1e-30)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=atol, err_msg=what)


def _flat(tree, prefix=""):
    """(path, numpy) of a nested dict/list/tuple tree, None leaves kept."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flat(tree[k], f"{prefix}/{k}")
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += _flat(v, f"{prefix}/{i}")
        return out
    if tree is None:
        return [(prefix, None)]
    if isinstance(tree, torch.Tensor):
        return [(prefix, tree.detach().to(torch.float32).numpy())]
    return [(prefix, np.asarray(tree, dtype=np.float32))]


def _assert_trees_close(port, ref, what):
    fp, fr = _flat(port), _flat(ref)
    assert [p for p, _ in fp] == [p for p, _ in fr], what
    for (path, a), (_, b) in zip(fp, fr):
        if b is None:
            assert a is None, f"{what}{path}"
        else:
            _close(a, b, f"{what}{path}")


def _assert_trees_equal(port, ref, what):
    fp, fr = _flat(port), _flat(ref)
    assert [p for p, _ in fp] == [p for p, _ in fr], what
    for (path, a), (_, b) in zip(fp, fr):
        assert (a is None) == (b is None), f"{what}{path}"
        if b is not None:
            np.testing.assert_array_equal(a, b, err_msg=f"{what}{path}")


# ---------------------------------------------------------------- models


@functools.lru_cache(maxsize=None)
def _lm_pair():
    jcfg = j_reduced_config("qwen2-1.5b")
    jmodel = build_model(jcfg)
    np_params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    attn = np_params["blocks"]["attn"]
    for name in ("bq", "bk", "bv"):        # nonzero biases: init zeros them
        attn[name] = (rng.standard_normal(attn[name].shape) * 0.1).astype(
            np.float32)
    tcfg = ModelConfig(**dataclasses.asdict(jcfg))
    tmodel = LM(tcfg, device="cpu")
    return jmodel, tmodel, np_params, tcfg


@functools.lru_cache(maxsize=None)
def _cnn_pair(name):
    j_ctor, t_ctor = {"vgg16": (j_vgg16, vgg16),
                      "resnet18": (j_resnet18, resnet18)}[name]
    jmodel = j_ctor(num_classes=10, width_mult=0.125, image_hwc=HWC)
    tmodel = t_ctor(num_classes=10, width_mult=0.125, image_hwc=HWC,
                    device="cpu")
    # the port's init (the reference's op-by-op init is slow on the CPU)
    np_params = jax.tree.map(lambda t: t.numpy(), tmodel.init(
        torch.Generator().manual_seed(0)))
    rng = np.random.default_rng(1)
    for lp in np_params["layers"]:          # nonzero biases: init zeros them
        lp["bias"] = (rng.standard_normal(lp["bias"].shape) * 0.1).astype(
            np.float32)
    return jmodel, tmodel, np_params, None


@pytest.fixture(scope="module")
def lm():
    return _lm_pair()


@pytest.fixture(scope="module", params=["vgg16", "resnet18"])
def cnn(request):
    return (request.param,) + _cnn_pair(request.param)


def _batches(kind, n, seed=3):
    rng = np.random.default_rng(seed)
    if kind == "lm":
        return [rng.integers(0, 512, (BATCH, SEQ)).astype(np.int32)
                for _ in range(n)]
    return [(rng.integers(0, 256, (BATCH, *HWC)) / 255.0).astype(np.float32)
            for _ in range(n)]


class _Fed:
    """Mixin: ``synthetic_batch`` hands out ``self.fed`` in turn."""

    def synthetic_batch(self, key, batch_size):
        x = self.fed.pop(0)
        assert x.shape[0] == batch_size
        return self.wrap(x)


def _adapters(kind, jmodel, tmodel, batches):
    """(reference adapter, port adapter), each fed the same batches."""
    if kind == "lm":
        jbase, tbase = JLMAdapter, LMAdapter
        jargs, targs = (jmodel,), (tmodel,)
        jkw = tkw = {"seq_len": SEQ}
    else:
        jbase, tbase = type(jmodel), type(tmodel)
        jargs, targs, jkw, tkw = (), (), None, None
    J = type("J", (_Fed, jbase), {"wrap": staticmethod(jnp.asarray)})
    T = type("T", (_Fed, tbase), {"wrap": staticmethod(
        lambda x: torch.from_numpy(np.asarray(x)).long()
        if x.dtype.kind == "i" else torch.from_numpy(x))})
    if kind == "lm":
        ja, ta = J(*jargs, **jkw), T(*targs, **tkw)
    else:                 # the CNNs: the same dataclass fields, retyped
        ja = J(**{f.name: getattr(jmodel, f.name)
                  for f in dataclasses.fields(jmodel)})
        ta = T(**{f.name: getattr(tmodel, f.name)
                  for f in dataclasses.fields(tmodel)})
    ja.fed, ta.fed = list(batches), list(batches)
    return ja, ta


# ----------------------------------------------------------- admm engine


def _np_tree(seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {"w": f(32, 64), "conv": {"w": f(16, 8, 3, 3)}, "bias": f(64)}


def _both(np_tree):
    return (jax.tree.map(jnp.asarray, np_tree),
            {k: (torch.from_numpy(v.copy()) if not isinstance(v, dict)
                 else {kk: torch.from_numpy(vv.copy())
                       for kk, vv in v.items()})
             for k, v in np_tree.items()})


SPEC_CFG = dict(scheme="column", alpha=0.5,
                overrides={r".*conv.*": {"scheme": "pattern_shared"}},
                exclude=(r".*bias.*",))


def test_admm_steps_match_reference():
    jw, tw = _both(_np_tree(0))
    ju, tu = _both(_np_tree(1))
    jspecs = jschemes.build_specs(jw, JPruneConfig(**SPEC_CFG))
    tspecs = build_specs(tw, PruneConfig(**SPEC_CFG))
    jav = jadmm.ADMMVars(z=jadmm.admm_init(jw).z, u=ju)
    tav = admm.ADMMVars(z=admm.admm_init(tw).z, u=tu)
    _assert_trees_close(tav.z, jav.z, "init z")
    _assert_trees_equal(admm.admm_init(tw).u, jadmm.admm_init(jw).u, "u0")
    for specs in ((None, None), (tspecs, jspecs)):
        _close(float(admm.augmented_penalty(tw, tav, 0.3, specs[0])),
               float(jadmm.augmented_penalty(jw, jav, 0.3, specs[1])))
    jp = jadmm.proximal_step(lambda t: jschemes.project_tree(t, jspecs),
                             jw, jav)
    tp = admm.proximal_step(lambda t: project_tree(t, tspecs), tw, tav)
    _assert_trees_close(tp.z, jp.z, "proximal z")
    _assert_trees_equal(jax.tree.map(lambda x: x != 0, tp.z),
                        jax.tree.map(lambda x: np.asarray(x) != 0, jp.z),
                        "proximal support")
    jd, td = jadmm.dual_step(jw, jp), admm.dual_step(tw, tp)
    _assert_trees_close(td.u, jd.u, "dual u")
    _close(float(admm.primal_residual(tw, td)),
           float(jadmm.primal_residual(jw, jd)))
    _close(float(admm.dual_residual(td.z, tav.z, 0.7)),
           float(jadmm.dual_residual(jd.z, jav.z, 0.7)))


@pytest.mark.parametrize("gain", [1.0, 1e3], ids=["unclipped", "clipped"])
def test_primal_step_matches_reference(gain):
    """One SGD step of loss + penalty, with and without the global-norm
    clip taking effect."""
    jw, tw = _both(_np_tree(2))
    rng = np.random.default_rng(4)
    x = rng.standard_normal((5, 32)).astype(np.float32)
    y = rng.standard_normal((5, 64)).astype(np.float32)

    def jloss(p, b):
        return gain * jnp.mean(jnp.square(b[0] @ p["w"] + p["bias"] - b[1]))

    def tloss(p, b):
        return gain * ((b[0] @ p["w"] + p["bias"] - b[1]).square().mean())

    jav, tav = jadmm.admm_init(jw), admm.admm_init(tw)
    jnew, jl = jadmm.primal_step(jloss, jw, jav, (x, y), lr=1e-2, rho=0.1)
    tnew, tl = admm.primal_step(tloss, tw, tav, (torch.from_numpy(x),
                                                 torch.from_numpy(y)),
                                lr=1e-2, rho=0.1)
    _close(float(tl), float(jl))
    _assert_trees_close(tnew, jnew, "primal")


def _layer_case(kind, jmodel, tmodel, np_params, cfg, n):
    """Inputs of layer n's update: the teacher's input to it and output
    of it, and student params perturbed away from the teacher's."""
    tparams = params_from_jax(np_params, cfg, "cpu")
    jparams = jax.tree.map(jnp.asarray, np_params)
    batch = _batches(kind, 1)[0]
    if kind == "lm":
        jad, tad = JLMAdapter(jmodel, seq_len=SEQ), LMAdapter(tmodel,
                                                              seq_len=SEQ)
        tb = torch.from_numpy(batch).long()
    else:
        jad, tad, tb = jmodel, tmodel, torch.from_numpy(batch)
    jx, tx = jad.embed(jparams, jnp.asarray(batch)), tad.embed(tparams, tb)
    for m in range(n):
        jx = jad.apply_layer(m, jad.layer_params(jparams, m), jx)
        tx = tad.apply_layer(m, tad.layer_params(tparams, m), tx)
    jt = jad.apply_layer(n, jad.layer_params(jparams, n), jx)
    with torch.no_grad():
        tt = tad.apply_layer(n, tad.layer_params(tparams, n), tx)
    _assert_trees_close(tt, jt, f"teacher layer {n}")
    rng = np.random.default_rng(5)
    lp_np = jax.tree.map(lambda a: a * (1 + 0.05 * rng.standard_normal(
        a.shape)).astype(np.float32), jax.tree.map(
            np.asarray, jad.layer_params(jparams, n)))
    return jad, tad, jx, tx, jt, tt, lp_np


def _check_layer_update(kind, pair, scheme_cfg, n):
    jmodel, tmodel, np_params, cfg = pair
    jad, tad, jx, tx, jt, tt, lp_np = _layer_case(kind, jmodel, tmodel,
                                                  np_params, cfg, n)
    jcfg, tcfg = JPruneConfig(**scheme_cfg), PruneConfig(**scheme_cfg)
    jlp = jax.tree.map(jnp.asarray, lp_np)
    tlp = params_from_jax(lp_np, None, "cpu")
    jspecs, tspecs = jschemes.build_specs(jlp, jcfg), build_specs(tlp, tcfg)
    # start from one proximal + dual step, so the penalty is not zero
    jav = jadmm.dual_step(jlp, jadmm.proximal_step(
        lambda t: jschemes.project_tree(t, jspecs), jlp,
        jadmm.admm_init(jlp)))
    tav = admm.dual_step(tlp, admm.proximal_step(
        lambda t: project_tree(t, tspecs), tlp, admm.admm_init(tlp)))
    jup = JPruner(jad, jcfg)._make_layer_update(n, jspecs)
    jlp2, jav2, jloss = jup(jlp, jav, jx, jt, jnp.float32(1e-3),
                            jnp.float32(1e-2))
    tlp2, tav2, tloss = PrivacyPreservingPruner(tad, tcfg).layer_update(
        n, tspecs, tlp, tav, tx, tt, 1e-3, 1e-2)
    _close(float(tloss), float(jloss), "layer loss")
    _assert_trees_close(tlp2, jlp2, "layer params")
    _assert_trees_close(tav2.z, jav2.z, "layer z")
    _assert_trees_close(tav2.u, jav2.u, "layer u")
    _assert_trees_equal(jax.tree.map(lambda z: z != 0, tav2.z),
                        jax.tree.map(lambda z: np.asarray(z) != 0, jav2.z),
                        "layer support")


def test_admm_iteration_through_lm_layer(lm):
    _check_layer_update("lm", lm, dict(
        scheme="tile_pattern", overrides={".*": {"tile_block_p": 32}}), 1)


def test_admm_iteration_through_cnn_layer(cnn):
    name, *pair = cnn
    # VGG: a conv followed by a pool; ResNet: a block's second conv, with
    # its residual and 1x1 projection
    n = 7 if name == "vgg16" else 6
    _check_layer_update(name, pair, dict(scheme="pattern_shared",
                                         alpha=0.25), n)


# -------------------------------------------------------------- pruners


PRUNE = dict(iterations=2, batch_size=BATCH, lr=1e-3, rho_init=1e-3,
             rho_every_iters=1, rho_max=1e-1)
CASES = {
    "lm-tile_pattern": ("lm", dict(scheme="tile_pattern", overrides={
        ".*": {"tile_block_p": 32}})),
    "lm-column": ("lm", dict(scheme="column", alpha=0.5)),
    "vgg16-pattern_shared": ("vgg16", dict(scheme="pattern_shared",
                                           alpha=0.25)),
}


def _pair_for(kind):
    return _lm_pair() if kind == "lm" else _cnn_pair(kind)


def _run_both(kind, scheme_cfg, formulation):
    jmodel, tmodel, np_params, cfg = _pair_for(kind)
    ja, ta = _adapters("lm" if kind == "lm" else "cnn", jmodel, tmodel,
                       _batches(kind, PRUNE["iterations"]))
    jcfg = JPruneConfig(**scheme_cfg, **PRUNE)
    tcfg = PruneConfig(**scheme_cfg, **PRUNE)
    jp, tp = JPruner(ja, jcfg), PrivacyPreservingPruner(ta, tcfg)
    jres = getattr(jp, formulation)(jax.random.PRNGKey(1), jax.tree.map(
        jnp.asarray, np_params))
    tres = getattr(tp, formulation)(as_key(1),
                                    params_from_jax(np_params, cfg, "cpu"))
    assert not ja.fed and not ta.fed
    return jres, tres, cfg


def _check_results(jres, tres, cfg):
    stacked = cfg is not None
    conv = tree_to_jax if stacked else (lambda t: t)
    assert tres.history["rho"] == jres.history["rho"]
    for k in ("loss", "residual", "dual_residual"):
        _close(tres.history[k], jres.history[k], k)
    _assert_trees_equal(conv(tres.masks), jax.tree.map(
        lambda m: np.asarray(m, np.float32), jres.masks), "masks")
    _assert_trees_close(conv(tres.params), jres.params, "pruned params")
    assert tres.provenance == jres.provenance


@pytest.mark.parametrize("case", sorted(CASES))
def test_run_layerwise_matches_reference(case):
    kind, scheme_cfg = CASES[case]
    _check_results(*_run_both(kind, scheme_cfg, "run_layerwise"))


@pytest.mark.parametrize("case", ["lm-tile_pattern", "vgg16-pattern_shared"])
def test_run_whole_model_matches_reference(case):
    kind, scheme_cfg = CASES[case]
    _check_results(*_run_both(kind, scheme_cfg, "run_whole_model"))


def test_lm_adapter_apply_matches_reference(lm):
    jmodel, tmodel, np_params, cfg = lm
    batch = _batches("lm", 1)[0]
    jl = JLMAdapter(jmodel, seq_len=SEQ).apply(
        jax.tree.map(jnp.asarray, np_params), jnp.asarray(batch))
    tl = LMAdapter(tmodel, seq_len=SEQ).apply(
        params_from_jax(np_params, cfg, "cpu"), torch.from_numpy(batch).long())
    _close(tl.detach().numpy(), np.asarray(jl), "logits")


# ---------------------------------------------------- ADMM-dagger baseline


def _mlp_np(seed=0):
    rng = np.random.default_rng(seed)
    return {"l1": {"w": (rng.standard_normal((12, 32)) / 3).astype(
        np.float32), "bias": np.zeros(32, np.float32)},
        "l2": {"w": (rng.standard_normal((32, 5)) / 6).astype(np.float32)}}


def _mlp_data(it):
    rng = np.random.default_rng(100 + it)
    return (rng.standard_normal((8, 12)).astype(np.float32),
            rng.integers(0, 5, (8,)).astype(np.int32))


def test_admm_task_prune_matches_reference(tmp_path):
    """The task-loss baseline on a 2-layer MLP with step-indexed data; its
    provenance says it saw real data; it resumes like the pruner."""
    from repro.core import admm_task_prune as j_task
    from repro_torch.core import admm_task_prune

    cfg = dict(scheme="irregular", alpha=0.5, iterations=3, lr=0.05,
               rho_init=1e-2, rho_every_iters=1)

    def japply(p, x):
        return jax.nn.relu(x @ p["l1"]["w"] + p["l1"]["bias"]) @ p["l2"]["w"]

    def tapply(p, x):
        return torch.relu(x @ p["l1"]["w"] + p["l1"]["bias"]) @ p["l2"]["w"]

    def tdata(it):
        x, y = _mlp_data(it)
        return torch.from_numpy(x), torch.from_numpy(y).long()

    jres = j_task(jax.random.PRNGKey(0), jax.tree.map(jnp.asarray, _mlp_np()),
                  japply, lambda it: jax.tree.map(jnp.asarray, _mlp_data(it)),
                  JPruneConfig(**cfg))
    tparams = jax.tree.map(torch.from_numpy, _mlp_np())
    tres = admm_task_prune(as_key(0), tparams, tapply, tdata,
                           PruneConfig(**cfg))
    assert tres.history["rho"] == jres.history["rho"]
    for k in ("loss", "residual", "dual_residual"):
        _close(tres.history[k], jres.history[k], k)
    _assert_trees_equal(tres.masks, jax.tree.map(
        lambda m: np.asarray(m, np.float32), jres.masks), "masks")
    _assert_trees_close(tres.params, jres.params, "params")
    assert tres.provenance == jres.provenance == {
        "data": "real", "method": "admm_traditional"}

    class Stop(Exception):
        pass

    def stop(it, metrics):
        if it == 0:
            raise Stop

    d = str(tmp_path / "task")
    with pytest.raises(Stop):
        admm_task_prune(as_key(0), tparams, tapply, tdata, PruneConfig(**cfg),
                        checkpoint_dir=d, save_every=1, callback=stop)
    resumed = admm_task_prune(as_key(0), tparams, tapply, tdata,
                              PruneConfig(**cfg), checkpoint_dir=d,
                              save_every=1, resume=True)
    assert resumed.history == tres.history
    with pytest.raises(ValueError):
        admm_task_prune(as_key(0), tparams, tapply, iter([tdata(0)]),
                        PruneConfig(**cfg), checkpoint_dir=d)
