"""Masked retraining, the task losses and the client's data pipelines:
the port against the JAX reference and against its own contract.

``make_retrain_step`` takes the same steps as the reference's on the
same pattern_shared-pruned VGG-16 (width 0.125, 16 x 16, handed over as
numpy), the same masks and the same batches; ``cross_entropy`` /
``per_example_cross_entropy`` and the LM's ``train_loss`` (and its
gradient) agree with the reference's (fp32, ``rtol = 2e-5``, ``atol =
2e-5 * max|reference|``). Masked weights stay exactly zero through
``retrain``; the pipelines are pure in (seed, step).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jopt
from repro.configs import reduced_config as j_reduced_config
from repro.core import admm_traditional as jat
from repro.core import retrain as jretrain
from repro.models import build_model
from repro.models.cnn import vgg16 as j_vgg16
from repro.utils.tree import tree_paths
from repro_torch import optim as topt
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import params_from_jax
from repro_torch.core import (
    PruneConfig,
    cross_entropy,
    greedy_prune,
    make_retrain_step,
    per_example_cross_entropy,
    retrain,
)
from repro_torch.data import ClassificationPipeline, DataConfig, TokenPipeline
from repro_torch.models import LM, vgg16
from repro_torch.utils.tree import tree_items

RTOL = 2e-5
HWC = (16, 16, 3)


def _close(got, want, what=""):
    want = np.asarray(want, dtype=np.float64)
    got = np.asarray(got, dtype=np.float64)
    atol = RTOL * max(float(np.abs(want).max(initial=0.0)), 1e-30)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=atol, err_msg=what)


def test_cross_entropy_matches_reference():
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((3, 5, 11)) * 4).astype(np.float32)
    labels = rng.integers(0, 11, (3, 5)).astype(np.int32)
    tl, tlab = torch.from_numpy(logits), torch.from_numpy(labels).long()
    _close(per_example_cross_entropy(tl, tlab).numpy(),
           jat.per_example_cross_entropy(jnp.asarray(logits),
                                         jnp.asarray(labels)))
    _close(float(cross_entropy(tl, tlab)),
           float(jat.cross_entropy(jnp.asarray(logits), jnp.asarray(labels))))
    _close(float(cross_entropy(tl.bfloat16(), tlab)), float(
        jat.cross_entropy(jnp.asarray(logits).astype(jnp.bfloat16),
                          jnp.asarray(labels))))


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_np_tree(v) for v in tree]
    return None if tree is None else tree.to(torch.float32).numpy()


def _port_tree(tree):
    if isinstance(tree, dict):
        return {k: _port_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_port_tree(v) for v in tree]
    return None if tree is None else torch.from_numpy(tree.copy())


@pytest.fixture(scope="module")
def pruned_vgg():
    """(reference model, port model, pruned numpy params, numpy masks),
    pruned by the port (bit-equal to the reference's prune,
    ``test_torch_cnn.py``)."""
    jmodel = j_vgg16(num_classes=10, width_mult=0.125, image_hwc=HWC)
    tmodel = vgg16(num_classes=10, width_mult=0.125, image_hwc=HWC,
                   device="cpu")
    params = tmodel.init(torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    for lp in params["layers"]:       # nonzero biases: init zeros them
        lp["bias"] = torch.randn(lp["bias"].shape, generator=g) * 0.1
    art = greedy_prune(params, PruneConfig(scheme="pattern_shared",
                                           alpha=0.25), device="cpu")
    return jmodel, tmodel, _np_tree(art.params), _np_tree(art.masks)


def _batch(seed):
    rng = np.random.default_rng(seed)
    x = (rng.integers(0, 256, (4, *HWC)) / 255.0).astype(np.float32)
    return x, rng.integers(0, 10, (4,)).astype(np.int32)


@pytest.mark.parametrize("opt", ["sgd", "adamw"])
def test_retrain_step_matches_reference(pruned_vgg, opt):
    jmodel, tmodel, params, masks = pruned_vgg
    make = {"sgd": lambda m: m.sgd(0.05),
            "adamw": lambda m: m.adamw(1e-3, weight_decay=0.01)}[opt]
    jmasks = jax.tree.map(jnp.asarray, masks)   # None leaves stay None
    tmasks = _port_tree(masks)
    jo, to = make(jopt), make(topt)
    jstep = jretrain.make_retrain_step(jmodel.apply, jat.cross_entropy, jo,
                                       jmasks)
    tstep = make_retrain_step(tmodel.apply, cross_entropy, to, tmasks)
    jp = jax.tree.map(jnp.asarray, params)
    tp = params_from_jax(params, None, "cpu")
    js, ts = jo.init(jp), to.init(tp)
    for step in range(2):
        x, y = _batch(step)
        jp, js, jl = jstep(jp, js, (jnp.asarray(x), jnp.asarray(y)))
        tp, ts, tl = tstep(tp, ts, (torch.from_numpy(x),
                                    torch.from_numpy(y).long()))
        _close(float(tl), float(jl), f"loss {step}")
    port = dict(tree_items(tp))
    assert sorted(port) == sorted(tree_paths(jp))
    for path, b in zip(tree_paths(jp), jax.tree.leaves(jp)):
        _close(port[path].numpy(), b, path)
    for (path, w), (_, m) in zip(tree_items(tp), tree_items(tmasks)):
        if m is not None:
            assert bool((w[m == 0] == 0).all()), path


def test_retrain_keeps_pruned_weights_zero(pruned_vgg):
    _, tmodel, params, masks = pruned_vgg
    tmasks = _port_tree(masks)
    data = ClassificationPipeline(DataConfig(global_batch=8, image_hwc=HWC),
                                  device="cpu")
    out, hist = retrain(params_from_jax(params, None, "cpu"), tmasks,
                        tmodel.apply, cross_entropy, topt.adamw(1e-2),
                        iter(data), steps=4,
                        eval_fn=lambda p: float(cross_entropy(
                            tmodel.apply(p, data.eval_batch()[0]),
                            data.eval_batch()[1])), eval_every=2)
    assert len(hist["loss"]) == 4 and len(hist["eval"]) == 2
    assert all(np.isfinite(hist["loss"]))
    moved = 0
    for (path, w), (_, m), (_, w0) in zip(
            tree_items(out), tree_items(tmasks),
            tree_items(params_from_jax(params, None, "cpu"))):
        if m is not None:
            assert bool((w[m == 0] == 0).all()), path
        moved += int(not torch.equal(w, w0))
    assert moved == len(list(tree_items(out)))


def test_lm_train_loss_and_grad_match_reference():
    jcfg = j_reduced_config("qwen2-1.5b")
    jmodel = build_model(jcfg)
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    tmodel = LM(ModelConfig(**dataclasses.asdict(jcfg)), device="cpu")
    rng = np.random.default_rng(2)
    toks = rng.integers(0, 512, (2, 17)).astype(np.int32)
    batch = {"inputs": toks[:, :-1], "labels": toks[:, 1:]}
    jl, jg = jax.value_and_grad(jmodel.train_loss)(
        jax.tree.map(jnp.asarray, params),
        jax.tree.map(jnp.asarray, batch))
    tp = params_from_jax(params, tmodel.config, "cpu")
    paths = [p for p, _ in tree_items(tp)]
    leaves = [w.requires_grad_(True) for _, w in tree_items(tp)]
    tl = tmodel.train_loss(tp, {k: torch.from_numpy(v).long()
                                for k, v in batch.items()})
    grads = dict(zip(paths, torch.autograd.grad(tl, leaves)))
    _close(float(tl.detach()), float(jl), "loss")
    want = params_from_jax(jax.tree.map(np.asarray, jg), tmodel.config,
                           "cpu")
    for path, g in tree_items(want):
        _close(grads[path].numpy(), g.numpy(), path)


def test_pipelines_are_pure_in_seed_and_step():
    lm = TokenPipeline(DataConfig(seq_len=12, global_batch=3, vocab_size=97),
                       device="cpu")
    a, b = lm.batch_at(5), lm.batch_at(5)
    assert torch.equal(a["inputs"], b["inputs"])
    assert not torch.equal(a["inputs"], lm.batch_at(6)["inputs"])
    toks = torch.cat([a["inputs"], a["labels"][:, -1:]], dim=1)
    assert torch.equal(a["labels"][:, :-1], a["inputs"][:, 1:])
    noise = (toks[:, 1:] - toks[:, :-1] * 31 - 7) % 97
    assert bool((noise < max(97 // 64, 2)).all())    # the Markov structure
    first = next(iter(lm))
    assert torch.equal(first["inputs"], lm.batch_at(0)["inputs"])
    cfg = DataConfig(global_batch=5, num_classes=3, image_hwc=(4, 4, 1),
                     seed=9)
    c1 = ClassificationPipeline(cfg, device="cpu")
    c2 = ClassificationPipeline(cfg, device="cpu")
    assert torch.equal(c1.prototypes, c2.prototypes)
    x, y = c1.batch_at(3)
    assert torch.equal(x, c2.batch_at(3)[0]) and torch.equal(
        y, c2.batch_at(3)[1])
    assert x.shape == (5, 4, 4, 1) and bool((x >= 0).all() & (x <= 1).all())
    assert int(y.max()) < 3
    assert not torch.equal(x, c1.batch_at(4)[0])
