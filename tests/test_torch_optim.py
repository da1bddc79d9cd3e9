"""The port's optimizers and schedules (``repro_torch.optim``) against the
JAX reference's (``repro.optim``): the same numpy params and gradients
through 3 steps of each optimizer give the same updates and states
(fp32, ``rtol = 2e-5``, ``atol = 2e-5 * max|reference|``); steps and
masked positions are exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jopt
from repro_torch import optim as topt

RTOL = 2e-5


def _close(got, want, what=""):
    want = np.asarray(want, dtype=np.float64)
    got = np.asarray(got, dtype=np.float64)
    atol = RTOL * max(float(np.abs(want).max(initial=0.0)), 1e-30)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=atol, err_msg=what)


def _np(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((6, 5)).astype(np.float32),
            "layers": [{"k": rng.standard_normal((3, 2, 3, 3)).astype(
                np.float32)}, {"b": rng.standard_normal((4,)).astype(
                    np.float32)}]}


def _t(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _leaves_close(port, ref, what):
    pl = jax.tree.leaves(jax.tree.map(lambda x: x.numpy(), port))
    rl = jax.tree.leaves(ref)
    assert len(pl) == len(rl), what
    for a, b in zip(pl, rl):
        _close(a, b, what)


SCHEDULES = {
    "constant": (lambda m: 0.05),
    "cosine": (lambda m: m.cosine_decay(0.1, 5)),
    "warmup_cosine": (lambda m: m.warmup_cosine(0.1, 2, 6)),
}
OPTIMIZERS = {
    "sgd": lambda m, lr: m.sgd(lr),
    "momentum": lambda m, lr: m.momentum(lr, beta=0.8),
    "nesterov": lambda m, lr: m.momentum(lr, nesterov=True),
    "adamw": lambda m, lr: m.adamw(lr),
    "adamw_wd": lambda m, lr: m.adamw(lr, b2=0.99, weight_decay=0.1),
}


@pytest.mark.parametrize("sched", sorted(SCHEDULES))
@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_matches_reference_over_3_steps(name, sched):
    jo = OPTIMIZERS[name](jopt, SCHEDULES[sched](jopt))
    to = OPTIMIZERS[name](topt, SCHEDULES[sched](topt))
    params = _np(0)
    jp, tp = _j(params), _t(params)
    js, ts = jo.init(jp), to.init(tp)
    for step in range(3):
        grads = _np(10 + step)
        ju, js = jo.update(_j(grads), js, jp)
        tu, ts = to.update(_t(grads), ts, tp)
        _leaves_close(tu, ju, f"{name}/{sched} updates, step {step}")
        jp = jax.tree.map(lambda p, u: p + u, jp, ju)
        tp = jax.tree.map(lambda p, u: p + u, tp, tu)
        assert int(ts.step) == int(js.step) == step + 1
    for field in ts._fields:
        if field != "step":
            _leaves_close(getattr(ts, field), getattr(js, field), field)
    _leaves_close(tp, jp, f"{name}/{sched} params")


def test_schedules_match_reference():
    for sched in ("cosine", "warmup_cosine"):
        js, ts = SCHEDULES[sched](jopt), SCHEDULES[sched](topt)
        for step in range(9):
            _close(float(ts(torch.tensor(step, dtype=torch.int32))),
                   float(js(jnp.int32(step))), f"{sched} {step}")
    assert float(topt.constant(0.3)(torch.tensor(0))) == float(
        jopt.constant(0.3)(jnp.int32(0)))
    for kw in ({}, dict(rho_init=1e-3, every_iters=3, mult=2.0)):
        tr, jr = topt.paper_rho_schedule(**kw), jopt.paper_rho_schedule(**kw)
        assert [tr(i) for i in range(0, 500, 7)] + [tr(10 ** 9)] == \
            [jr(i) for i in range(0, 500, 7)] + [jr(10 ** 9)]


def test_masked_optimizer_matches_reference_and_keeps_zeros():
    params = _np(0)
    rng = np.random.default_rng(3)
    masks = jax.tree.map(lambda a: (rng.random(a.shape) > 0.5).astype(
        np.float32), params)
    masks["layers"][1]["b"] = None                 # a free (unpruned) leaf
    jo = jopt.masked(jopt.adamw(0.05, weight_decay=0.1), _j(masks))
    tmasks = jax.tree.map(lambda m: torch.from_numpy(m), masks)
    to = topt.masked(topt.adamw(0.05, weight_decay=0.1), tmasks)
    jp, tp = _j(params), _t(params)
    js, ts = jo.init(jp), to.init(tp)
    for step in range(3):
        grads = _np(20 + step)
        ju, js = jo.update(_j(grads), js, jp)
        tu, ts = to.update(_t(grads), ts, tp)
        _leaves_close(tu, ju, f"masked updates, step {step}")
        for u, m in ((tu["w"], tmasks["w"]),
                     (tu["layers"][0]["k"], tmasks["layers"][0]["k"])):
            assert bool((u[m == 0] == 0).all())
