"""The port's training loop (``repro_torch/launch/train.py``) and int8
gradient compression (``repro_torch/optim/grad_compression.py``) against
the reference's, on the CPU:

* ``compress_int8`` gives the reference's int8 codes bit for bit and its
  scale on the same fp32 arrays (ties round half to even);
  ``error_feedback_compress`` scales a tree per reference leaf, the layers
  of a ``blocks`` list sharing the scale of the reference's stacked leaf;
* three steps of ``make_train_step(grad_compression=True)`` on the
  reduced qwen2 in fp32 (momentum, as ``tests/test_torch_privacy.py``
  steps): params within 2e-5 of the reference's and residuals within
  2e-5, except codes that land on the other side of a half-way tie from
  the reference's (the fp32 gradients differ in their last bits): each
  such residual is the reference's minus one quantization step, and they
  are rare;
* ``run_training``: a run stopped after a checkpoint and resumed ends
  bit-equal to one never stopped; masks survive training; ``mesh``
  raises; ``main`` prints the reference's line and restores the mask
  function ``launch/prune.py`` writes.
"""

import dataclasses
import functools
import io
import re
import sys
import tempfile
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jopt
from repro.configs import reduced_config as j_reduced_config
from repro.launch import train as j_train
from repro.models import build_model as j_build_model
from repro_torch import optim as topt
from repro_torch.configs import reduced_config
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.convert import params_from_jax, tree_to_jax
from repro_torch.core import PruneConfig, greedy_prune
from repro_torch.launch import train
from repro_torch.models import LM
from repro_torch.runtime import StepResult
from repro_torch.utils.tree import tree_items, tree_leaves

TOL = 2e-5


def _flat_np(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat_np(tree[k], f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix, tree


# ------------------------------------------------------------------ codec

def _arrays():
    rng = np.random.default_rng(0)
    ties = (np.arange(-300, 301) * 0.5).astype(np.float32)  # exact .5s
    return {
        "normal": rng.standard_normal((64, 33)).astype(np.float32),
        "tiny": (rng.standard_normal(100) * 1e-9).astype(np.float32),
        "ties": ties,
        "zeros": np.zeros(17, np.float32),
        "constant": np.full(9, -3.25, np.float32),
        "wide": (rng.standard_normal(1000) * 10.0 ** rng.integers(
            -6, 6, 1000)).astype(np.float32),
    }


@pytest.mark.parametrize("name", sorted(_arrays()))
def test_compress_int8_codes_bit_equal(name):
    a = _arrays()[name]
    jq, js = jopt.compress_int8(jnp.asarray(a))
    q, s = topt.compress_int8(torch.from_numpy(a))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(s) == float(js)
    np.testing.assert_array_equal(
        topt.decompress_int8(q, s).numpy(),
        np.asarray(jopt.decompress_int8(jq, js)))


def test_error_feedback_scales_per_reference_leaf():
    """A per-layer tree quantizes with the scale of the reference's stacked
    leaf: codes, scales and residuals equal the reference's over two
    steps of error feedback."""
    rng = np.random.default_rng(1)
    stacked = {"blocks": {"w": rng.standard_normal((3, 8, 5)).astype(
        np.float32)}, "head": rng.standard_normal((5, 4)).astype(np.float32)}
    layers = {"blocks": [{"w": torch.from_numpy(stacked["blocks"]["w"][l])}
                         for l in range(3)],
              "head": torch.from_numpy(stacked["head"])}
    jef = jopt.error_feedback_init(jax.tree.map(jnp.asarray, stacked))
    ef = topt.error_feedback_init(layers)
    for _ in range(2):
        jq, js, jef = jopt.error_feedback_compress(
            jax.tree.map(jnp.asarray, stacked), jef)
        q, s, ef = topt.error_feedback_compress(layers, ef)
        for l in range(3):
            np.testing.assert_array_equal(
                q["blocks"][l]["w"].numpy(), np.asarray(jq["blocks"]["w"][l]))
            assert float(s["blocks"][l]["w"]) == float(js["blocks"]["w"])
            np.testing.assert_allclose(
                ef.residual["blocks"][l]["w"].numpy(),
                np.asarray(jef.residual["blocks"]["w"][l]), rtol=0, atol=1e-6)
        np.testing.assert_array_equal(q["head"].numpy(),
                                      np.asarray(jq["head"]))


# ------------------------------------------------------- the train step

def _lm_pair():
    jcfg = j_reduced_config("qwen2-1.5b")
    jmodel = j_build_model(jcfg)
    np_params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    tmodel = LM(ModelConfig(**dataclasses.asdict(jcfg)), device="cpu")
    return jmodel, tmodel, np_params


def _tokens(seed, B=4, S=32):
    toks = np.random.default_rng(seed).integers(0, 512, (B, S + 1))
    return {"inputs": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32)}


def test_compressed_train_step_matches_reference():
    jmodel, tmodel, np_params = _lm_pair()
    jo, to = jopt.momentum(1e-2), topt.momentum(1e-2)
    jstep = jax.jit(j_train.make_train_step(jmodel, jo,
                                            grad_compression=True))
    jparams = jax.tree.map(jnp.asarray, np_params)
    jstate = {"params": jparams, "opt": jo.init(jparams),
              "step": jnp.zeros((), jnp.int32),
              "ef": jopt.error_feedback_init(jparams)}
    step = train.make_train_step(tmodel, to, grad_compression=True)
    params = params_from_jax(np_params, tmodel.config, "cpu")
    state = {"params": params, "opt": to.init(params),
             "step": torch.zeros((), dtype=torch.int32),
             "ef": topt.error_feedback_init(params)}
    for i in range(3):
        b = _tokens(10 + i)
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, b))
        state, m = step(state, {k: torch.from_numpy(v).long()
                                for k, v in b.items()})
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=TOL)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=TOL)
        assert 0.0 < float(m["ef_residual_ratio"]) <= 0.5 + 1e-5
    assert int(state["step"]) == 3

    want = dict(_flat_np(jax.tree.map(np.asarray, jstate["params"])))
    for path, w in tree_items(tree_to_jax(state["params"])):
        np.testing.assert_allclose(w.numpy(), want[path], rtol=0, atol=TOL,
                                   err_msg=path)
    want = dict(_flat_np(jax.tree.map(np.asarray, jstate["ef"].residual)))
    flips = total = 0
    for path, r in tree_items(tree_to_jax(state["ef"].residual)):
        r, rj = r.numpy().astype(np.float64), want[path].astype(np.float64)
        total += r.size
        off = np.abs(r - rj) > TOL
        flips += int(off.sum())
        # a flipped code: the reference's residual sits at +-half a step,
        # the port's at the other half, one step away
        step_ = np.abs(r - rj)[off]
        assert np.all(np.abs(r[off] + rj[off]) <= TOL), path
        assert np.all(np.abs(rj[off]) >= 0.49 * step_), path
    assert flips <= 1e-4 * total, (flips, total)


def test_init_state_and_global_norm():
    model = LM(reduced_config("qwen2-1.5b"), device="cpu")
    opt = topt.adamw(1e-3)
    plain = train.init_state(model, opt, torch.Generator().manual_seed(0))
    assert set(plain) == {"params", "opt", "step"}
    assert plain["step"].dtype == torch.int32 and int(plain["step"]) == 0
    st = train.init_state(model, opt, torch.Generator().manual_seed(0),
                          grad_compression=True)
    assert set(st) == {"params", "opt", "step", "ef"}
    for r, p in zip(tree_leaves(st["ef"].residual),
                    tree_leaves(st["params"])):
        assert r.dtype == torch.float32 and r.shape == p.shape
        assert not r.any()
    np_tree = jax.tree.map(np.asarray, tree_to_jax(
        {k: v for k, v in st["params"].items()}))
    want = j_train.global_norm(jax.tree.map(jnp.asarray, np_tree))
    got = train.global_norm(st["params"])
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# --------------------------------------------------------- run_training

def _tcfg(tmp_path, name, **kw):
    base = dict(steps=4, learning_rate=1e-3, warmup_steps=2,
                checkpoint_every=2, checkpoint_dir=str(tmp_path / name))
    base.update(kw)
    return TrainConfig(**base)


class _Stop(Exception):
    pass


@pytest.mark.parametrize("compression", [False, True])
def test_stopped_and_resumed_run_is_bit_equal(tmp_path, compression):
    """A run stopped once step 2 has committed, then resumed from that
    checkpoint, writes the uninterrupted run's step-4 state bit for bit
    (the resumed run goes ``steps`` past its checkpoint, as the
    reference's does)."""
    cfg = reduced_config("qwen2-1.5b")
    kw = dict(seq_len=16, global_batch=2, device="cpu")
    whole = train.run_training(
        cfg, _tcfg(tmp_path, "whole", grad_compression=compression), **kw)
    assert [r.step for r in whole["metrics"]] == [0, 1, 2, 3]
    assert all(isinstance(r, StepResult) for r in whole["metrics"])
    assert whole["straggler"]["samples"] == 4
    tcfg = _tcfg(tmp_path, "cut", grad_compression=compression)

    def stop_at(k):
        def hook(res):
            if res.step == k:
                raise _Stop
        return hook

    with pytest.raises(_Stop):       # step 2 committed, step 2 then stops
        train.run_training(cfg, tcfg, on_step=stop_at(2), **kw)
    assert train.CheckpointManager(tcfg.checkpoint_dir).latest_step() == 2
    with pytest.raises(_Stop):       # resumed at 2; step 4 committed
        train.run_training(cfg, tcfg, on_step=stop_at(4), **kw)
    resumed = train.CheckpointManager(tcfg.checkpoint_dir).restore(
        whole["state"], step=4)
    a = list(tree_items(whole["state"]))
    b = dict(tree_items(resumed))
    assert len(a) == len(b) and any(p.startswith("ef/") for p, _ in a) == (
        compression)
    for path, x in a:
        assert x.dtype == b[path].dtype and torch.equal(x, b[path]), path


def test_masks_survive_and_mesh_raises(tmp_path):
    cfg = reduced_config("qwen2-1.5b")
    model = LM(cfg, device="cpu")
    pcfg = PruneConfig(scheme="tile_pattern",
                       overrides={".*": {"tile_block_p": 32}})
    masks = greedy_prune(model.init(torch.Generator().manual_seed(0)), pcfg,
                         device="cpu").masks
    out = train.run_training(cfg, _tcfg(tmp_path, "m", steps=3), seq_len=16,
                             global_batch=2, masks=masks, device="cpu")
    losses = [r.metrics["loss"] for r in out["metrics"]]
    assert len(losses) == 3 and all(np.isfinite(losses))
    pruned = 0
    for (path, w), (_, m) in zip(tree_items(out["state"]["params"]),
                                 tree_items(masks)):
        if m is not None:
            assert not bool(w[m == 0].any()), path
            pruned += int((m == 0).sum())
    assert pruned > 0

    class CardMesh:                  # a mesh of cards for a run on the CPU
        device_type = "cuda"

    with pytest.raises(ValueError, match="mesh on 'cuda'"):
        train.run_training(cfg, _tcfg(tmp_path, "x"), seq_len=16,
                           global_batch=2, mesh=CardMesh(), device="cpu")


LINE = re.compile(r"^arch=(\S+) steps=(\d+) loss: first=(\d+\.\d{4}) "
                  r"last=(\d+\.\d{4})$")


def test_cli_prints_the_reference_line(tmp_path, monkeypatch):
    argv = ["--arch", "qwen2-1.5b", "--reduced", "--steps", "4", "--batch",
            "2", "--seq", "16"]
    buf = io.StringIO()
    monkeypatch.setattr(sys, "argv", ["train"] + argv + [
        "--ckpt-dir", str(tmp_path / "ref")])
    with redirect_stdout(buf):
        j_train.main()
    want = LINE.match(buf.getvalue().strip().splitlines()[-1])
    buf = io.StringIO()
    with redirect_stdout(buf):
        out = train.main(argv + ["--ckpt-dir", str(tmp_path / "port"),
                                 "--device", "cpu"])
    got = LINE.match(buf.getvalue().strip().splitlines()[-1])
    assert want and got and got.groups()[:2] == want.groups()[:2] == (
        "qwen2-1.5b", "4")
    assert float(got.group(3)) == pytest.approx(np.log(512), abs=0.5)
    assert len(out["metrics"]) == 4


def test_cli_restores_the_prune_launchers_masks(tmp_path):
    """``launch/prune.py`` writes the mask function; ``--masks`` restores
    it into the port's tree and retrains with it."""
    from repro_torch.launch import prune

    prune.main(["--arch", "qwen2-1.5b", "--reduced", "--scheme",
                "tile_pattern", "--rate", "2", "--iters", "1", "--batch",
                "2", "--seq", "8", "--tile-block", "32", "--out",
                str(tmp_path / "p"), "--device", "cpu"])
    out = train.main(["--arch", "qwen2-1.5b", "--reduced", "--steps", "2",
                      "--batch", "2", "--seq", "16", "--ckpt-dir",
                      str(tmp_path / "c"), "--masks", str(tmp_path / "p" /
                                                          "masks"),
                      "--device", "cpu"])
    masks = train.restore_masks(str(tmp_path / "p" / "masks"),
                                reduced_config("qwen2-1.5b"), "cpu")
    masks = dict(tree_items(masks))
    zeros = 0
    for path, w in tree_items(out["state"]["params"]):
        m = masks[path]
        assert m.shape == w.shape, path
        assert not bool(w[m == 0].any()), path
        zeros += int((m == 0).sum())
    assert zeros > 0


def test_cli_default_checkpoints_under_the_temporary_directory(
        tmp_path, monkeypatch):
    """Without ``--ckpt-dir`` the CLI checkpoints under the temporary
    directory (``TMPDIR``), in a directory of its own arch, never in the
    reference's fixed one; a second run there resumes from it."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    monkeypatch.setattr(train, "TrainConfig", functools.partial(
        TrainConfig, checkpoint_every=1))
    argv = ["--arch", "qwen2-1.5b", "--reduced", "--steps", "2", "--batch",
            "2", "--seq", "16", "--device", "cpu"]
    with redirect_stdout(io.StringIO()):
        first = train.main(argv)
        again = train.main(argv)
    where = tmp_path / "repro_torch_ckpt" / "qwen2-1.5b-reduced"
    assert where.is_dir() and any(where.iterdir())
    assert [m.step for m in first["metrics"]] == [0, 1]
    assert [m.step for m in again["metrics"]] == [2, 3]
