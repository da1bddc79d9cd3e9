"""The embedding-input side of the port's data-free pruning and client
pipeline, against the reference.

- ``synthetic_embeddings`` is N(0, 1) in shape and moments, as
  ``tests/test_synthetic.py`` holds the reference's; ``synthetic_batch_for``
  dispatches on 'image' | 'tokens' | 'embeddings' and refuses the rest;
- ``LMAdapter.synthetic_kind`` and ``synthetic_batch`` follow the input
  kind (uniform token ids, or N(0, 1) embeddings at d_model);
- ``EmbeddingPipeline`` is pure in (seed, step) with the reference's shapes
  and dtypes; ``make_pipeline_for`` dispatches as the reference's;
- ``make_train_step`` on an embedding batch (reduced pixtral-12b, fp32):
  two masked steps match the reference's, losses and weights within
  ``rtol = 2e-5`` (``atol = 2e-5 * max|reference|``), masked weights 0;
- ``launch.pipeline --arch pixtral-12b --reduced --quick`` fails where the
  reference's fails, at the ``teacher`` stage (the client's LM pipeline
  feeds token ids to a model that takes embeddings), and nowhere else.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jopt
from repro.configs import reduced_config as j_reduced_config
from repro.core import DEFAULT_EXCLUDE as J_EXCLUDE
from repro.core import PruneConfig as JPruneConfig
from repro.core import greedy_prune as j_greedy_prune
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import make_pipeline_for as j_make_pipeline_for
from repro.launch import pipeline as j_pipeline
from repro.launch.train import make_train_step as j_make_train_step
from repro.models import build_model as j_build_model
from repro.runtime.fault_tolerance import StageError as JStageError
from repro.utils.tree import tree_paths
from repro_torch import optim as topt
from repro_torch.configs import reduced_config
from repro_torch.convert import params_from_jax, tree_to_jax
from repro_torch.core import DEFAULT_EXCLUDE, LMAdapter, PruneConfig
from repro_torch.core import greedy_prune
from repro_torch.core.synthetic import synthetic_batch_for
from repro_torch.core.synthetic import synthetic_embeddings
from repro_torch.data import (
    ClassificationPipeline,
    DataConfig,
    EmbeddingPipeline,
    TokenPipeline,
    make_pipeline_for,
)
from repro_torch.launch import pipeline
from repro_torch.launch.train import make_train_step
from repro_torch.models import build_model
from repro_torch.privacy import report
from repro_torch.runtime import StageError
from repro_torch.utils.tree import tree_items

RTOL = 2e-5


def _gen(seed=42):
    return torch.Generator().manual_seed(seed)


# ------------------------------------------------------------ the generators

def test_embeddings_are_standard_normal():
    x = synthetic_embeddings(_gen(), 16, 8, 64, device="cpu")
    assert x.shape == (16, 8, 64) and x.dtype == torch.float32
    assert abs(float(x.mean())) < 0.05
    assert abs(float(x.std()) - 1.0) < 0.05
    again = synthetic_embeddings(_gen(), 16, 8, 64, device="cpu")
    assert torch.equal(x, again)
    assert not torch.equal(x, synthetic_embeddings(_gen(43), 16, 8, 64,
                                                   device="cpu"))


@pytest.mark.parametrize("kind,kw,shape", [
    ("image", dict(batch=2, hwc=(8, 8, 3)), (2, 8, 8, 3)),
    ("tokens", dict(batch=2, seq_len=16, vocab_size=101), (2, 16)),
    ("embeddings", dict(batch=2, seq_len=4, dim=32), (2, 4, 32)),
])
def test_batch_for_dispatches(kind, kw, shape):
    x = synthetic_batch_for(kind, _gen(), device="cpu", **kw)
    assert tuple(x.shape) == shape
    assert x.is_floating_point() == (kind != "tokens")


def test_batch_for_refuses_an_unknown_kind():
    with pytest.raises(ValueError, match="unknown synthetic"):
        synthetic_batch_for("audio_waveform", _gen(), batch=1)


@pytest.mark.parametrize("arch,kind", [("qwen2-1.5b", "uniform_tokens"),
                                       ("pixtral-12b", "normal_embeddings"),
                                       ("hubert-xlarge",
                                        "normal_embeddings")])
def test_adapter_synthetic_kind_and_batch(arch, kind):
    from repro.core import LMAdapter as JLMAdapter

    cfg = reduced_config(arch)
    adapter = LMAdapter(build_model(cfg, device="cpu"), seq_len=12)
    jadapter = JLMAdapter(j_build_model(j_reduced_config(arch)), seq_len=12)
    assert adapter.synthetic_kind == jadapter.synthetic_kind == kind
    batch = adapter.synthetic_batch(_gen(), 3)
    want = jadapter.synthetic_batch(jax.random.PRNGKey(0), 3)
    assert tuple(batch.shape) == tuple(want.shape)
    assert batch.is_floating_point() == (kind == "normal_embeddings")


# ------------------------------------------------------------- the pipelines

def test_embedding_pipeline_shapes_dtypes_and_determinism():
    kw = dict(seq_len=12, global_batch=3, vocab_size=97, d_model=16,
              seed=9)
    pipe = EmbeddingPipeline(DataConfig(**kw), device="cpu")
    want = j_make_pipeline_for("embeddings", JDataConfig(
        kind="embeddings", **kw)).batch_at(4)
    got = pipe.batch_at(4)
    for key in ("inputs", "labels"):
        assert tuple(got[key].shape) == tuple(want[key].shape)
        assert str(got[key].dtype).split(".")[-1] == str(want[key].dtype)
    assert bool((got["labels"] >= 0).all() & (got["labels"] < 97).all())
    again = EmbeddingPipeline(DataConfig(**kw), device="cpu").batch_at(4)
    assert all(torch.equal(got[k], again[k]) for k in got)
    assert not torch.equal(got["inputs"], pipe.batch_at(5)["inputs"])
    first = next(iter(pipe))
    assert torch.equal(first["inputs"], pipe.batch_at(0)["inputs"])


@pytest.mark.parametrize("kind,cls", [("lm", TokenPipeline),
                                      ("embeddings", EmbeddingPipeline),
                                      ("classification",
                                       ClassificationPipeline)])
def test_make_pipeline_for(kind, cls):
    assert type(j_make_pipeline_for(kind, JDataConfig())).__name__ == \
        cls.__name__
    assert isinstance(make_pipeline_for(kind, DataConfig(), device="cpu"),
                      cls)


def test_make_pipeline_for_refuses_an_unknown_kind():
    with pytest.raises(ValueError, match="unknown pipeline kind"):
        make_pipeline_for("video", DataConfig(), device="cpu")
    with pytest.raises(ValueError, match="unknown pipeline kind"):
        j_make_pipeline_for("video", JDataConfig())


# ------------------------------------------------------------ the train step

def _close(got, want, what):
    want = np.asarray(want, dtype=np.float64)
    atol = RTOL * max(float(np.abs(want).max(initial=0.0)), 1e-30)
    np.testing.assert_allclose(np.asarray(got, dtype=np.float64), want,
                               rtol=RTOL, atol=atol, err_msg=what)


def test_masked_train_step_on_embeddings_matches_reference():
    arch = "pixtral-12b"
    jmodel = j_build_model(j_reduced_config(arch))
    np_params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(2)))
    model = build_model(reduced_config(arch), device="cpu")
    tile = {".*": {"tile_block_p": 32}}
    jmasks = j_greedy_prune(jax.tree.map(jnp.asarray, np_params),
                            JPruneConfig(scheme="tile_pattern",
                                         exclude=tuple(J_EXCLUDE),
                                         overrides=tile)).masks
    masks = greedy_prune(params_from_jax(np_params, model.config, "cpu"),
                         PruneConfig(scheme="tile_pattern",
                                     exclude=DEFAULT_EXCLUDE,
                                     overrides=tile), device="cpu").masks
    rng = np.random.default_rng(3)
    batches = [{"inputs": rng.standard_normal((2, 16, 64), dtype=np.float32),
                "labels": rng.integers(0, 512, (2, 16)).astype(np.int32)}
               for _ in range(2)]

    jstep = jax.jit(j_make_train_step(jmodel, jopt.momentum(0.5),
                                      masks=jmasks))
    jparams = jax.tree.map(jnp.asarray, np_params)
    jstate = {"params": jparams, "opt": jopt.momentum(0.5).init(jparams),
              "step": jnp.zeros((), jnp.int32)}
    opt = topt.momentum(0.5)
    params = params_from_jax(np_params, model.config, "cpu")
    step = make_train_step(model, opt, masks=masks)
    state = {"params": params, "opt": opt.init(params), "step": 0}
    for b in batches:
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, b))
        state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        _close(float(m["loss"]), float(jm["loss"]), "loss")
    jflat = dict(zip(tree_paths(jstate["params"]),
                     jax.tree.leaves(jstate["params"])))
    for path, w in tree_items(tree_to_jax(state["params"])):
        _close(w.numpy(), np.asarray(jflat[path]), path)
    for path, m in tree_items(masks):
        if m is not None:
            w = dict(tree_items(state["params"]))[path]
            assert bool((w[m == 0] == 0).all()), path


# ------------------------------------------------------- the pipeline outcome

class _TinyConfig:
    @staticmethod
    def for_mode(quick, **overrides):
        return report.ReportConfig.for_mode(quick, **{
            **dict(teacher_steps=2, retrain_steps=2, shadows=1,
                   member_batches=1, lm_batch=4, seq_len=16), **overrides})


def test_pixtral_pipeline_fails_at_the_stage_the_reference_fails(
        tmp_path, monkeypatch):
    monkeypatch.setattr(pipeline, "ReportConfig", _TinyConfig)
    argv = ["--arch", "pixtral-12b", "--reduced", "--quick", "--iters", "2",
            "--stage-retries", "0"]
    with pytest.raises(JStageError) as jerr:
        j_pipeline.main(argv + ["--out", str(tmp_path / "ref"),
                                "--bench-path", str(tmp_path / "jb.json")])
    with pytest.raises(StageError) as err:
        pipeline.main(argv + ["--device", "cpu", "--out",
                              str(tmp_path / "port"), "--bench-path",
                              str(tmp_path / "b.json")])
    assert err.value.stage == jerr.value.stage == "teacher"

    def ledger(root):
        stages = json.load(open(root / "pixtral-12b" / "progress.json"))
        return [(s["name"], s["status"]) for s in stages["stages"]]

    assert ledger(tmp_path / "port") == ledger(tmp_path / "ref") == [
        ("teacher", "failed")]


def test_build_model_checks_the_family_as_the_reference_does():
    import dataclasses

    from repro.models import build_model as jbuild

    cfg = reduced_config("qwen2-1.5b")
    bad = dataclasses.replace(cfg, family="rnn")
    with pytest.raises(ValueError, match="unknown family"):
        build_model(bad, device="cpu")
    with pytest.raises(ValueError, match="unknown family"):
        jbuild(bad)
    for family in ("dense", "vlm", "audio", "hybrid", "ssm"):
        build_model(dataclasses.replace(cfg, family=family), device="cpu")
        jbuild(dataclasses.replace(cfg, family=family))
