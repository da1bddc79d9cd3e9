"""The port stands alone: no jax, nothing of ``repro``; and its entry points
never drop silently to the CPU."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro", "ml_dtypes")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) +
                         [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path} imports {bad}"


def test_engine_import_pulls_in_no_jax():
    code = ("import sys, repro_torch.serve.engine, repro_torch.convert, "
            "repro_torch.core, repro_torch.kernels._build, "
            "repro_torch.models.cnn, repro_torch.checkpoint, "
            "repro_torch.core.masks, repro_torch.serve.graphs, "
            "repro_torch.serve.sampler, repro_torch.launch.serve, "
            "repro_torch.launch.prune, repro_torch.core.pruner, "
            "repro_torch.optim, repro_torch.data, repro_torch.privacy, "
            "repro_torch.runtime, repro_torch.launch.pipeline, "
            "repro_torch.launch.train, repro_torch.serve.slots, "
            "repro_torch.serve.scheduler, repro_torch.runtime.trace_analysis, "
            "repro_torch.serve.speculative, repro_torch.models.model, "
            "repro_torch.core.synthetic, repro_torch.testing, "
            "repro_torch.models.moe, repro_torch.models.ssm, "
            "repro_torch.configs.xlstm_1_3b, repro_torch.configs.hymba_1_5b; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; print(bad); sys.exit(bool(bad))")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_entry_points_refuse_a_missing_card():
    """Without ``device=`` the entry points want the card; on a box
    without one they raise instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    from repro_torch.configs import reduced_config
    from repro_torch.core import PruneConfig, greedy_prune
    from repro_torch.models import LM
    from repro_torch.serve import ContinuousEngine, ServeEngine

    cfg = reduced_config("qwen2-1.5b")
    with pytest.raises(RuntimeError):
        LM(cfg)
    model = LM(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    pcfg = PruneConfig(scheme="tile_pattern",
                       overrides={".*": {"tile_block_p": 32}})
    with pytest.raises(RuntimeError):
        greedy_prune(params, pcfg)
    art = greedy_prune(params, pcfg, device="cpu")
    with pytest.raises(RuntimeError):
        art.pack()
    with pytest.raises(RuntimeError):
        ServeEngine(model, art, batch_size=2, max_seq_len=16)
    with pytest.raises(RuntimeError):
        ContinuousEngine(model, art, batch_size=2, max_seq_len=16)


def test_cnn_entry_points_refuse_a_missing_card():
    """The CNN constructors, the synthetic images and ``pack`` want the
    card by default, as ``LM`` does."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    from repro_torch.core import PruneConfig, greedy_prune
    from repro_torch.core.synthetic import synthetic_images
    from repro_torch.models import resnet18, vgg16

    kw = dict(width_mult=0.125, image_hwc=(8, 8, 3))
    for ctor in (vgg16, resnet18):
        with pytest.raises(RuntimeError):
            ctor(**kw)
    with pytest.raises(RuntimeError):
        synthetic_images(torch.Generator(), 2, (8, 8, 3))
    model = vgg16(**kw, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    art = greedy_prune(params, PruneConfig(scheme="pattern_shared"),
                       device="cpu")
    with pytest.raises(RuntimeError):
        art.pack()
    assert art.pack(device="cpu").summary()["packed_leaves"] == 13


def test_load_and_launcher_refuse_a_missing_card(tmp_path):
    """``PrunedArtifact.load``, ``load_pytree`` and the serve launcher want
    the card by default too; a CPU engine runs eagerly (graphs are a CUDA
    feature)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    from repro_torch.checkpoint import load_pytree
    from repro_torch.configs import reduced_config
    from repro_torch.core import PruneConfig, greedy_prune
    from repro_torch.launch import serve
    from repro_torch.models import LM
    from repro_torch.serve import Request, ServeEngine
    from repro_torch.sparse import PrunedArtifact

    cfg = reduced_config("qwen2-1.5b")
    model = LM(cfg, device="cpu")
    art = greedy_prune(model.init(torch.Generator().manual_seed(0)),
                       PruneConfig(scheme="column", alpha=0.5), device="cpu")
    art.save(str(tmp_path / "art"))
    with pytest.raises(RuntimeError):
        PrunedArtifact.load(str(tmp_path / "art"), cfg=cfg)
    with pytest.raises(RuntimeError):
        load_pytree(str(tmp_path / "art" / "params"))
    with pytest.raises(RuntimeError):
        serve.main(["--arch", "qwen2-1.5b", "--reduced"])
    eng = ServeEngine(model, art, batch_size=2, max_seq_len=16, device="cpu")
    eng.generate([Request(uid=0, prompt=[1, 2, 3], max_new_tokens=2)])
    assert not eng.graphs and eng.graph_pool is None
    loaded = PrunedArtifact.load(str(tmp_path / "art"), cfg=cfg, device="cpu")
    assert loaded.summary()["total_leaves"] == 0 and loaded.packed is None


def test_prune_launcher_and_pipelines_refuse_a_missing_card(tmp_path):
    """``launch/prune.py`` and the data pipelines want the card by
    default; with ``--device cpu`` the launcher prunes on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    from repro_torch.data import ClassificationPipeline, DataConfig
    from repro_torch.data import EmbeddingPipeline, TokenPipeline
    from repro_torch.launch import prune

    argv = ["--arch", "qwen2-1.5b", "--reduced", "--scheme", "tile_pattern",
            "--rate", "2", "--iters", "1", "--batch", "2", "--seq", "8",
            "--tile-block", "32", "--out", str(tmp_path / "out")]
    with pytest.raises(RuntimeError):
        prune.main(argv)
    assert not (tmp_path / "out").exists()
    for cls in (TokenPipeline, ClassificationPipeline, EmbeddingPipeline):
        with pytest.raises(RuntimeError):
            cls(DataConfig())
    result = prune.main(argv + ["--device", "cpu"])
    assert result.provenance["data"] == "synthetic"
    assert (tmp_path / "out" / "pruned" / "manifest.json").exists()


def test_pipeline_launcher_refuses_a_missing_card(tmp_path):
    """``launch/pipeline.py`` and the report's ops want the card by
    default, as the other launchers do."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    from repro_torch.launch import pipeline
    from repro_torch.privacy import ReportConfig, make_ops

    with pytest.raises(RuntimeError):
        make_ops("vgg16", ReportConfig())
    with pytest.raises(RuntimeError):
        pipeline.main(["--arch", "vgg16", "--reduced", "--quick",
                       "--out", str(tmp_path / "out")])
    assert not (tmp_path / "out" / "vgg16" / "progress.json").exists()
