"""Three-way MIA report: dense vs ADMM-on-real vs ADMM-on-synthetic
(mirrors ``repro/privacy/report.py``).

The paper's privacy claim made measurable. Three models of the same
architecture, same client data, same compression target:

  ``dense``           the client's pre-trained model, never pruned;
  ``admm_real``       ADMM† pruned WITH the confidential data (the
                      no-privacy baseline), then masked-retrained;
  ``admm_synthetic``  the paper's ``PrivacyPreservingPruner``, pruned on
                      ``core/synthetic.py`` data only, then
                      masked-retrained on the client side.

Each is attacked with the ``privacy/mia.py`` harness (confidence-threshold
and shadow-model attacks) on the same member / non-member pools; the rows
are merged into ``experiments/bench/BENCH_torch_privacy_mia.json`` (the
port's own file, never the reference's).

The experimental design is the reference's: the client's confidential set
is a finite window of the deterministic pipelines (``member_batches``
batches, replayed), non-members come from far-away step indices, shadow
models train on the attacker's own disjoint windows with the same recipe,
and one shadow ensemble is fit per architecture and transferred to all
three targets. The same step geometry, seeds and recipes: CNN AdamW 3e-3
(no clip) and masked retraining with AdamW 2e-3 through
``core/retrain.py``; the LM through ``launch/train.py::make_train_step``
(AdamW 3e-3, clip 1.0) with and without masks. The port's pipelines draw
from torch generators, so its rows are not the reference's rows; the two
packages agree when fed the same batches and weights (the tests).

``make_ops(arch, cfg, reduced=True)`` is the reference's geometry (CNNs
at width 0.125 on 16 x 16 x 3, the LM at ``reduced_config``);
``reduced=False`` is full scale: CNNs at width 1.0 on 32 x 32 x 3, the LM
at ``get_config``. Everything runs on ``device`` (default: the card).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs import ARCHS, get_config, reduced_config
from repro_torch.core import (
    DEFAULT_EXCLUDE,
    LMAdapter,
    PrivacyPreservingPruner,
    PruneConfig,
    admm_task_prune,
    as_key,
    compression_rate,
    cross_entropy,
    make_retrain_step,
)
from repro_torch.core.pruner import PruneResult
from repro_torch.core.retrain import retrain as masked_retrain
from repro_torch.data import ClassificationPipeline, DataConfig, TokenPipeline
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch.prune import prune_config_for
from repro_torch.launch.train import make_train_step
from repro_torch.models import LM
from repro_torch.models.cnn import resnet18, resnet50_basic, vgg16
from repro_torch.optim import adamw
from repro_torch.privacy import mia

log = logging.getLogger(__name__)

METHODS = ("dense", "admm_real", "admm_synthetic")
CNN_ARCHS = ("vgg16", "resnet18", "resnet50")

# step-index geometry of the deterministic pipelines: member window at 0,
# non-members far away, one disjoint stride per shadow model
_NONMEMBER_BASE = 50_000_000
_SHADOW_STRIDE = 1_000_000
_SHADOW_HOLDOUT = 500_000

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))
BENCH_PATH = os.path.join(_ROOT, "experiments", "bench",
                          "BENCH_torch_privacy_mia.json")

# image geometry of the CNN arms: the reference's reduced one, and full
# scale (the 10-class CIFAR geometry the port's ResNet-18 path runs)
CNN_GEOMETRY = {True: (0.125, (16, 16, 3)), False: (1.0, (32, 32, 3))}


@dataclasses.dataclass(frozen=True)
class ReportConfig:
    """Budget knobs for the three-way report (the reference's fields and
    defaults)."""

    quick: bool = False
    teacher_steps: int = 400        # dense/shadow training steps
    prune_iters: int = 40           # ADMM iterations (both arms)
    retrain_steps: int = 200        # client-side masked retraining
    member_batches: int = 4         # finite confidential set, in batches
    shadows: int = 3                # shadow models in the attack ensemble
    cnn_batch: int = 64
    lm_batch: int = 16
    seq_len: int = 32
    rate: float = 4.0               # compression target
    # channel-shared library patterns: always packable, so the pipeline's
    # artifact compresses
    cnn_scheme: str = "pattern_shared"
    lm_scheme: str = "tile_pattern"
    tile_block: int = 32            # divides every GEMM dim, reduced or not
    n_boot: int = 200               # bootstrap resamples for CIs
    seed: int = 0

    @classmethod
    def for_mode(cls, quick: bool, **overrides) -> "ReportConfig":
        base = (dict(quick=True, teacher_steps=120, prune_iters=8,
                     retrain_steps=60, shadows=2, n_boot=100)
                if quick else {})
        base.update(overrides)
        return cls(**base)


# ---------------------------------------------------------------------------
# BenchOps: everything family-specific, closed over once per arch
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class BenchOps:
    """Family-specific operations the three-way comparison drives.

    ``train`` runs the client's (or attacker's) dense recipe over a finite
    step window; ``retrain`` is the client's masked retraining from pruned
    weights; ``features`` maps (params, step window) → (N, 4) MIA feature
    rows.
    """

    kind: str                                          # "cnn" | "lm"
    arch: str
    model: Any                                         # has .init / .apply
    prune_cfg: PruneConfig
    member_steps: Sequence[int]
    nonmember_steps: Sequence[int]
    train: Callable[[Sequence[int], int], Any]         # (window, seed)
    retrain: Callable[[Any, Any], Any]                 # (params, masks)
    prune_real: Callable[..., PruneResult]         # (teacher, **resume kw)
    prune_synthetic: Callable[..., PruneResult]    # (teacher, **resume kw)
    features: Callable[[Any, Sequence[int]], np.ndarray]
    mean_loss: Callable[[Any, Sequence[int]], float]

    @property
    def model_config(self):
        """The LM's config (its blocks are stacked on disk); None for a
        CNN."""
        return self.model.config if self.kind == "lm" else None

    def shadow_windows(self, i: int) -> Tuple[List[int], List[int]]:
        base = _SHADOW_STRIDE * (i + 1)
        k = len(self.member_steps)
        return ([base + j for j in range(k)],
                [base + _SHADOW_HOLDOUT + j for j in range(k)])


def _cycle(batch_at: Callable[[int], Any], window: Sequence[int]):
    i = 0
    while True:
        yield batch_at(window[i % len(window)])
        i += 1


def _window_batch_fn(batch_at: Callable[[int], Any],
                     window: Sequence[int]) -> Callable[[int], Any]:
    """Step-indexed replay of the finite member window: the callable form
    ``admm_task_prune`` needs for checkpoint / resume."""
    return lambda it: batch_at(window[it % len(window)])


def _seeded(device: torch.device, seed: int) -> torch.Generator:
    return torch.Generator(device).manual_seed(seed)


# -- CNN family --------------------------------------------------------------

def _make_cnn_ops(arch: str, cfg: ReportConfig, reduced: bool,
                  dev: torch.device) -> BenchOps:
    builders = {"vgg16": vgg16, "resnet18": resnet18,
                "resnet50": resnet50_basic}
    width, hwc = CNN_GEOMETRY[reduced]
    model = builders[arch](10, width_mult=width, image_hwc=hwc, device=dev)
    pipe = ClassificationPipeline(
        DataConfig(num_classes=10, global_batch=cfg.cnn_batch,
                   image_hwc=hwc, seed=7),
        noise=0.35, device=dev)
    prune_cfg = prune_config_for(
        scheme=cfg.cnn_scheme, rate=cfg.rate, iters=cfg.prune_iters,
        batch=32, layerwise=False,
        exclude=tuple(DEFAULT_EXCLUDE) + (r".*head.*",))

    opt = adamw(3e-3)
    # the dense recipe is the masked step with no masks: grads -> AdamW ->
    # (p + u) in p's dtype, no clip
    step = make_retrain_step(model.apply, cross_entropy, opt, None)

    def train(window: Sequence[int], seed: int):
        params = model.init(_seeded(dev, seed))
        opt_state = opt.init(params)
        for t in range(cfg.teacher_steps):
            params, opt_state, _ = step(
                params, opt_state, pipe.batch_at(window[t % len(window)]))
        return params

    member = list(range(cfg.member_batches))

    def retrain_fn(params, masks):
        out, _ = masked_retrain(
            params, masks, model.apply, cross_entropy, adamw(2e-3),
            _cycle(pipe.batch_at, member), steps=cfg.retrain_steps)
        return out

    @torch.no_grad()
    def features(params, steps: Sequence[int]) -> np.ndarray:
        rows = []
        for s in steps:
            x, y = pipe.batch_at(s)
            rows.append(mia.posterior_features(model.apply(params, x), y))
        return np.concatenate(rows, axis=0)

    @torch.no_grad()
    def mean_loss(params, steps: Sequence[int]) -> float:
        vals = []
        for s in steps:
            x, y = pipe.batch_at(s)
            vals.append(float(cross_entropy(model.apply(params, x), y)))
        return float(np.mean(vals))

    return BenchOps(
        kind="cnn", arch=arch, model=model, prune_cfg=prune_cfg,
        member_steps=member,
        nonmember_steps=[_NONMEMBER_BASE + j
                         for j in range(cfg.member_batches)],
        train=train,
        retrain=retrain_fn,
        prune_real=lambda teacher, **kw: admm_task_prune(
            as_key(cfg.seed + 1), teacher, model.apply,
            _window_batch_fn(pipe.batch_at, member), prune_cfg, **kw),
        prune_synthetic=lambda teacher, **kw: PrivacyPreservingPruner(
            model, prune_cfg).run(as_key(cfg.seed + 1), teacher, **kw),
        features=features,
        mean_loss=mean_loss,
    )


# -- LM family ---------------------------------------------------------------

def _make_lm_ops(arch: str, cfg: ReportConfig, reduced: bool,
                 dev: torch.device) -> BenchOps:
    mcfg = reduced_config(arch) if reduced else get_config(arch)
    model = LM(mcfg, device=dev)
    adapter = LMAdapter(model, seq_len=cfg.seq_len)
    pipe = TokenPipeline(
        DataConfig(seq_len=cfg.seq_len, global_batch=cfg.lm_batch,
                   vocab_size=mcfg.vocab_size, seed=5), device=dev)
    prune_cfg = prune_config_for(
        scheme=cfg.lm_scheme, rate=cfg.rate, iters=cfg.prune_iters,
        batch=8, tile_block=cfg.tile_block, layerwise=False)

    # dense training is the launch/train.py step (grads -> clip -> adamw);
    # masked retraining is the same step with the mask function plumbed
    # in: the client-side loop the service hands its masks to
    opt = adamw(3e-3)

    def _loop(params, masks, window: Sequence[int], num_steps: int):
        step = make_train_step(model, opt, masks=masks)
        state = {"params": params, "opt": opt.init(params), "step": 0}
        for t in range(num_steps):
            state, _ = step(state, pipe.batch_at(window[t % len(window)]))
        return state["params"]

    def train(window: Sequence[int], seed: int):
        return _loop(model.init(_seeded(dev, seed)), None, window,
                     cfg.teacher_steps)

    member = list(range(cfg.member_batches))

    def retrain_fn(params, masks):
        return _loop(params, masks, member, cfg.retrain_steps)

    def _tuple_batch_fn(window: Sequence[int]) -> Callable[[int], Any]:
        def fn(it: int):
            b = pipe.batch_at(window[it % len(window)])
            return b["inputs"], b["labels"]

        return fn

    @torch.no_grad()
    def features(params, steps: Sequence[int]) -> np.ndarray:
        rows = []
        for s in steps:
            b = pipe.batch_at(s)
            rows.append(mia.sequence_features(
                adapter.apply(params, b["inputs"]), b["labels"]))
        return np.concatenate(rows, axis=0)

    @torch.no_grad()
    def mean_loss(params, steps: Sequence[int]) -> float:
        vals = []
        for s in steps:
            b = pipe.batch_at(s)
            vals.append(float(torch.mean(adapter.per_example_loss(
                params, b["inputs"], b["labels"]))))
        return float(np.mean(vals))

    return BenchOps(
        kind="lm", arch=arch, model=model, prune_cfg=prune_cfg,
        member_steps=member,
        nonmember_steps=[_NONMEMBER_BASE + j
                         for j in range(cfg.member_batches)],
        train=train,
        retrain=retrain_fn,
        prune_real=lambda teacher, **kw: admm_task_prune(
            as_key(cfg.seed + 1), teacher, adapter.apply,
            _tuple_batch_fn(member), prune_cfg, **kw),
        prune_synthetic=lambda teacher, **kw: PrivacyPreservingPruner(
            adapter, prune_cfg).run(as_key(cfg.seed + 1), teacher, **kw),
        features=features,
        mean_loss=mean_loss,
    )


def make_ops(arch: str, cfg: ReportConfig, *, reduced: bool = True,
             device: DeviceLike = None) -> BenchOps:
    dev = resolve_device(device)
    if arch in CNN_ARCHS:
        return _make_cnn_ops(arch, cfg, reduced, dev)
    if arch in ARCHS:
        return _make_lm_ops(arch, cfg, reduced, dev)
    raise ValueError(
        f"unknown arch '{arch}' — CNNs: {CNN_ARCHS}; zoo: {sorted(ARCHS)}")


# ---------------------------------------------------------------------------
# the three-way comparison
# ---------------------------------------------------------------------------

def _lineage(result: PruneResult) -> Tuple[Optional[str], float]:
    """What a row keeps of a pruned arm: the data its prune consumed and
    its compression rate."""
    return (result.provenance.get("data"),
            round(compression_rate(result.masks), 3))


def three_way(
    ops: BenchOps,
    cfg: ReportConfig,
    *,
    teacher: Any = None,
    synthetic: Optional[Tuple[PruneResult, Any]] = None,
) -> List[Dict[str, Any]]:
    """Run the comparison; returns one bench row per method.

    ``teacher`` short-circuits dense training (the pipeline's restored or
    demo-trained checkpoint); ``synthetic`` = (PruneResult, retrained
    params) makes the pipeline's own pruned model the ``admm_synthetic``
    arm, so the manifest's MIA numbers describe the shipped weights.
    The real arm's pruned weights and masks are freed once it is
    retrained (its row keeps their data lineage and compression rate),
    each shadow once its features are taken, and the device's cached
    blocks are released between arms.
    """
    t0 = time.perf_counter()
    if teacher is None:
        log.info("[%s/%s] training dense teacher (%d steps)", ops.kind,
                 ops.arch, cfg.teacher_steps)
        teacher = ops.train(ops.member_steps, cfg.seed)

    log.info("[%s/%s] ADMM† pruning on REAL member data", ops.kind, ops.arch)
    real = ops.prune_real(teacher)
    real_rt = ops.retrain(real.params, real.masks)
    real = _lineage(real)
    torch.cuda.empty_cache()

    if synthetic is None:
        log.info("[%s/%s] privacy-preserving ADMM on SYNTHETIC data",
                 ops.kind, ops.arch)
        syn = ops.prune_synthetic(teacher)
        syn_rt = ops.retrain(syn.params, syn.masks)
        torch.cuda.empty_cache()
    else:
        syn, syn_rt = synthetic

    log.info("[%s/%s] training %d shadow model(s)", ops.kind, ops.arch,
             cfg.shadows)
    shadow_feats = []
    for i in range(cfg.shadows):
        mw, nw = ops.shadow_windows(i)
        sp = ops.train(mw, cfg.seed + 101 + i)
        shadow_feats.append((ops.features(sp, mw), ops.features(sp, nw)))
        del sp
        torch.cuda.empty_cache()

    targets = {
        "dense": (teacher, (None, 1.0)),
        "admm_real": (real_rt, real),
        "admm_synthetic": (syn_rt, _lineage(syn)),
    }
    rows = []
    for method, (params, (prune_data, comp_rate)) in targets.items():
        fm = ops.features(params, ops.member_steps)
        fn = ops.features(params, ops.nonmember_steps)
        conf = mia.confidence_attack(fm, fn, n_boot=cfg.n_boot,
                                     seed=cfg.seed)
        sh = mia.shadow_model_attack(
            fm, fn, shadow_features=lambda i: shadow_feats[i],
            num_shadows=cfg.shadows, n_boot=cfg.n_boot, seed=cfg.seed)
        member_loss = ops.mean_loss(params, ops.member_steps)
        nonmember_loss = ops.mean_loss(params, ops.nonmember_steps)
        rows.append({
            "model": ops.kind,
            "arch": ops.arch,
            "method": method,
            "prune_data": prune_data,
            "comp_rate": comp_rate,
            "mia_auc": round(conf.auc, 4),
            "mia_acc": round(conf.accuracy, 4),
            "mia_auc_ci": [round(v, 4) for v in conf.auc_ci],
            "mia_acc_ci": [round(v, 4) for v in conf.accuracy_ci],
            "mia_auc_shadow": round(sh.auc, 4),
            "mia_acc_shadow": round(sh.accuracy, 4),
            "mia_auc_shadow_ci": [round(v, 4) for v in sh.auc_ci],
            "member_loss": round(member_loss, 4),
            "nonmember_loss": round(nonmember_loss, 4),
            "loss_gap": round(nonmember_loss - member_loss, 4),
            "n_member": int(fm.shape[0]),
            "n_nonmember": int(fn.shape[0]),
            "shadows": cfg.shadows,
            "quick": cfg.quick,
        })
    log.info("[%s/%s] three-way report done in %.1fs", ops.kind, ops.arch,
             time.perf_counter() - t0)
    return rows


def run_for_arch(
    arch: str,
    cfg: ReportConfig,
    *,
    teacher: Any = None,
    synthetic: Optional[Tuple[PruneResult, Any]] = None,
    reduced: bool = True,
    device: DeviceLike = None,
) -> List[Dict[str, Any]]:
    return three_way(make_ops(arch, cfg, reduced=reduced, device=device),
                     cfg, teacher=teacher, synthetic=synthetic)


def run_report(cfg: ReportConfig,
               archs: Sequence[str] = ("vgg16", "qwen2-1.5b"), *,
               reduced: bool = True, device: DeviceLike = None
               ) -> List[Dict[str, Any]]:
    """The canonical report: the CNN + LM pair."""
    rows: List[Dict[str, Any]] = []
    for arch in archs:
        rows.extend(run_for_arch(arch, cfg, reduced=reduced, device=device))
    return rows


# ---------------------------------------------------------------------------
# bench persistence (merge-write so pipeline runs accumulate)
# ---------------------------------------------------------------------------

def write_bench(rows: List[Dict[str, Any]],
                path: Optional[str] = None) -> str:
    """Merge rows into ``path`` (default ``BENCH_PATH``), keyed by (model,
    method): a run of one family refreshes only its own rows."""
    path = path or BENCH_PATH
    existing: List[Dict[str, Any]] = []
    if os.path.isfile(path):
        try:
            with open(path) as f:
                existing = json.load(f)
        except (json.JSONDecodeError, OSError):
            existing = []
    by_key = {(r.get("model"), r.get("method")): r for r in existing}
    for r in rows:
        by_key[(r.get("model"), r.get("method"))] = r
    merged = sorted(by_key.values(),
                    key=lambda r: (str(r.get("model")),
                                   METHODS.index(r["method"])
                                   if r.get("method") in METHODS else 99))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(merged, f, indent=1)
    return path


def print_rows(rows: List[Dict[str, Any]]) -> None:
    hdr = (f"{'model':>5s} {'arch':>12s} {'method':>16s} {'rate':>6s} "
           f"{'auc':>6s} {'acc':>6s} {'auc(sh)':>7s} {'loss_gap':>8s}")
    print(hdr)
    print("-" * len(hdr))
    for r in rows:
        print(f"{r['model']:>5s} {r['arch']:>12s} {r['method']:>16s} "
              f"{r['comp_rate']:>5.1f}x {r['mia_auc']:>6.3f} "
              f"{r['mia_acc']:>6.3f} {r['mia_auc_shadow']:>7.3f} "
              f"{r['loss_gap']:>8.3f}")
