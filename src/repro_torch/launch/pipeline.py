"""The complete privacy-preserving pruning service, one command, on the
card (mirrors ``repro/launch/pipeline.py``; the paper's Fig. 2, both
boxes).

A client submits a pre-trained checkpoint; the system designer prunes it
on randomly generated synthetic data (never the client's dataset), hands
the mask function back for client-side masked retraining, packs the
result into a servable ``PrunedArtifact``, and measures the privacy claim
with the membership-inference harness before shipping.

    PYTHONPATH=src python -m repro_torch.launch.pipeline \\
        --arch vgg16 --reduced --quick --device cpu    # small, on the CPU
    PYTHONPATH=src python -m repro_torch.launch.pipeline \\
        --arch vgg16 --quick                           # full scale, card

Per arch, in process:

  1. ``teacher``: the client checkpoint in (``--teacher-ckpt``, the
     reference's stacked layout); else a demo teacher trained on the
     deterministic "confidential" pipeline;
  2. ``prune``: synthetic ADMM (``PrivacyPreservingPruner`` on
     ``core/synthetic.py`` data), checkpointing its own run state under
     ``<out>/<arch>/prune_ckpt``;
  3. ``retrain``: client-side masked retraining on the confidential data;
  4. ``pack``: ``PruneResult.to_artifact().with_params(retrained)``
     packed, its manifest's ``privacy`` block carrying the data lineage
     (synthetic prune, then real retrain), and its execution plans tuned
     on the run's device for M = 8 under ``--quick``, else for M = 8 and
     256 (``sparse/tune.py``; ``--no-tune`` packs untuned);
  5. ``mia``: the three-way report (dense / ADMM-real / ADMM-synthetic,
     this run's pruned model as the synthetic arm) merged into
     ``--bench-path`` and summarized into the manifest (``--no-mia``
     skips);
  6. ``save``: the artifact under ``<out>/<arch>/artifact``.

``--reduced`` is the reference's geometry (CNNs at width 0.125 on 16 x
16 x 3, the LM at ``reduced_config``); without it the run is full scale
(CNNs at width 1.0 on 32 x 32 x 3, the LM at ``get_config``). The stages
run under ``runtime.fault_tolerance.StagedRun``: retries per stage, an
atomically replaced ``progress.json`` ledger, and ``--resume`` /
``--restart-stage``. Each arch's metrics registry is written to
``<out>/<arch>/telemetry.json``. The saved artifact serves directly:
``launch/serve.py --artifact <out>/<arch>/artifact --packed``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import shutil
import time
from typing import Any, Dict, List, Optional, Sequence

import torch

from repro_torch.checkpoint import load_pytree, save_pytree
from repro_torch.configs import ARCHS
from repro_torch.convert import params_from_jax, tree_to_jax
from repro_torch.core import compression_rate, sparsity
from repro_torch.core.masks import masks_from_specs
from repro_torch.core.pruner import PruneResult
from repro_torch.core.schemes import build_specs
from repro_torch.device import DeviceLike
from repro_torch.privacy import report as privacy_report
from repro_torch.privacy.report import CNN_ARCHS, BenchOps, ReportConfig
from repro_torch.runtime import telemetry_export
from repro_torch.runtime.fault_tolerance import StagedRun, StageError
from repro_torch.runtime.telemetry import get_registry, registry_scope

log = logging.getLogger(__name__)

STAGES = ("teacher", "prune", "retrain", "pack", "mia", "save")
# stages whose outputs are persisted under <out>/<arch>/stage_<name> so a
# restarted process can rebuild the carry and skip them (pack / mia / save
# are cheap beside them and always re-run)
RESUMABLE_STAGES = ("teacher", "prune", "retrain")


def _persist_stage(base: str, name: str, tree: Any,
                   extra: Optional[Dict[str, Any]] = None) -> None:
    save_pytree(os.path.join(base, f"stage_{name}"), tree_to_jax(tree),
                extra=extra or {})


def _load_stage(base: str, name: str, ops: BenchOps):
    """A persisted stage's params (on the model's device) and extra."""
    d = os.path.join(base, f"stage_{name}")
    tree = params_from_jax(load_pytree(d, device="cpu"), ops.model_config,
                           ops.model.device)
    with open(os.path.join(d, "manifest.json")) as f:
        extra = json.load(f).get("extra", {})
    return tree, extra


def _rebuild_prune_result(params: Any, extra: Dict[str, Any],
                          prune_cfg) -> PruneResult:
    """PruneResult from a persisted prune stage: the specs and masks are
    pure functions of the (exactly sparse) saved params and the config."""
    specs = build_specs(params, prune_cfg)
    return PruneResult(
        params, masks_from_specs(params, specs), specs,
        history=extra.get("history", {}),
        seconds_per_iter=float(extra.get("seconds_per_iter", 0.0)),
        provenance=extra.get("provenance", {}))


def run_arch(
    arch: str,
    *,
    cfg: ReportConfig,
    out_dir: str,
    reduced: bool = True,
    device: DeviceLike = None,
    teacher_ckpt: Optional[str] = None,
    run_mia: bool = True,
    tune: bool = True,
    bench_path: Optional[str] = None,
    stage_retries: int = 1,
    resume: bool = False,
    restart_stage: Optional[str] = None,
    save_every: Optional[int] = None,
) -> Dict[str, Any]:
    """The full service loop for one architecture; returns a summary.

    Each stage gets ``stage_retries`` extra attempts before the arch fails
    with a ``StageError`` naming the stage; a retried stage never re-runs
    the stages before it, and every stage's status, attempts and seconds
    land in ``<out>/<arch>/progress.json`` after each stage.

    ``resume=True`` rebuilds the carry from the persisted outputs of the
    stages the ledger marks complete and skips them; a kill mid-prune
    resumes from the prune's last committed ADMM iteration (checkpoints
    every ``save_every`` iterations). ``restart_stage`` drops that stage
    and every later one from the ledger first (and, for ``prune``, its
    ADMM checkpoints), then resumes.
    """
    t0 = time.perf_counter()
    base = os.path.join(out_dir, arch)
    progress_path = os.path.join(base, "progress.json")
    if restart_stage:
        kept = StagedRun.invalidate_stage(progress_path, restart_stage)
        log.info("[%s] ledger entry for stage %r (and later stages) "
                 "invalidated; still complete: %s", arch, restart_stage,
                 kept or "none")
        if restart_stage == "prune":
            # the ADMM checkpoints belong to the invalidated attempt: a
            # forced rerun must not resume them
            shutil.rmtree(os.path.join(base, "prune_ckpt"),
                          ignore_errors=True)
        resume = True
    if save_every is None or save_every <= 0:
        save_every = max(1, cfg.prune_iters // 4)

    ops = privacy_report.make_ops(arch, cfg, reduced=reduced, device=device)
    dev = ops.model.device
    ctx: Dict[str, Any] = {}

    skip: List[str] = []
    if resume:
        done = set(StagedRun.completed_stages(progress_path))
        for sname in RESUMABLE_STAGES:
            if sname not in done:
                break
            try:
                tree, extra = _load_stage(base, sname, ops)
            except Exception as e:  # noqa: BLE001 — degrade to a re-run
                log.warning("[%s] stage %r marked complete but its "
                            "persisted output is unloadable (%s); "
                            "re-running from it", arch, sname, e)
                break
            if sname == "teacher":
                ctx["teacher"] = tree
            elif sname == "prune":
                ctx["result"] = _rebuild_prune_result(tree, extra,
                                                      ops.prune_cfg)
            else:
                ctx["retrained"] = tree
            skip.append(sname)
        if skip:
            log.info("[%s] resuming: stage(s) %s restored from disk",
                     arch, ", ".join(skip))

    def stage_teacher(ctx):
        if teacher_ckpt:
            ctx["teacher"] = params_from_jax(
                load_pytree(teacher_ckpt, device="cpu"), ops.model_config,
                dev)
            log.info("[%s] restored client checkpoint from %s", arch,
                     teacher_ckpt)
        else:
            log.info("[%s] no --teacher-ckpt: training a demo teacher on "
                     "the confidential pipeline (%d steps)", arch,
                     cfg.teacher_steps)
            ctx["teacher"] = ops.train(ops.member_steps, cfg.seed)
        _persist_stage(base, "teacher", ctx["teacher"],
                       extra={"arch": arch})
        return ctx

    def stage_prune(ctx):
        log.info("[%s] privacy-preserving ADMM prune (%s @ %.1fx, %d "
                 "iters, synthetic data only)", arch, ops.prune_cfg.scheme,
                 cfg.rate, cfg.prune_iters)
        # resume=True unconditionally: the run fingerprint (teacher
        # weights + config) guards against resuming another run's
        # checkpoints, so a stage retry or a restarted process continues
        # from the last committed ADMM iteration
        ctx["result"] = ops.prune_synthetic(
            ctx["teacher"],
            checkpoint_dir=os.path.join(base, "prune_ckpt"),
            save_every=save_every, resume=True)
        log.info("[%s] pruned %.2fx (sparsity %.1f%%), client data never "
                 "touched", arch, compression_rate(ctx["result"].masks),
                 100 * sparsity(ctx["result"].masks))
        _persist_stage(base, "prune", ctx["result"].params, extra={
            "arch": arch,
            "history": ctx["result"].history,
            "seconds_per_iter": ctx["result"].seconds_per_iter,
            "provenance": ctx["result"].provenance,
        })
        return ctx

    def stage_retrain(ctx):
        log.info("[%s] masked retraining on the client's confidential "
                 "data (%d steps)", arch, cfg.retrain_steps)
        ctx["retrained"] = ops.retrain(ctx["result"].params,
                                       ctx["result"].masks)
        _persist_stage(base, "retrain", ctx["retrained"],
                       extra={"arch": arch})
        return ctx

    def stage_pack(ctx):
        ctx["artifact"] = (
            ctx["result"]
            .to_artifact(arch=arch, scheme=ops.prune_cfg.scheme,
                         rate=cfg.rate)
            .with_params(ctx["retrained"])
            .with_privacy(retrained_on="client_confidential",
                          pipeline="repro_torch.launch.pipeline")
            .pack(device=dev,
                  tune_for=((8,) if cfg.quick else (8, 256)) if tune
                  else None,
                  tune_iters=1 if cfg.quick else 3))
        # the retrained weights supersede the pruned ones (kept on disk
        # under stage_prune); later stages read only the masks and the
        # lineage, so a full-depth LM's MIA stage need not hold them
        ctx["result"] = dataclasses.replace(ctx["result"], params=None)
        return ctx

    def stage_mia(ctx):
        ctx["rows"] = []
        if not run_mia:
            return ctx
        rows = privacy_report.three_way(
            ops, cfg, teacher=ctx["teacher"],
            synthetic=(ctx["result"], ctx["retrained"]))
        path = privacy_report.write_bench(rows, path=bench_path)
        log.info("[%s] MIA report merged into %s", arch, path)
        by = {r["method"]: r for r in rows}
        syn_row = by["admm_synthetic"]
        ctx["artifact"] = ctx["artifact"].with_privacy(mia={
            "attack_auc": syn_row["mia_auc"],
            "attack_acc": syn_row["mia_acc"],
            "attack_auc_shadow": syn_row["mia_auc_shadow"],
            "auc_delta_vs_real": round(
                syn_row["mia_auc"] - by["admm_real"]["mia_auc"], 4),
            "auc_delta_vs_dense": round(
                syn_row["mia_auc"] - by["dense"]["mia_auc"], 4),
            "n_member": syn_row["n_member"],
            "n_nonmember": syn_row["n_nonmember"],
        })
        ctx["rows"] = rows
        return ctx

    def stage_save(ctx):
        artifact_dir = os.path.join(base, "artifact")
        ctx["artifact"].save(artifact_dir)
        s = ctx["artifact"].summary()
        log.info("[%s] packed artifact -> %s (%d/%d leaves packed, %.2fx "
                 "weight bytes)", arch, artifact_dir, s["packed_leaves"],
                 s["total_leaves"], s["bytes_ratio"])
        ctx["artifact_dir"], ctx["summary"] = artifact_dir, s
        return ctx

    def peak_tracked(name: str, fn):
        """``fn`` with its peak device memory written to the gauge
        ``pipeline.stage_peak_device_bytes{stage}`` (on the card only)."""
        if dev.type != "cuda":
            return fn

        def run(ctx):
            torch.cuda.reset_peak_memory_stats(dev)
            ctx = fn(ctx)
            get_registry().gauge("pipeline.stage_peak_device_bytes",
                                 stage=name).set(
                torch.cuda.max_memory_allocated(dev))
            return ctx

        return run

    runner = StagedRun(arch, max_retries=stage_retries,
                       progress_path=progress_path)
    ctx = runner.run(ctx, [(name, peak_tracked(name, fn)) for name, fn in (
        ("teacher", stage_teacher),
        ("prune", stage_prune),
        ("retrain", stage_retrain),
        ("pack", stage_pack),
        ("mia", stage_mia),
        ("save", stage_save),
    )], skip=skip)

    s = ctx["summary"]
    return {
        "arch": arch,
        "kind": ops.kind,
        "scheme": ops.prune_cfg.scheme,
        "comp_rate": round(compression_rate(ctx["result"].masks), 3),
        "bytes_ratio": round(s["bytes_ratio"], 3),
        "packed_leaves": s["packed_leaves"],
        "artifact_dir": ctx["artifact_dir"],
        "privacy": ctx["artifact"].privacy,
        "mia_rows": len(ctx["rows"]),
        "stages": [dataclasses.asdict(r) for r in runner.records],
        "seconds": round(time.perf_counter() - t0, 1),
    }


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        description="end-to-end privacy-preserving pruning service")
    ap.add_argument("--arch", required=True,
                    help=f"one of {CNN_ARCHS + tuple(sorted(ARCHS))}, or "
                         f"'all' for the configs/ archs")
    ap.add_argument("--reduced", action="store_true",
                    help="the reference's reduced geometry (CNNs at width "
                         "0.125 on 16x16, the LM at reduced_config); "
                         "without it, full scale (the 28-layer LM with "
                         "--quick peaks at about 75 GB of device memory "
                         "on an H100)")
    ap.add_argument("--quick", action="store_true",
                    help="CI-scale budgets for every stage")
    ap.add_argument("--rate", type=float, default=4.0)
    ap.add_argument("--iters", type=int, default=None,
                    help="override ADMM prune iterations")
    ap.add_argument("--teacher-ckpt", default=None,
                    help="client checkpoint dir, the reference's layout "
                         "(else a demo teacher)")
    ap.add_argument("--out", default=os.path.join("experiments",
                                                  "pipeline_torch"))
    ap.add_argument("--no-mia", action="store_true",
                    help="skip the membership-inference report")
    ap.add_argument("--no-tune", action="store_true",
                    help="pack without the plan search (the kernels' "
                         "heuristic geometry serves)")
    ap.add_argument("--bench-path", default=None,
                    help="where the MIA rows are merged (default "
                         "experiments/bench/BENCH_torch_privacy_mia.json)")
    ap.add_argument("--stage-retries", type=int, default=1,
                    help="extra attempts per pipeline stage before the "
                         "arch fails")
    ap.add_argument("--resume", action="store_true",
                    help="resume a killed run: completed stages are "
                         "restored from <out>/<arch>/stage_* and skipped; "
                         "a kill mid-prune continues from the ADMM "
                         "checkpoint")
    ap.add_argument("--restart-stage", default=None, choices=list(STAGES),
                    help="invalidate this stage (and every later one) in "
                         "the progress.json ledger and re-run from there "
                         "(implies --resume)")
    ap.add_argument("--save-every", type=int, default=None,
                    help="ADMM checkpoint cadence in iterations (default: "
                         "prune_iters/4)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    # a resumed run must retrain to the same bits as an uninterrupted one:
    # no nondeterministic conv algorithms on the card
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False

    archs = sorted(ARCHS) if args.arch == "all" else [args.arch]
    overrides: Dict[str, Any] = {"rate": args.rate}
    if args.iters is not None:
        overrides["prune_iters"] = args.iters
    cfg = ReportConfig.for_mode(args.quick, **overrides)

    summaries = []
    for arch in archs:
        # each arch under its own registry scope: stage timings and
        # retries and the ADMM iterations land in one snapshot beside the
        # arch's progress.json, even when a stage fails
        with registry_scope() as reg:
            try:
                summaries.append(run_arch(
                    arch, cfg=cfg, out_dir=args.out, reduced=args.reduced,
                    device=args.device, teacher_ckpt=args.teacher_ckpt,
                    run_mia=not args.no_mia, tune=not args.no_tune,
                    bench_path=args.bench_path,
                    stage_retries=args.stage_retries, resume=args.resume,
                    restart_stage=args.restart_stage,
                    save_every=args.save_every))
            except Exception as e:
                if args.arch != "all":
                    raise
                # batch mode: one arch failing must not strand the rest;
                # a StageError names the stage that ran out of retries
                log.exception("[%s] pipeline failed; continuing the batch",
                              arch)
                failed: Dict[str, Any] = {"arch": arch, "error": True}
                if isinstance(e, StageError):
                    failed["failed_stage"] = e.stage
                    failed["attempts"] = e.attempts
                summaries.append(failed)
            finally:
                base = os.path.join(args.out, arch)
                os.makedirs(base, exist_ok=True)
                telemetry_export.write_json(
                    os.path.join(base, "telemetry.json"), reg, arch=arch)

    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "pipeline_summary.json"), "w") as f:
        json.dump(summaries, f, indent=1)
    for s in summaries:
        if s.get("error"):
            where = (f" at stage {s['failed_stage']!r} "
                     f"after {s['attempts']} attempt(s)"
                     if s.get("failed_stage") else "")
            print(f"{s['arch']}: FAILED{where}")
            continue
        mia = (s.get("privacy") or {}).get("mia")
        mia_txt = (f", MIA auc {mia['attack_auc']:.3f} "
                   f"(Δreal {mia['auc_delta_vs_real']:+.3f}, "
                   f"Δdense {mia['auc_delta_vs_dense']:+.3f})"
                   if mia else "")
        print(f"{s['arch']}: {s['comp_rate']}x pruned, "
              f"{s['bytes_ratio']}x weight bytes, artifact -> "
              f"{s['artifact_dir']}{mia_txt} [{s['seconds']}s]")
    return 1 if any(s.get("error") for s in summaries) else 0


if __name__ == "__main__":
    raise SystemExit(main())
