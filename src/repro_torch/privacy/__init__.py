"""Privacy evaluation: measured membership-inference resistance (mirrors
``repro/privacy``).

  mia      — the attack harness: confidence-threshold and shadow-model
             membership-inference attacks, attack accuracy and AUC with
             bootstrap CIs, over per-example posterior features;
  report   — the three-way comparison (dense / ADMM-on-real /
             ADMM-on-synthetic), merged into
             ``experiments/bench/BENCH_torch_privacy_mia.json``.

The service loop that ships a pruned model with these numbers in its
manifest's ``privacy`` block is ``launch/pipeline.py``.
"""

from repro_torch.privacy.mia import (
    FEATURE_NAMES,
    AttackResult,
    auc,
    best_threshold,
    bootstrap_ci,
    confidence_attack,
    fit_logistic,
    posterior_features,
    sequence_features,
    shadow_attack,
    shadow_model_attack,
    threshold_accuracy,
)
from repro_torch.privacy.report import (
    BENCH_PATH,
    ReportConfig,
    make_ops,
    run_for_arch,
    run_report,
    write_bench,
)

__all__ = [
    "BENCH_PATH", "FEATURE_NAMES", "AttackResult", "ReportConfig", "auc",
    "best_threshold", "bootstrap_ci", "confidence_attack", "fit_logistic",
    "make_ops", "posterior_features", "run_for_arch", "run_report",
    "sequence_features", "shadow_attack", "shadow_model_attack",
    "threshold_accuracy", "write_bench",
]
