"""The paper's contribution in the port: privacy-preserving ADMM pruning
on synthetic data, its resumable run state, the traditional ADMM-dagger
baseline, masked retraining, and the data-free greedy pruner (mirrors
``repro/core``).

Every ADMM entry point (``PrivacyPreservingPruner.run`` and
``admm_task_prune``) takes ``checkpoint_dir`` / ``save_every`` /
``resume``: the run state commits every ``save_every`` iterations, and a
killed run resumed with ``resume=True`` ends bit-identical to an
uninterrupted one (``core/prune_state.py``).
"""

from repro_torch.core.admm import (
    ADMMVars,
    admm_init,
    admm_iteration,
    augmented_penalty,
    dual_residual,
    dual_step,
    primal_residual,
    primal_step,
    proximal_step,
)
from repro_torch.core.admm_traditional import (
    admm_task_prune,
    cross_entropy,
    per_example_cross_entropy,
)
from repro_torch.core.distill import (
    frobenius_distance,
    layerwise_loss,
    whole_model_loss,
)
from repro_torch.core.greedy import greedy_prune
from repro_torch.core.lm_adapter import LMAdapter
from repro_torch.core.masks import (
    apply_mask,
    compression_rate,
    mask_from_params,
    mask_gradients,
    sparsity,
)
from repro_torch.core.prune_state import (
    HealthPolicy,
    PruneCheckpointer,
    PruneDivergence,
    PruneRunState,
    adaptive_rho,
    as_key,
    run_fingerprint,
)
from repro_torch.core.pruner import (
    PrivacyPreservingPruner,
    PruneResult,
    rho_schedule,
)
from repro_torch.core.retrain import make_retrain_step, retrain
from repro_torch.core.schemes import (
    DEFAULT_EXCLUDE,
    LayerSpec,
    PruneConfig,
    build_specs,
    project_tree,
)

__all__ = [
    "ADMMVars", "DEFAULT_EXCLUDE", "HealthPolicy", "LMAdapter", "LayerSpec",
    "PrivacyPreservingPruner", "PruneCheckpointer", "PruneConfig",
    "PruneDivergence", "PruneResult", "PruneRunState", "adaptive_rho",
    "admm_init", "admm_iteration", "admm_task_prune", "apply_mask",
    "as_key", "augmented_penalty", "build_specs", "compression_rate",
    "cross_entropy", "dual_residual", "dual_step", "frobenius_distance",
    "greedy_prune", "layerwise_loss", "make_retrain_step",
    "mask_from_params", "mask_gradients", "per_example_cross_entropy",
    "primal_residual", "primal_step", "project_tree", "proximal_step",
    "retrain", "rho_schedule", "run_fingerprint", "sparsity",
    "whole_model_loss",
]
