"""Per-layer pruning specs (mirrors ``repro/core/schemes.py``).

Prunable tensors are chosen by path pattern over the parameter tree;
biases, norms and embeddings stay dense. Patterns match the reference's
stacked paths (``blocks/attn/wq``), so one ``PruneConfig`` selects the same
tensors in both packages (see ``utils.tree.reference_path``).

A 3-D leaf of a layer (a MoE layer's stacked experts, (E, D, F)) is
projected onto one of two sets, each as the reference projects it:
``project_tree`` of a whole tree takes it whole, (E, D * F) in the
paper's view, as the reference's vmap over the stacked layer axis hands
it to the projection; ``project_tree`` of one layer's tree (a layer-wise
ADMM update) takes it expert by expert, as the reference's vmap over its
first axis does. An xLSTM group's mLSTM leaf ((per - 1, D, F) under
``blocks/<g>/mlstm/``) is projected whole too, as (per - 1, D * F): the
reference's vmap runs over its group axis only. So ``tile_pattern``
refuses it (per - 1 is no multiple of block_p) wherever the reference's
does.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.core import projections
from repro_torch.utils.tree import (
    is_layer_path,
    reference_path,
    tree_map_with_path,
)

DEFAULT_EXCLUDE = (
    r".*bias.*",
    r".*norm.*",
    r".*scale.*",
    r".*embed.*",
    # \b keeps `lm_head` (a plain GEMM leaf) prunable
    r".*\bhead\b.*",
    r".*router.*",
    r".*gate_logit.*",
    r".*pos_emb.*",
    r".*\bb\b.*",
    r".*/b[qkv]",           # attention QKV biases (qwen2-style)
    r".*conv.*",
    r".*a_log.*",
    r".*dt_bias.*",
    r".*d_skip.*",
    r".*r_gates.*",
    r".*b_gates.*",
    r".*b_if.*",
    r".*out_norm.*",
)


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """Pruning spec for a single prunable tensor."""

    scheme: str = "irregular"
    alpha: float = 0.25
    conv_shape: Optional[Tuple[int, int, int, int]] = None
    column_group: int = 1
    tile_block_p: int = 128
    tile_group_q: int = 8
    tile_keep: int = 4
    pattern_keep: int = 4

    def project(self, w: torch.Tensor) -> torch.Tensor:
        # the projections take the paper's (out, in) view; model GEMM
        # leaves are stored (in, out) for y = x @ w, so 2-D leaves are
        # presented transposed and the result is laid back out (in, out)
        if w.ndim == 2 and self.conv_shape is None:
            return self._project_pq(w.T).T.contiguous()
        return self._project_pq(w)

    def _project_pq(self, w: torch.Tensor) -> torch.Tensor:
        if self.scheme == "column":
            return projections.project_column(w, alpha=self.alpha,
                                              group=self.column_group)
        if self.scheme == "tile_pattern":
            return projections.project_tile_pattern(
                w, block_p=self.tile_block_p, group_q=self.tile_group_q,
                keep=self.tile_keep)
        return projections.project(w, self.scheme, alpha=self.alpha,
                                   conv_shape=self.conv_shape,
                                   keep=self.pattern_keep)


@dataclasses.dataclass(frozen=True)
class PruneConfig:
    """Which tensors are pruned, and how (global default + overrides),
    and the ADMM hyper-parameters of the privacy-preserving pruner."""

    scheme: str = "irregular"
    alpha: float = 0.25
    exclude: Sequence[str] = DEFAULT_EXCLUDE
    overrides: Dict[str, Dict[str, Any]] = dataclasses.field(
        default_factory=dict)
    # ADMM hyper-parameters (paper section V-A)
    rho_init: float = 1e-4
    rho_max: float = 1e-1
    rho_mult: float = 10.0
    rho_every_iters: int = 110     # "x10 every 11 epochs", 10 iterations each
    lr: float = 1e-3
    batch_size: int = 32
    iterations: int = 300
    primal_steps: int = 1
    layerwise: bool = True         # problem (3) against problem (2)

    def spec_for(self, path: str, shape) -> Optional[LayerSpec]:
        """LayerSpec for a (reference-style) path, or None if excluded."""
        if len(shape) < 2:
            return None
        for pat in self.exclude:
            if re.fullmatch(pat, path):
                return None
        kw: Dict[str, Any] = dict(scheme=self.scheme, alpha=self.alpha)
        for pat, ov in self.overrides.items():
            if re.fullmatch(pat, path):
                kw.update(ov)
        if kw["scheme"] in projections.KERNEL_SCHEMES:
            if len(shape) == 4:
                kw.setdefault("conv_shape", tuple(shape))
            elif "conv_shape" not in kw:
                kw["scheme"] = "tile_pattern"
        return LayerSpec(**kw)


def build_specs(params: Any, config: PruneConfig) -> Any:
    """Tree of LayerSpec | None congruent with ``params``."""
    return tree_map_with_path(
        lambda path, w: config.spec_for(reference_path(path), w.shape),
        params)


def _project_leaf(w: torch.Tensor, spec: Optional[LayerSpec],
                  in_layer: bool = False) -> torch.Tensor:
    if spec is None:
        return w
    if in_layer:
        # one layer of the reference's stacked leaf: its vmap over the
        # layer axis hands the projection this slice whole
        return spec.project(w)
    if (spec.conv_shape is None and w.ndim > 2
            and spec.scheme not in projections.KERNEL_SCHEMES):
        # a >2-D leaf under a GEMM scheme (a conv weight pruned by column,
        # say) is projected slice by slice along its first axis, as the
        # reference's vmap over a stacked leaf does
        return torch.stack([spec.project(s) for s in w.unbind(0)])
    return spec.project(w)


def project_tree(params: Any, specs: Any) -> Any:
    """Project every prunable leaf onto its set (spec None: identity).
    A leaf under ``blocks/<l>/`` is projected whole; any other >2-D leaf
    under a GEMM scheme, slice by slice along its first axis."""
    return tree_map_with_path(
        lambda path, w, spec: _project_leaf(w, spec, is_layer_path(path)),
        params, specs)
