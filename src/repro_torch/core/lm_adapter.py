"""``SequentialAdapter`` over the LM (mirrors ``repro/core/lm_adapter.py``).

Each transformer block is one prunable stage f_n: its attention and FFN
projections are the computation-intensive GEMMs the paper's CONV layers
stand for. The port's LM keeps ``params["blocks"]`` as a per-layer list,
so ``layer_params`` indexes it and ``with_layer_params`` returns a tree
with a new list (the old tree is left as it was). Synthetic data in the
paper's spirit, no prior knowledge of the client's corpus: uniform token
ids, or N(0, 1) embeddings for a model whose front end is a stub. Every
forward here runs dense weights with autograd, attention on
``blockwise_attention``. ``per_example_loss`` is the hook the
membership-inference report (``privacy/report.py``) reads.

A hybrid (hymba) stage runs its mamba heads beside attention, as its
block does. An xLSTM's grouped blocks have no per-layer stage: its layer
methods raise the reference's ``ValueError`` (``supports_layerwise`` is
False), and it is pruned whole (``PruneConfig(layerwise=False)``, which
reads only ``synthetic_batch`` and ``apply``).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.admm_traditional import per_example_cross_entropy
from repro_torch.core.synthetic import synthetic_embeddings, synthetic_tokens
from repro_torch.models.transformer import LM
from repro_torch.utils.tree import tree_map


@dataclasses.dataclass
class LMAdapter:
    """Layer-wise pruning view of an ``LM``, on the LM's device."""

    model: LM
    seq_len: int = 128

    def __post_init__(self):
        self.num_layers = self.config.num_layers

    @property
    def supports_layerwise(self) -> bool:
        """Whether the layer-wise formulation (problem 3) applies."""
        return self.config.family != "ssm"

    def _require_layerwise(self) -> None:
        if not self.supports_layerwise:
            raise ValueError(
                "xLSTM group-stacked blocks: use whole-model pruning "
                "(PruneConfig(layerwise=False)) with adapter.apply")

    @property
    def config(self) -> ModelConfig:
        return self.model.config

    @property
    def device(self) -> torch.device:
        return self.model.device

    @property
    def synthetic_kind(self) -> str:
        """Which no-prior-knowledge generator feeds the pruner
        (provenance)."""
        return ("uniform_tokens" if self.config.input_kind == "tokens"
                else "normal_embeddings")

    # ---- SequentialAdapter protocol ---------------------------------------

    def synthetic_batch(self, gen: torch.Generator,
                        batch_size: int) -> torch.Tensor:
        cfg = self.config
        if cfg.input_kind == "tokens":
            return synthetic_tokens(gen, batch_size, self.seq_len,
                                    cfg.vocab_size, device=self.device)
        return synthetic_embeddings(gen, batch_size, self.seq_len,
                                    cfg.d_model, device=self.device)

    def embed(self, params, batch):
        return self.model.embed_inputs(params, batch)

    def layer_params(self, params, n: int):
        self._require_layerwise()
        return params["blocks"][n]

    def with_layer_params(self, params, n: int, lp):
        self._require_layerwise()
        blocks = list(params["blocks"])
        blocks[n] = tree_map(lambda new, old: new.to(old.dtype), lp,
                             blocks[n])
        return {**params, "blocks": blocks}

    def apply_layer(self, n: int, lp, x):
        self._require_layerwise()
        return self.model.block(lp, x, self.model.rope(x.shape[1], x.device))

    def apply(self, params, batch):
        """Soft outputs (logits) for problem (2) and evaluation."""
        h, _ = self.model.hidden_states(params, batch)
        return self.model.lm_logits(params, h)

    # ---- privacy-evaluation hooks -----------------------------------------

    def per_example_loss(self, params, inputs: torch.Tensor,
                         labels: torch.Tensor) -> torch.Tensor:
        """Per-sequence mean NLL, (B,), in fp32: the membership signal an
        attack thresholds (``LM.train_loss`` gives only the batch mean)."""
        return per_example_cross_entropy(
            self.apply(params, inputs), labels).mean(dim=-1)
