"""Model configuration dataclass (copied from ``repro/configs/base.py``)."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture config. One instance per assigned arch (configs/<id>.py)."""

    name: str
    family: str                      # dense | ssm | vlm | hybrid | audio | moe
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 → d_model // num_heads

    # attention options
    qkv_bias: bool = False
    sliding_window: Optional[int] = None     # SWA window (tokens)
    global_attn_every: int = 0               # hybrid SWA: 1 global layer per N
    rope_theta: float = 10_000.0
    causal: bool = True                      # False → encoder (bidirectional)

    # FFN
    ffn_type: str = "swiglu"                 # swiglu | gelu

    # MoE
    num_experts: int = 0
    num_shared_experts: int = 0
    moe_top_k: int = 0
    expert_d_ff: int = 0
    capacity_factor: float = 1.25

    # SSM / recurrent (xLSTM, hymba's mamba heads)
    ssm_state: int = 0
    slstm_every: int = 0                     # xLSTM: one sLSTM per N blocks
    mamba_heads: int = 0                     # hymba: parallel SSM heads
    mamba_head_dim: int = 0
    conv_kernel: int = 4

    # IO
    input_kind: str = "tokens"               # tokens | embeddings
    encoder_only: bool = False
    tie_embeddings: bool = False

    norm_eps: float = 1e-5
    param_dtype: str = "bfloat16"
    scan_layers: bool = True
    remat: str = "none"                      # none | full | dots_saveable

    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    @property
    def attn_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        D, F, V, L = self.d_model, self.d_ff, self.vocab_size, self.num_layers
        per_block = 0
        per_block += D * self.attn_dim + 2 * D * self.kv_dim + self.attn_dim * D
        if self.qkv_bias:
            per_block += self.attn_dim + 2 * self.kv_dim
        if self.num_experts:
            fe = self.expert_d_ff
            per_block += D * self.num_experts                       # router
            per_block += self.num_experts * 3 * D * fe              # routed
            per_block += self.num_shared_experts * 3 * D * fe       # shared
        elif F:
            n_mats = 3 if self.ffn_type == "swiglu" else 2
            per_block += n_mats * D * F
        per_block += 2 * D                                          # norms
        embed = V * D
        head = 0 if self.tie_embeddings else V * D
        if self.input_kind == "embeddings":
            embed = 0
        if self.encoder_only:
            head = V * D  # small prediction head
        return embed + L * per_block + head

    def active_param_count(self) -> int:
        """Active params per token (MoE: shared + top-k routed only)."""
        if not self.num_experts:
            return self.param_count()
        D, L = self.d_model, self.num_layers
        fe = self.expert_d_ff
        dense = self.param_count() - L * self.num_experts * 3 * D * fe
        active = L * self.moe_top_k * 3 * D * fe
        return dense + active
