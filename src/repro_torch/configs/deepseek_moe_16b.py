"""deepseek-moe-16b [moe] — 2 shared + 64 routed fine-grained experts, top-6
[arXiv:2401.06066; hf].

Fine-grained experts of width 1408 (= standard FFN / 4). As in the
reference, DeepSeek's dense layer-0 FFN is modelled as MoE like every
other layer."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=0,
    vocab_size=102_400,
    num_experts=64,
    num_shared_experts=2,
    moe_top_k=6,
    expert_d_ff=1408,
    capacity_factor=1.25,
    remat="full",
)
