"""qwen2-moe-a2.7b [moe] — 4 shared + 60 routed experts, top-4
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf].

Expert FFN width 1408; the shared path is one SwiGLU of width 4 x 1408.
The routed experts are (E, D, F) leaves run by plain einsums
(``models/moe.py``)."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=0,
    vocab_size=151_936,
    num_experts=60,
    num_shared_experts=4,
    moe_top_k=4,
    expert_d_ff=1408,
    capacity_factor=1.25,
    remat="full",
)
