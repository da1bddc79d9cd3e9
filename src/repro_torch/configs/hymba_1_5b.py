"""hymba-1.5b [hybrid] — parallel attention + mamba heads in every layer
[arXiv:2411.13676; hf].

25 attention heads × 64 (GQA kv=5) in parallel with 25 mamba heads × 64
(d_inner = 1600 = d_model), outputs mean-fused, then SwiGLU FFN. Every
layer's attention is sliding-window, as in the reference (the paper keeps
3 global layers); long-context reach comes from the SSM path. Copied from
``repro/configs/hymba_1_5b.py``."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32_001,
    sliding_window=2048,
    ssm_state=16,
    mamba_heads=25,
    mamba_head_dim=64,
    conv_kernel=4,
    ffn_type="swiglu",
    remat="full",
)
