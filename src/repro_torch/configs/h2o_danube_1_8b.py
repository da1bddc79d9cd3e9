"""h2o-danube-1.8b [dense] — llama+mistral mix with sliding-window attention
[arXiv:2401.16818; hf]. The SWA window makes ``long_500k`` feasible (ring
KV cache of window size)."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b",
    family="dense",
    num_layers=24,
    d_model=2560,
    num_heads=32,
    num_kv_heads=8,
    head_dim=80,
    d_ff=6912,
    vocab_size=32_000,
    sliding_window=4096,
    ffn_type="swiglu",
    remat="full",
)
