"""pixtral-12b [vlm] — pixtral-ViT + mistral-nemo decoder
[hf:mistralai/Pixtral-12B-2409; unverified].

The modality front end is a stub: the model takes precomputed patch
embeddings at d_model, and only the 40-layer decoder backbone is
modelled (mistral-nemo geometry: head_dim 128, so attn_dim 4096 !=
d_model 5120)."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b",
    family="vlm",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14_336,
    vocab_size=131_072,
    input_kind="embeddings",
    rope_theta=1_000_000.0,
    ffn_type="swiglu",
    remat="full",
)
