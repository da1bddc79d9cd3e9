"""hubert-xlarge [audio] — encoder-only, w2v2 architecture
[arXiv:2106.07447; unverified].

Backbone only: the conv feature extractor is a stub, the model takes
precomputed frame embeddings at d_model. Bidirectional attention (kv 16
== heads: plain MHA), GELU FFN, masked-unit prediction head over the
504-unit codebook. Encoder-only: it has no decode path."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="audio",
    num_layers=48,
    d_model=1280,
    num_heads=16,
    num_kv_heads=16,
    head_dim=80,
    d_ff=5120,
    vocab_size=504,
    causal=False,
    encoder_only=True,
    input_kind="embeddings",
    ffn_type="gelu",
    remat="full",
)
