"""xlstm-1.3b [ssm] — sLSTM + mLSTM blocks [arXiv:2405.04517; unverified].

48 blocks arranged xLSTM[7:1]-style: every 8th block is an sLSTM
(scalar-memory, sequential), the rest mLSTM (matrix-memory, chunkwise-
parallel). 4 heads → head_dim 512 matrix memories. d_ff=0 per assignment:
the (m/s)LSTM blocks have internal up/down projections, no separate FFN.
O(1)-state decode. Copied from ``repro/configs/xlstm_1_3b.py``."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=4,
    num_kv_heads=4,
    head_dim=512,
    d_ff=0,
    vocab_size=50_304,
    slstm_every=8,
    conv_kernel=4,
    remat="full",
)
