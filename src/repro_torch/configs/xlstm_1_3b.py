"""xlstm-1.3b — sLSTM + mLSTM blocks [arXiv:2405.04517].

48L d_model=2048 4H d_ff=0 vocab=50304. xLSTM[7:1]: every 8th block is an
sLSTM (scalar memory), the rest mLSTM (matrix memory). d_ff=0: the m/sLSTM
blocks carry their own up/down projections. A copy of the reference
package's config of the same name.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    block="xlstm",
    slstm_every=8,
)

SMOKE = ModelConfig(
    name="xlstm-smoke",
    family="ssm",
    num_layers=4,
    d_model=64,
    num_heads=2,
    num_kv_heads=2,
    d_ff=0,
    vocab_size=256,
    block="xlstm",
    slstm_every=2,
    dtype="float32",
)
