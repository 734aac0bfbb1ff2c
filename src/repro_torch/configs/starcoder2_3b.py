"""starcoder2-3b — GQA 24/2, RoPE, a 4096-token sliding window on every
layer [arXiv:2402.19173], with the dense SwiGLU MLP. A copy of the
reference package's config of the same name (RMSNorm, no biases, tied
embeddings, as the reference builds it; the published model's GELU MLP
with biases and LayerNorm are not what the reference serves)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b",
    family="dense",
    num_layers=30,
    d_model=3072,
    num_heads=24,
    num_kv_heads=2,
    d_ff=12288,
    vocab_size=49152,
    sliding_window=4096,
    rope_theta=1e5,
)

SMOKE = ModelConfig(
    name="starcoder2-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=128,
    vocab_size=256,
    sliding_window=32,
    dtype="float32",
)
