"""llama-3.2-vision-90b — cross-attention image layers every 5th layer
[hf:meta-llama/Llama-3.2-Vision]. The vision frontend is a STUB: the
caller provides patch embeddings [B, num_image_tokens, d_model], read as
cross-attention memory. 100 layers = 20 x (4 self + 1 cross). A copy of
the reference package's config of the same name.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    num_layers=100,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    cross_attn_every=5,
    num_image_tokens=1600,
    rope_theta=5e5,
)

SMOKE = ModelConfig(
    name="llama-vision-smoke",
    family="vlm",
    num_layers=4,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=128,
    vocab_size=256,
    cross_attn_every=2,
    num_image_tokens=16,
    dtype="float32",
)
