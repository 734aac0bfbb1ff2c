"""zamba2-1.2b — Mamba2 backbone + weight-shared attention block
[arXiv:2411.15242]. 38 Mamba2 layers; the shared attention(+MLP) block is
applied after every 6th layer (6 applications, each with its own KV cache).
A copy of the reference package's config of the same name.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=32000,
    block="mamba2",
    ssm_state=64,
    attn_every=6,
)

SMOKE = ModelConfig(
    name="zamba2-smoke",
    family="hybrid",
    num_layers=4,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=128,
    vocab_size=256,
    block="mamba2",
    ssm_state=16,
    attn_every=2,
    dtype="float32",
)
