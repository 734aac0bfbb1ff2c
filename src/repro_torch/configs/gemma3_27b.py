"""gemma3-27b — 5:1 local:global attention, 128k context [hf:google/gemma-3].

62 layers in a repeating pattern of 5 local layers (a 1024-token sliding
window) and 1 global one (models/model.py:layer_windows); head_dim fixed
at 128, not d_model / num_heads (168). A copy of the reference package's
config of the same name: the dense SwiGLU MLP, pre-RMSNorm blocks and tied
embeddings, as the reference builds it (the published model's GeGLU,
QK-norm and post-norms are not what the reference serves).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-27b",
    family="dense",
    num_layers=62,
    d_model=5376,
    num_heads=32,
    num_kv_heads=16,
    d_ff=21504,
    vocab_size=262144,
    head_dim=128,
    sliding_window=1024,
    local_global_ratio=5,
    rope_theta=1e6,
)

SMOKE = ModelConfig(
    name="gemma3-smoke",
    family="dense",
    num_layers=3,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=128,
    vocab_size=256,
    head_dim=16,
    sliding_window=16,
    local_global_ratio=2,
    dtype="float32",
)
