"""granite-8b — llama-architecture code model [arXiv:2405.04324]: GQA
32/8, global attention, the dense SwiGLU MLP. A copy of the reference
package's config of the same name (tied embeddings, as the reference
builds it)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-8b",
    family="dense",
    num_layers=36,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=49152,
    rope_theta=1e4,
)

SMOKE = ModelConfig(
    name="granite-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=128,
    vocab_size=256,
    dtype="float32",
)
