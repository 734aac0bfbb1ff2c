"""qwen2-7b — GQA 28/4 (seven query heads a kv head) with QKV bias
[arXiv:2407.10671], the dense SwiGLU MLP. A copy of the reference
package's config of the same name (RMSNorm, tied embeddings, as the
reference builds it; the published Qwen2-7B unties its output head)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-7b",
    family="dense",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    d_ff=18944,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1e6,
)

SMOKE = ModelConfig(
    name="qwen2-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=128,
    vocab_size=256,
    qkv_bias=True,
    dtype="float32",
)
