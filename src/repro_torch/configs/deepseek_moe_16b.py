"""deepseek-moe-16b — fine-grained MoE: 2 shared + 64 routed top-6
[arXiv:2401.06066], token-choice routing with group size 2 and "sorted"
grouping: the C1 group-multiplexed path with lane fusion, plus the
always-on shared experts. A copy of the reference package's config of the
same name (every layer MoE, as there)."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    vocab_size=102400,
    moe=MoEConfig(
        num_experts=64,
        top_k=6,
        d_expert=1408,
        num_shared_experts=2,
        routing="token_choice",
        group_size=2,
        grouping="sorted",
    ),
)

SMOKE = ModelConfig(
    name="deepseek-moe-smoke",
    family="moe",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=32,
    vocab_size=256,
    dtype="float32",
    moe=MoEConfig(
        num_experts=8,
        top_k=2,
        d_expert=32,
        num_shared_experts=1,
        routing="token_choice",
        group_size=2,
        grouping="sorted",
    ),
)
