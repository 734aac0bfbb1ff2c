"""llama_moe_4_16 — the paper's own target model (Llama-MoE-4/16,
arXiv:2406.16554): Llama2-7B with every FFN split into 16 experts of
d_expert=688, run with expert-choice routing, group size 2 and the GO cache.
A copy of the reference package's config of the same name."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama_moe_4_16",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,
    d_ff=688,
    vocab_size=32000,
    moe=MoEConfig(
        num_experts=16,
        top_k=4,
        d_expert=688,
        routing="expert_choice",
        group_size=2,
        grouping="sorted",
        go_cache=True,
    ),
)

SMOKE = ModelConfig(
    name="llama-moe-smoke",
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
        routing="expert_choice",
        group_size=2,
        grouping="sorted",
        go_cache=True,
    ),
)
