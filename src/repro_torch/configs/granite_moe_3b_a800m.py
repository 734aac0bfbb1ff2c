"""granite-moe-3b-a800m — 40 experts top-8 [hf:ibm-granite/granite-3.0],
token-choice routing with group size 2 and "sorted" grouping: the C1
group-multiplexed path with lane fusion. A copy of the reference package's
config of the same name."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    num_layers=32,
    d_model=1536,
    num_heads=24,
    num_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    moe=MoEConfig(
        num_experts=40,
        top_k=8,
        d_expert=512,
        routing="token_choice",
        group_size=2,
        grouping="sorted",
    ),
)

SMOKE = ModelConfig(
    name="granite-moe-smoke",
    family="moe",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=32,
    vocab_size=256,
    dtype="float32",
    moe=MoEConfig(
        num_experts=10,           # deliberately non-power-of-two, like 40
        top_k=2,
        d_expert=32,
        routing="token_choice",
        group_size=2,
        grouping="sorted",
    ),
)
