"""Config schema: every architecture is a ModelConfig.

A copy of the reference package's schema, cut to the fields the port's
slices read (the attention family with its QKV bias, local/global window
pattern and attention logit softcap; the xlstm family; the Mamba2 hybrid
(zamba2); the cross-attention families (whisper's encoder-decoder,
llama-vision's cross layers); tied embeddings;
the int8 decode state; the balance-loss coefficient, `remat` and
`TrainConfig` for training).
Plain dataclasses: no torch, no JAX.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-Experts layer configuration."""

    num_experts: int
    top_k: int
    d_expert: int                     # hidden width of each expert FFN
    num_shared_experts: int = 0       # deepseek-style always-on experts
    routing: str = "token_choice"     # "token_choice" | "expert_choice"
    group_size: int = 1               # experts per multiplexed lane (C1)
    grouping: str = "sorted"          # "uniform" | "sorted" (C2)
    capacity_factor: float = 1.25     # token-choice expert capacity
    balance_coef: float = 0.01        # aux balance-loss coefficient (training)
    use_grouped_gemm: bool = True     # group-multiplexed execution path (C1)
    # "auto" and "pallas" both run the grouped-GEMM decomposition: the
    # hand-written kernels on a CUDA tensor, their plain versions on a CPU
    # tensor. "xla" is the masked, capacity-padded einsum realization, the
    # one autograd trains through (loss_fn pins "auto" to it).
    backend: str = "auto"             # "auto" | "xla" | "pallas"
    gmm_block_rows: int = 0           # row-tile height (0 = per device)
    go_cache: bool = True             # gate-output cache for EC decode


@dataclass(frozen=True)
class ModelConfig:
    """A single architecture."""

    name: str
    family: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                 # 0 -> d_model // num_heads
    block: str = "attn"
    moe: Optional[MoEConfig] = None
    qkv_bias: bool = False            # qwen2
    rope_theta: float = 10000.0
    sliding_window: int = 0           # >0 enables local attention layers
    local_global_ratio: int = 0       # gemma3: N local layers per 1 global
    logit_softcap: float = 0.0        # >0: scores c * tanh(s / c)
    ssm_state: int = 0                # mamba2 state size (zamba2: 64)
    ssm_chunk: int = 128              # SSD chunk length
    attn_every: int = 0               # zamba2: shared attn block every N layers
    slstm_every: int = 0              # xlstm: one sLSTM block every N layers
    conv_width: int = 4               # mLSTM and mamba2 short causal conv
    cross_attn_every: int = 0         # llama-vision: cross-attn layer cadence
    num_image_tokens: int = 0         # stub patch-embedding count
    encoder_layers: int = 0           # whisper: >0 -> encoder-decoder
    num_audio_frames: int = 0         # stub frame-embedding count
    dtype: str = "bfloat16"
    norm_eps: float = 1e-6

    # --- serving: quantized decode state (paged pools only) ---
    # "int8" stores KV pages as int8 with per-page, per-kv-head amax scales
    # (f32 [L, NP, Hkv]) and GO rows as int8 with per-row scales — bytes per
    # resident token drop ~4x vs the fp32 smoke dtype (~2x vs bf16) while
    # attention compute stays fp32 (dequantized in-kernel / at the gather).
    # The enum leaves room for fp8 once hardware dtypes land. "none" keeps
    # the full-precision pages. Quantized mode REQUIRES a paged pool — scale
    # granularity is page granularity (core/quant.py).
    kv_quant: str = "none"            # "none" | "int8"

    # training: each layer (and each cross-entropy chunk) recomputes its
    # forward in the backward pass instead of keeping its activations
    remat: bool = True

    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    def with_overrides(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class TrainConfig:
    """End-to-end training-run knobs for launch/train.py."""

    steps: int = 100
    seq_len: int = 512
    global_batch: int = 8
    lr: float = 3e-4
    warmup_steps: int = 20
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    seed: int = 0
    ckpt_dir: str = "/tmp/repro_ckpt"
    ckpt_every: int = 50
    log_every: int = 10
    microbatch: int = 0               # >0 enables gradient accumulation
