"""whisper-base — encoder-decoder with a STUB conv frontend
[arXiv:2212.04356]. The caller provides frame embeddings [B,
num_audio_frames, d_model] in place of the log-mel conv stem. Encoder:
bidirectional attention; decoder: self-attention, then cross-attention to
the encoded frames. Learned positions (no RoPE). A copy of the reference
package's config of the same name.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="audio",
    num_layers=6,
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    d_ff=2048,
    vocab_size=51865,
    encoder_layers=6,
    num_audio_frames=1500,
)

SMOKE = ModelConfig(
    name="whisper-smoke",
    family="audio",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=128,
    vocab_size=256,
    encoder_layers=2,
    num_audio_frames=16,
    dtype="float32",
)
