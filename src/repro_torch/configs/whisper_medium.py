"""whisper-medium [audio] — encoder-decoder, 24L decoder + 24L encoder,
d_model=1024 16H (kv=16) d_ff=4096 vocab=51865 (padded to 51968 for even
sharding), conv frontend STUBBED per the assignment (input_specs provides
precomputed frame embeddings), GELU MLP, LayerNorm, absolute positions
(sinusoidal encoder / learned decoder) — no RoPE.
[arXiv:2212.04356; unverified]"""

from repro_torch.models.config import ModelConfig

VOCAB_RAW = 51865  # padded below; logits beyond 51865 are never labeled

CONFIG = ModelConfig(
    name="whisper-medium",
    family="audio",
    num_layers=24,
    encoder_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=51968,  # 51865 padded to a multiple of 256
    max_seq_len=448,  # decoder positions (whisper max target length)
    max_source_len=32768,  # encoder frames for the prefill_32k cell
    block_pattern=("attn",),
    mlp_activation="gelu",
    norm="layernorm",
    use_rope=False,
    frontend="audio_frames",
    dtype="bfloat16",
)

SMOKE = CONFIG.replace(
    num_layers=2, encoder_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
    head_dim=16, d_ff=128, vocab_size=512, max_seq_len=64, max_source_len=32,
    dtype="float32",
)
