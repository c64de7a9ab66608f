"""gemma-2b [dense] — 18L d_model=2048 8H MQA (kv=1) d_ff=16384
vocab=256000, GeGLU, head_dim=256, RMSNorm with (1+w) offset, embeddings
scaled by sqrt(d) and tied with the LM head.  [arXiv:2403.08295; hf]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b",
    family="dense",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=256000,
    max_seq_len=8192,
    block_pattern=("attn",),
    mlp_activation="geglu",
    rms_offset=True,
    embed_scale=True,
    tie_embeddings=True,
    dtype="bfloat16",
)

SMOKE = CONFIG.replace(
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=1, head_dim=32,
    d_ff=256, vocab_size=512, max_seq_len=128, dtype="float32",
)
