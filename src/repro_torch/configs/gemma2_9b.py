"""gemma2-9b [dense] — 42L d_model=3584 16H (GQA kv=8) d_ff=14336
vocab=256000, alternating local(4096-window)/global attention, logit
softcapping (attn 50, final 30), GeGLU, head_dim=256.
[arXiv:2408.00118; hf]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b",
    family="dense",
    num_layers=42,
    d_model=3584,
    num_heads=16,
    num_kv_heads=8,
    head_dim=256,
    d_ff=14336,
    vocab_size=256000,
    max_seq_len=8192,
    block_pattern=("local", "attn"),  # sliding-window / global alternation
    sliding_window=4096,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    mlp_activation="geglu",
    rms_offset=True,
    embed_scale=True,
    tie_embeddings=True,
    dtype="bfloat16",
)

SMOKE = CONFIG.replace(
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=32,
    d_ff=256, vocab_size=512, max_seq_len=128, sliding_window=32,
    dtype="float32",
)
