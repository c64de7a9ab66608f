"""codeqwen1.5-7b [dense] — 32L d_model=4096 32H MHA (kv=32) d_ff=13440
vocab=92416, SwiGLU, qwen1.5 architecture.
[hf:Qwen/CodeQwen1.5-7B; hf]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="codeqwen1.5-7b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,
    head_dim=128,
    d_ff=13440,
    vocab_size=92416,
    max_seq_len=65536,
    block_pattern=("attn",),
    mlp_activation="swiglu",
    rope_theta=1000000.0,
    dtype="bfloat16",
)

SMOKE = CONFIG.replace(
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
    d_ff=192, vocab_size=512, max_seq_len=128, dtype="float32",
)
