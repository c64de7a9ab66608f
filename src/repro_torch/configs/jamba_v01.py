"""jamba-v0.1-52b [hybrid] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536; Mamba:attention 7:1 interleave (attention at index 4 of each
8-layer group), MoE 16 experts top-2 on every other layer.
Mamba-dominated -> runs long_500k (attention layers decode linearly
against their cache).  [arXiv:2403.19887; hf]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=65536,
    max_seq_len=262144,
    block_pattern=("mamba", "mamba_moe", "mamba", "mamba_moe",
                   "attn", "mamba_moe", "mamba", "mamba_moe"),
    mlp_activation="swiglu",
    num_experts=16,
    num_experts_per_tok=2,
    moe_d_ff=14336,
    mamba_d_state=16,
    mamba_expand=2,
    mamba_d_conv=4,
    use_rope=False,  # jamba has no positional encoding
    dtype="bfloat16",
)

SMOKE = CONFIG.replace(
    num_layers=8, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, moe_d_ff=128, num_experts=4, num_experts_per_tok=2,
    vocab_size=512, max_seq_len=128, mamba_chunk=8, dtype="float32",
    capacity_factor=4.0,
)
