"""llama4-maverick-400b-a17b [moe] — 48L d_model=5120 40H (GQA kv=8)
d_ff=8192 vocab=202048, MoE 128 experts top-1 + 1 shared, dense/MoE
interleaved every other layer (early-fusion Maverick layout).
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    max_seq_len=4096,
    block_pattern=("attn", "moe"),  # interleave_moe_layer_step = 2
    mlp_activation="swiglu",
    num_experts=128,
    num_experts_per_tok=1,
    moe_d_ff=8192,
    num_shared_experts=1,
    shared_expert_d_ff=8192,
    rope_theta=500000.0,
    qk_norm=True,
    dtype="bfloat16",
    param_dtype="float32",
)

SMOKE = CONFIG.replace(
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, moe_d_ff=128, shared_expert_d_ff=128, num_experts=8,
    vocab_size=512, max_seq_len=128, dtype="float32", capacity_factor=4.0,
)
