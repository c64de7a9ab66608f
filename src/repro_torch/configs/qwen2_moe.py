"""qwen2-moe-a2.7b [moe] — 24L d_model=2048 16H (kv=16) per-expert
d_ff=1408 vocab=151936; 60 routed experts top-4 + 4 shared experts
(fused shared hidden 4x1408=5632).  [hf:Qwen/Qwen1.5-MoE-A2.7B; hf]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=151936,
    max_seq_len=4096,
    block_pattern=("moe",),  # every layer MoE
    mlp_activation="swiglu",
    num_experts=60,
    num_experts_per_tok=4,
    moe_d_ff=1408,
    num_shared_experts=4,
    shared_expert_d_ff=5632,
    rope_theta=1000000.0,
    dtype="bfloat16",
)

SMOKE = CONFIG.replace(
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
    d_ff=32, moe_d_ff=32, shared_expert_d_ff=128, num_experts=6,
    num_experts_per_tok=2, vocab_size=512, max_seq_len=128,
    dtype="float32", capacity_factor=4.0,
)
