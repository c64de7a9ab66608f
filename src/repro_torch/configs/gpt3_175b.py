"""gpt3-175b — the paper's own evaluation model (§5): its MLP GeMMs are
the 12288x49152 / 49152x12288 pair of Eqs. 16-21 (Fig. 3).  Not part of
the assigned pool; provided so the paper's exact shapes are selectable
for dry-runs/benchmarks (quantized serving is the paper's scenario).
[arXiv:2005.14165]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gpt3-175b",
    family="dense",
    num_layers=96,
    d_model=12288,
    num_heads=96,
    num_kv_heads=96,
    head_dim=128,
    d_ff=49152,
    vocab_size=50304,  # padded (original 50257)
    max_seq_len=2048,
    block_pattern=("attn",),
    mlp_activation="gelu",
    norm="layernorm",
    use_rope=False,  # learned positions in the original; stubbed via rope
    dtype="bfloat16",
)

SMOKE = CONFIG.replace(
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
    d_ff=256, vocab_size=512, max_seq_len=128, dtype="float32",
)
