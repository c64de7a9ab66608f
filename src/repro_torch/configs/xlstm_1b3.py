"""xlstm-1.3b [ssm] — 48 blocks d_model=2048, 4 heads, vocab=50304;
xLSTM[7:1] layout = 7 mLSTM (matrix memory) : 1 sLSTM (scalar memory,
memory mixing) per 8-block group.  Attention-free -> runs long_500k.
``head_dim`` is the config's attention field only: the mLSTM's head size
is ``d_model * xlstm_proj_factor // num_heads`` (1024).
[arXiv:2405.04517; unverified]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=4,
    num_kv_heads=4,
    head_dim=512,
    d_ff=0,  # blocks carry their own projections (factor 2 / MLP 4/3)
    vocab_size=50304,
    max_seq_len=4096,
    block_pattern=("mlstm",) * 7 + ("slstm",),
    xlstm_proj_factor=2.0,
    slstm_mlp_factor=4 / 3,
    norm="layernorm",
    dtype="bfloat16",
)

SMOKE = CONFIG.replace(
    num_layers=8, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
    vocab_size=512, max_seq_len=128, dtype="float32",
)
