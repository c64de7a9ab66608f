"""phi-3-vision-4.2b [vlm] — phi3-mini backbone: 32L d_model=3072 32H MHA
(kv=32) d_ff=8192 vocab=32064, SwiGLU; CLIP vision frontend STUBBED per
the assignment (input_specs provides precomputed patch embeddings, 576
patches prepended to the text tokens).
[hf:microsoft/Phi-3-vision-128k-instruct; hf]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    num_layers=32,
    d_model=3072,
    num_heads=32,
    num_kv_heads=32,
    head_dim=96,
    d_ff=8192,
    vocab_size=32064,
    max_seq_len=131072,
    block_pattern=("attn",),
    mlp_activation="swiglu",
    frontend="image_patches",
    num_patches=576,  # CLIP-L/14 @ 336px
    dtype="bfloat16",
)

SMOKE = CONFIG.replace(
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=512, max_seq_len=128, num_patches=8,
    dtype="float32",
)
