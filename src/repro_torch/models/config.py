"""Port-side model configuration; the fields of repro.models.config.
ModelConfig that the attn/local decoder-only path reads.

Other block kinds (moe, mamba, xLSTM), encoder-decoder and modality
frontends wait for their slices, and are rejected here.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

from repro_torch.core.spec import DENSE, QuantSpec
from repro_torch.kvq.spec import KVQuantSpec

BLOCK_KINDS = ("attn", "local")


@dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"
    num_layers: int = 2
    d_model: int = 256
    num_heads: int = 4
    num_kv_heads: int = 4
    head_dim: int = 0  # 0 -> d_model // num_heads
    d_ff: int = 1024
    vocab_size: int = 1024
    max_seq_len: int = 4096

    block_pattern: tuple[str, ...] = ("attn",)

    use_rope: bool = True
    rope_theta: float = 10000.0
    attn_chunk: int = 4096  # q-chunked attention above this sequence length
    sliding_window: int = 0  # 'local' blocks attend to this window
    attn_logit_softcap: float = 0.0
    final_logit_softcap: float = 0.0
    qk_norm: bool = False

    mlp_activation: str = "swiglu"  # swiglu | geglu | gelu
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    rms_offset: bool = False  # gemma: (1 + w) scaling
    embed_scale: bool = False  # gemma: embeddings scaled by sqrt(d)
    tie_embeddings: bool = False

    dtype: str = "float32"  # activation compute dtype
    param_dtype: str = "float32"
    quant: QuantSpec = field(default_factory=lambda: DENSE)
    # quantized paged KV pool (None: full precision)
    kv_quant: KVQuantSpec | None = None

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.num_layers % len(self.block_pattern) != 0:
            raise ValueError(
                f"{self.name}: num_layers={self.num_layers} not a multiple of "
                f"block_pattern period {len(self.block_pattern)}")
        if self.num_heads % self.num_kv_heads != 0:
            raise ValueError(f"{self.name}: heads must divide into kv groups")
        bad = [k for k in self.block_pattern if k not in BLOCK_KINDS]
        if bad:
            raise NotImplementedError(
                f"{self.name}: block kinds {bad} are not ported yet "
                f"(supported: {BLOCK_KINDS})")

    def kind(self, layer: int) -> str:
        """Block kind of layer ``layer`` (the pattern repeats)."""
        return self.block_pattern[layer % len(self.block_pattern)]

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
