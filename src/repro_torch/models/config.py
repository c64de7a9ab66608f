"""Port-side model configuration; the fields of repro.models.config.
ModelConfig that the decoder-only path reads, ``num_groups``,
``with_quant`` and the analytic :func:`param_count`.  Block kinds:

    'attn'       global self-attention + MLP
    'local'      sliding-window self-attention + MLP
    'moe'        self-attention + MoE FFN
    'mamba'      Mamba-1 selective-scan block + MLP       (jamba)
    'mamba_moe'  Mamba block + MoE FFN                    (jamba)
    'mlstm'      xLSTM matrix-memory block                (xlstm)
    'slstm'      xLSTM scalar-memory block                (xlstm)

An encoder-decoder config (whisper) has ``encoder_layers`` > 0: that many
non-causal 'attn' blocks over the source frames, and a cross attention in
every decoder block.  A vision config (phi-3-vision) has ``frontend`` =
'image_patches': ``num_patches`` precomputed patch embeddings prepended
to the text.  Both frontends are stubs, as in the reference: the inputs
are embeddings, not audio or pixels.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

from repro_torch.core.spec import DENSE, QuantSpec
from repro_torch.kvq.spec import KVQuantSpec

BLOCK_KINDS = ("attn", "local", "moe", "mamba", "mamba_moe", "mlstm",
               "slstm")


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

    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_d_ff: int = 0  # per-expert hidden dim (0 -> d_ff)
    num_shared_experts: int = 0
    shared_expert_d_ff: int = 0
    capacity_factor: float = 1.25
    router_aux_loss: float = 0.0
    moe_groups: int = 16  # the reference's dispatch groups (sharding only)

    # Mamba (jamba)
    mamba_d_state: int = 16
    mamba_expand: int = 2
    mamba_d_conv: int = 4
    mamba_dt_rank: int = 0  # 0 -> ceil(d_model / 16)
    mamba_chunk: int = 128

    # xLSTM
    xlstm_proj_factor: float = 2.0
    slstm_mlp_factor: float = 4 / 3
    xlstm_conv: int = 4
    xlstm_chunk: int = 128
    xlstm_parallel: bool = True  # chunkwise-parallel mLSTM for prefill

    # encoder-decoder (whisper)
    encoder_layers: int = 0
    max_source_len: int = 0  # encoder positions (frames)

    # modality frontend stubs (precomputed embeddings)
    frontend: str = ""  # '' | 'audio_frames' | 'image_patches'
    num_patches: int = 0  # vlm: patch tokens prepended to text

    dtype: str = "float32"  # activation compute dtype
    param_dtype: str = "float32"
    # training: recompute each block-pattern group's activations in the
    # backward pass; 'nothing' saves only the group's input, 'dots' also
    # the linears' outputs (models.common.remat).  Serving never remats.
    remat: bool = True
    remat_policy: str = "nothing"  # nothing | dots
    # training on a mesh (distributed.sharding.constrain_params): gather
    # each group's FSDP ('data'-sharded) weights in int8, one scale a leaf
    # (the pmax of the shards' max |w|), dequantized after the gather
    fsdp_int8_gather: bool = False
    # keep each group's gathered weights for the backward pass, so remat
    # does not gather them again (more memory: one group's weights)
    save_gathered_weights: bool = False
    logical_rules: str = "default"  # distributed.sharding.RULE_SETS key
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

    @property
    def num_groups(self) -> int:
        """How many times the block pattern repeats."""
        return self.num_layers // len(self.block_pattern)

    @property
    def dt_rank(self) -> int:
        return self.mamba_dt_rank or -(-self.d_model // 16)

    @property
    def mamba_d_inner(self) -> int:
        return self.mamba_expand * self.d_model

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def attention_free(self) -> bool:
        return not any(k in ("attn", "local", "moe")
                       for k in self.block_pattern)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def with_quant(self, mode: str, **kw) -> "ModelConfig":
        return self.replace(quant=dataclasses.replace(self.quant, mode=mode,
                                                      **kw))


def param_count(cfg: ModelConfig) -> dict:
    """Analytic parameter counts, total and active per token; the
    reference's formulas."""
    d, dff = cfg.d_model, cfg.d_ff
    h, hk, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    embed = cfg.vocab_size * d * (1 if cfg.tie_embeddings else 2)
    attn = d * (h * dh) + 2 * d * (hk * dh) + (h * dh) * d

    def mlp(ff):
        return (3 if cfg.mlp_activation in ("swiglu", "geglu") else 2) \
            * d * ff

    def mamba():
        di, n, dr = cfg.mamba_d_inner, cfg.mamba_d_state, cfg.dt_rank
        return (d * 2 * di + cfg.mamba_d_conv * di + di * (dr + 2 * n)
                + dr * di + di * n + di + di * d)

    def mlstm():
        di = int(d * cfg.xlstm_proj_factor)
        dh_ = di // h
        # up(2x) + block-diag q/k/v + scalar i/f gates + o gate + conv + down
        return (d * 2 * di + 3 * h * dh_ * dh_ + 2 * h * di + d * di
                + cfg.xlstm_conv * di + di * d)

    def slstm():
        # 4 gates x (input W + recurrent R) + GeGLU MLP
        return 4 * (d * d + d * d) + 3 * d * int(d * cfg.slstm_mlp_factor)

    total = active = embed
    mdff = cfg.moe_d_ff or dff
    for kind in cfg.block_pattern:
        if kind in ("attn", "local"):
            p = a = attn + mlp(dff)
        elif kind == "mamba":
            p = a = mamba() + mlp(dff)
        elif kind == "mamba_moe":
            router = d * cfg.num_experts
            p = mamba() + cfg.num_experts * mlp(mdff) + router
            a = mamba() + cfg.num_experts_per_tok * mlp(mdff) + router
        elif kind == "mlstm":
            p = a = mlstm()
        elif kind == "slstm":
            p = a = slstm()
        else:  # moe
            # shared experts fuse into one dense MLP of summed hidden dim
            shared = (mlp(cfg.shared_expert_d_ff
                          or cfg.num_shared_experts * mdff)
                      if cfg.num_shared_experts else 0)
            router = d * cfg.num_experts
            p = attn + cfg.num_experts * mlp(mdff) + shared + router
            a = attn + router + shared + cfg.num_experts_per_tok * mlp(mdff)
        total += p * cfg.num_groups
        active += a * cfg.num_groups
    if cfg.encoder_layers:
        # the encoder's blocks and every decoder block's cross attention
        extra = cfg.encoder_layers * (attn + mlp(dff)) + cfg.num_layers * attn
        total += extra
        active += extra
    return {"total": total, "active": active}
