"""Decoder-only model assembly — embeddings, the block stack of any
``BLOCK_KINDS`` mix, dense and paged caches, forward / prefill / decode;
port of repro.models.transformer.

Blocks live in an ``nn.ModuleList`` (one module per layer) where the
reference stacks them ``(G, ...)`` for ``lax.scan``; caches are a list of
per-layer dicts: ``{"k", "v"}`` for an attention layer, the recurrent
state otherwise (``{"ssm", "conv"}`` Mamba, ``{"C", "n", "m", "conv"}``
mLSTM, ``{"h", "c", "n", "m"}`` sLSTM).  Functions take the model as
``params``, like the reference's param trees, and update caches in
place.  The paged pool holds K/V only: recurrent kinds are refused in
paged mode, as in the reference.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch import kvq
from repro_torch.device import resolve
from repro_torch.models import common, layers, mamba, moe, xlstm
from repro_torch.models.config import ModelConfig

ATTENTION_KINDS = ("attn", "local", "moe")


class Block(common.Tree):
    """Pre-norm block: ``ln1``, the sequence mixer (``attn`` for the
    attention kinds, ``mamba`` for ``mamba``/``mamba_moe``), ``ln2`` and
    the FFN (``mlp``, or ``moe`` for ``moe``/``mamba_moe``)."""


def block_init(cfg: ModelConfig, kind: str = "attn", *,
               generator: torch.Generator, device=None, quant=None
               ) -> nn.Module:
    """A block of ``kind``; a ``moe`` or ``mamba_moe`` block's experts are
    drawn and, with ``quant``, quantized one expert at a time
    (``moe.moe_init``)."""
    kw = dict(generator=generator, device=device)
    if kind == "mlstm":
        return xlstm.mlstm_init(cfg, **kw)
    if kind == "slstm":
        return xlstm.slstm_init(cfg, **kw)

    def norm():
        return common.norm_init(cfg.d_model, cfg.norm, device=device)

    def ffn():
        return (dict(moe=moe.moe_init(cfg, quant=quant, **kw))
                if kind in ("moe", "mamba_moe")
                else dict(mlp=common.mlp_init(cfg, cfg.d_ff, **kw)))

    if kind in ("mamba", "mamba_moe"):
        return Block(ln1=norm(), mamba=mamba.mamba_init(cfg, **kw),
                     ln2=norm(), **ffn())
    f = ffn()  # an attention block draws its FFN before its attention
    return Block(ln1=norm(), attn=layers.attn_init(cfg, **kw), ln2=norm(),
                 **f)


def block_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                dtype, *, device=None) -> dict:
    """One layer's decode cache.  ``dtype`` applies to the K/V tensors; a
    recurrent state's conv tail takes the activations' dtype
    (``cfg.dtype``) and the rest of it stays f32, as in the reference.
    ``device="meta"`` gives the shapes and dtypes without storage."""
    if kind in ATTENTION_KINDS:
        shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}
    state_dt = getattr(torch, cfg.dtype)
    if kind in ("mamba", "mamba_moe"):
        return mamba.init_state(cfg, batch, state_dt, device=device)
    if kind == "mlstm":
        return xlstm.mlstm_state(cfg, batch, state_dt, device=device)
    if kind == "slstm":
        return xlstm.slstm_state(cfg, batch, state_dt, device=device)
    raise ValueError(kind)


class Transformer(nn.Module):
    """embedding (vocab, d) f32, final_norm, blocks, and lm_head when the
    embeddings are not tied."""

    def __init__(self, embedding: torch.Tensor, final_norm: common.Norm,
                 blocks: list[Block], lm_head=None):
        super().__init__()
        self.register_buffer("embedding", embedding)
        self.final_norm = final_norm
        self.blocks = nn.ModuleList(blocks)
        if lm_head is not None:
            self.lm_head = lm_head


def init_params(cfg: ModelConfig, *, generator: torch.Generator,
                device=None, quant=None) -> Transformer:
    """Random weights from ``generator`` (which must live on ``device``).

    With ``quant`` (a QuantSpec), every block — and an untied lm_head — is
    quantized by ``quant.quantize_model`` right after it is drawn, so no
    more than one block's dense weights exist at a time (this is how a
    full-width model fits the card); a MoE block's experts, one expert's
    dense weights at a time.  A recurrent block's plain weights (conv,
    dt_proj, A_log, D; the mLSTM's q/k/v and gates; the sLSTM's W and R)
    stay f32.  The caller then serves with
    ``cfg.replace(quant=quant)``.
    """
    from repro_torch.quant import quantize_model

    dev = resolve(device)
    kw = dict(generator=generator, device=dev)
    emb = torch.empty((cfg.vocab_size, cfg.d_model), device=dev)
    nn.init.trunc_normal_(emb, a=-2.0, b=2.0, generator=generator)
    blocks = []
    for layer in range(cfg.num_layers):
        blk = block_init(cfg, cfg.kind(layer), quant=quant, **kw)
        if quant is not None:
            quantize_model(blk, quant)
        blocks.append(blk)
    head = None
    if not cfg.tie_embeddings:
        head = common.linear_init(cfg.d_model, cfg.vocab_size, cfg,
                                  cfg.quant, **kw)
        if quant is not None:
            holder = nn.Module()
            holder.lm_head = head
            quantize_model(holder, quant)
    return Transformer(emb, common.norm_init(cfg.d_model, cfg.norm,
                                             device=dev), blocks, head)


def _ffn(p, cfg: ModelConfig, x):
    """The block's second half: the MLP with the block input riding the
    down projection's fused residual epilogue, or the MoE FFN's output
    added to it (the reference's ``_ffn``)."""
    h = common.norm_apply(p.ln2, x, cfg.norm, rms_offset=cfg.rms_offset)
    if hasattr(p, "moe"):
        y, _ = moe.moe_apply(p.moe, h, cfg)
        return x + y
    return common.mlp_apply(p.mlp, h, cfg, residual=x)


def block_apply(p: nn.Module, cfg: ModelConfig, kind: str, x, positions, *,
                mode: str = "train", cache: dict | None = None, pos=None,
                paged=None):
    """One block.  mode: ``train`` (full sequence, no cache), ``prefill``
    (full sequence, writes the prompt's K/V at 0, or the state after it),
    ``decode`` (one token at ``pos``), ``paged`` (``paged`` =
    (write_slots, view_slots) over the layer's block pool; attention
    kinds only).  An attention block's input rides the out-projection's
    and the down-projection's fused residual epilogues; a recurrent
    block writes its new state into ``cache``.  Returns x."""
    if mode == "paged" and kind not in ATTENTION_KINDS:
        raise NotImplementedError(
            f"paged serving supports attention block kinds only, got {kind!r}")
    if kind not in ATTENTION_KINDS:
        if kind in ("mamba", "mamba_moe"):
            h = common.norm_apply(p.ln1, x, cfg.norm,
                                  rms_offset=cfg.rms_offset)
            y, state = mamba.mamba_apply(p.mamba, cfg, h, state=cache)
            x = _ffn(p, cfg, x + y)
        elif kind == "mlstm":
            x, state = xlstm.mlstm_block_apply(p, cfg, x, state=cache)
        elif kind == "slstm":
            x, state = xlstm.slstm_block_apply(p, cfg, x, state=cache)
        else:
            raise ValueError(kind)
        if cache is not None:
            cache.update(state)
        return x
    window = cfg.sliding_window if kind == "local" else 0
    h = common.norm_apply(p.ln1, x, cfg.norm, rms_offset=cfg.rms_offset)
    if mode == "paged":
        write_slots, view_slots = paged
        x, _ = layers.attn_paged(p.attn, cfg, h, cache, positions,
                                 write_slots, view_slots, window=window,
                                 residual=x)
    elif mode == "decode":
        x, _, _ = layers.attn_decode(p.attn, cfg, h, cache["k"], cache["v"],
                                     pos, window=window, residual=x)
    elif cache is not None:  # prefill
        x, k, v = layers.attn_apply(p.attn, cfg, h, positions, window=window,
                                    return_kv=True, residual=x)
        cache["k"][:, :k.shape[1]] = k.to(cache["k"].dtype)
        cache["v"][:, :v.shape[1]] = v.to(cache["v"].dtype)
    else:
        x = layers.attn_apply(p.attn, cfg, h, positions, window=window,
                              residual=x)
    return _ffn(p, cfg, x)


def _stack_apply(params: Transformer, cfg: ModelConfig, x, positions, *,
                 mode="train", cache=None, pos=None, paged=None):
    for i, blk in enumerate(params.blocks):
        x = block_apply(blk, cfg, cfg.kind(i), x, positions, mode=mode,
                        cache=cache[i] if cache is not None else None,
                        pos=pos, paged=paged)
    return x


def embed_inputs(params: Transformer, cfg: ModelConfig, tokens):
    """tokens (B, S) -> (B, S, d): gathered in f32, scaled by sqrt(d) for
    gemma, then cast to ``cfg.dtype``."""
    x = params.embedding[tokens.long()]
    if cfg.embed_scale:
        x = x * cfg.d_model**0.5
    return x.to(getattr(torch, cfg.dtype))


def logits_from_hidden(params: Transformer, cfg: ModelConfig, x):
    x = common.norm_apply(params.final_norm, x, cfg.norm,
                          rms_offset=cfg.rms_offset)
    if cfg.tie_embeddings:
        logits = torch.matmul(x.to(torch.float32),
                              params.embedding.to(torch.float32).t())
    else:
        logits = common.linear_apply(params.lm_head, x, cfg.quant,
                                     in_dim=cfg.d_model, tag="lm_head"
                                     ).to(torch.float32)
    return common.softcap(logits, cfg.final_logit_softcap)


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, device=device).expand(B, S)


def forward(params: Transformer, cfg: ModelConfig, tokens) -> torch.Tensor:
    """Full-sequence forward: tokens (B, S) -> logits (B, S, V)."""
    B, S = tokens.shape
    x = embed_inputs(params, cfg, tokens)
    x = _stack_apply(params, cfg, x, _positions(B, S, tokens.device))
    return logits_from_hidden(params, cfg, x)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.float32, *, device=None) -> list[dict]:
    """Per-layer decode caches (:func:`block_cache`): dense (batch,
    max_len, Hk, Dh) K/V for an attention layer, the zero recurrent state
    (whose size does not depend on ``max_len``) otherwise."""
    dev = resolve(device)
    return [block_cache(cfg, cfg.kind(i), batch, max_len, dtype, device=dev)
            for i in range(cfg.num_layers)]


def prefill(params: Transformer, cfg: ModelConfig, tokens, cache):
    """Run the prompt, filling ``cache``.  Returns (logits_last (B, V),
    cache)."""
    B, S = tokens.shape
    x = embed_inputs(params, cfg, tokens)
    x = _stack_apply(params, cfg, x, _positions(B, S, tokens.device),
                     mode="prefill", cache=cache)
    return logits_from_hidden(params, cfg, x[:, -1:, :])[:, 0], cache


def init_paged_cache(cfg: ModelConfig, num_blocks: int, block_size: int,
                     dtype=torch.float32, *, device=None,
                     kv_spec=None) -> list[dict]:
    """Per-layer (num_blocks, bs, Hk, Dh) K/V block pools for paged serving;
    sequences own disjoint blocks through host-side block tables.
    ``kv_spec`` (default ``cfg.kv_quant``) lays each pool out as the
    quantized {"k", "k_scale", "v", "v_scale"} of repro_torch.kvq.pool:
    the same block and slot indexing, fewer bytes per token.  Recurrent
    (attention-free) block kinds are not paged: NotImplementedError, as in
    the reference, so the continuous engine refuses their models."""
    for kind in cfg.block_pattern:
        if kind not in ATTENTION_KINDS:
            raise NotImplementedError(
                f"paged KV cache for block kind {kind!r}")
    dev = resolve(device)
    if kv_spec is None:
        kv_spec = cfg.kv_quant
    if kv_spec is not None:
        return [kvq.init_kv_pool(kv_spec, num_blocks, block_size,
                                 cfg.num_kv_heads, cfg.head_dim, device=dev)
                for _ in range(cfg.num_layers)]
    shape = (num_blocks, block_size, cfg.num_kv_heads, cfg.head_dim)
    return [{"k": torch.zeros(shape, dtype=dtype, device=dev),
             "v": torch.zeros(shape, dtype=dtype, device=dev)}
            for _ in range(cfg.num_layers)]


def forward_paged(params: Transformer, cfg: ModelConfig, tokens, pool,
                  positions, write_slots, view_slots):
    """One paged serving step — a prefill chunk (C > 1) or a decode batch
    (C == 1) through the same code.  tokens/positions/write_slots (B, C);
    view_slots (B, W).  Returns (logits (B, C, V), pool)."""
    x = embed_inputs(params, cfg, tokens)
    x = _stack_apply(params, cfg, x, positions, mode="paged", cache=pool,
                     paged=(write_slots, view_slots))
    return logits_from_hidden(params, cfg, x), pool


def decode_step(params: Transformer, cfg: ModelConfig, token, cache, pos):
    """One decode step.  token (B,), pos (B,).  Returns (logits (B, V),
    cache)."""
    x = embed_inputs(params, cfg, token[:, None])
    x = _stack_apply(params, cfg, x, pos[:, None], mode="decode",
                     cache=cache, pos=pos)
    return logits_from_hidden(params, cfg, x)[:, 0], cache
