"""Serving runtime over the port's model; port of repro.runtime.serve.

Two cache layouts share the model code:

* static — dense (batch, max_len, ...) caches, fixed batch
  (``init_cache`` / ``prefill_step`` / ``decode_step`` / ``generate``);
* paged  — a shared block pool + per-sequence view indices
  (``init_paged_cache`` / ``paged_step``), driven by
  ``repro_torch.serving.Engine``.

``paged_step`` is phase-agnostic: a prefill chunk is a (1, C) call and a
decode batch a (B, 1) call of the same function.  ``generate`` is greedy;
:func:`sample` draws from an explicit ``torch.Generator`` (the reference
draws with a ``jax.random`` key, so the two give different numbers from
one seed).  The serving engine samples on the host with the reference's
numpy draws instead, so its sampled tokens match the reference's.
"""

from __future__ import annotations

import torch

from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.float32, *, device=None):
    return transformer.init_cache(cfg, batch, max_len, dtype, device=device)


def prefill_step(params, cfg: ModelConfig, batch, cache):
    """Prompt ingestion; ``batch`` as ``transformer.prefill`` takes it.
    Returns (last logits, cache)."""
    return transformer.prefill(params, cfg, batch, cache)


def decode_step(params, cfg: ModelConfig, token, cache, pos):
    return transformer.decode_step(params, cfg, token, cache, pos)


def init_paged_cache(cfg: ModelConfig, num_blocks: int, block_size: int,
                     dtype=torch.float32, *, device=None, kv_spec=None):
    """Paged KV block pool; ``kv_spec`` (default ``cfg.kv_quant``) selects
    the quantized codes + scales layout (repro_torch.kvq)."""
    return transformer.init_paged_cache(cfg, num_blocks, block_size, dtype,
                                        device=device, kv_spec=kv_spec)


def paged_step(params, cfg: ModelConfig, tokens, pool, positions,
               write_slots, view_slots, last_idx):
    """One serving step over the paged pool.  ``last_idx`` (B,) picks the
    chunk position whose next-token logits each row returns.
    Returns (logits (B, V), pool)."""
    logits, pool = transformer.forward_paged(
        params, cfg, tokens, pool, positions, write_slots, view_slots)
    rows = torch.arange(logits.shape[0], device=logits.device)
    return logits[rows, last_idx.long()], pool


def greedy(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1).to(torch.int32)


def sample(logits: torch.Tensor, generator: torch.Generator | None = None,
           temperature: float = 1.0) -> torch.Tensor:
    """Greedy at temperature 0, else one draw per row of ``logits`` (..., V)
    from softmax(logits / temperature), int32 of shape (...)."""
    if temperature == 0.0:
        return greedy(logits)
    probs = torch.softmax(logits.to(torch.float32) / temperature, dim=-1)
    draw = torch.multinomial(probs.reshape(-1, probs.shape[-1]), 1,
                             generator=generator)
    return draw.reshape(probs.shape[:-1]).to(torch.int32)


def decode_positions(cfg: ModelConfig, batch: int, seq_len: int, *,
                     device=None) -> torch.Tensor:
    """Positions (batch,) int32 of a decode_step at context length
    ``seq_len``."""
    return torch.full((batch,), seq_len - 1, dtype=torch.int32,
                      device=device)


def static_cache(cfg: ModelConfig, batch, max_new_tokens: int, *,
                 max_len: int | None = None, cache_dtype=torch.float32):
    """(cache, pos0) of a static generation of ``max_new_tokens`` over
    ``batch`` (as :func:`generate` takes it): the dense cache on the
    tokens' device and the first decode position.

    A vision frontend's ``num_patches`` count in the cache length and in
    ``pos0``.  An encoder-decoder config's cross K/V are allocated at the
    frames' length (the reference allocates them at ``max_source_len``
    and prefill replaces them, which at whisper's 32768 would be 25.8 GB
    of zeros at B = 4 with an f32 cache), and its last decode position,
    ``pos0 + max_new_tokens - 2``, is checked here against its learned
    positions, once, so that no decode step syncs to check its own."""
    batch = transformer.as_batch(batch)
    tokens = batch["tokens"]
    B, S = tokens.shape
    extra = cfg.num_patches if cfg.frontend == "image_patches" else 0
    pos0 = S + extra
    max_len = max_len or (pos0 + max_new_tokens)
    if cfg.is_encdec:
        transformer._check_positions(cfg, pos0 + max_new_tokens - 2)
        cfg = cfg.replace(max_source_len=batch["frames"].shape[1])
    return init_cache(cfg, B, max_len, cache_dtype,
                      device=tokens.device), pos0


@torch.no_grad()
def generate(params, cfg: ModelConfig, batch, *, max_new_tokens: int,
             max_len: int | None = None,
             cache_dtype=torch.float32) -> torch.Tensor:
    """Batched greedy generation (prefill + decode loop) on the tokens'
    device.  batch: tokens (B, S), + frames or patch_embeds (a bare tokens
    tensor is the batch of its tokens) -> (B, max_new_tokens) int32.  The
    cache and the first decode position are :func:`static_cache`'s."""
    batch = transformer.as_batch(batch)
    tokens = batch["tokens"]
    cache, pos0 = static_cache(cfg, batch, max_new_tokens, max_len=max_len,
                               cache_dtype=cache_dtype)
    logits, cache = prefill_step(params, cfg, batch, cache)
    tok = greedy(logits)
    out = [tok]
    for i in range(max_new_tokens - 1):
        # tok was produced for position pos0 + i; decode it there for the
        # next
        pos = torch.full((tokens.shape[0],), pos0 + i, dtype=torch.int64,
                         device=tokens.device)
        logits, cache = decode_step(params, cfg, tok, cache, pos)
        tok = greedy(logits)
        out.append(tok)
    return torch.stack(out, dim=1)
