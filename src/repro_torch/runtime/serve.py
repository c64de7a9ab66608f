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

from repro_torch.device import resolve
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
                     dtype=torch.float32, *, device=None, kv_spec=None,
                     mesh=None, rules: str = "serve"):
    """Paged KV block pool; ``kv_spec`` (default ``cfg.kv_quant``) selects
    the quantized codes + scales layout (repro_torch.kvq).  With ``mesh``
    each leaf is this rank's shard under ``rules``
    (``distributed.sharding.paged_cache_specs``: kv heads over 'model'
    when they divide, block and slot dims whole), zero-filled as the
    whole pool is."""
    if mesh is None:
        return transformer.init_paged_cache(cfg, num_blocks, block_size,
                                             dtype, device=device,
                                             kv_spec=kv_spec)
    from repro_torch.distributed import sharding

    # one (1, 1)-slot pool gives each leaf's name, dtype and tail dims
    proto = transformer.init_paged_cache(cfg, 1, 1, dtype, device="cpu",
                                         kv_spec=kv_spec)
    whole = [{name: (num_blocks, block_size, *t.shape[2:])
              for name, t in layer.items()} for layer in proto]
    specs = sharding.paged_cache_specs(whole, mesh, rules)
    dev = resolve(device)
    return [{name: torch.zeros(sharding.local_shape(shape, spec[name], mesh),
                               dtype=p[name].dtype, device=dev)
             for name, shape in layer.items()}
            for layer, spec, p in zip(whole, specs, proto)]


def shard_params(params, cfg: ModelConfig, mesh, rules: str = "serve"):
    """This rank's copy of a dense decoder for serving on ``mesh``: every
    attention and MLP linear (and an untied ``lm_head``) holds its shard
    of the layout ``dispatch.shard.shard_spec_for`` derives from its
    ``LINEAR_AXES`` entry — the layout its kernel runs at, so a linear
    whose packed storage cannot split on the shard boundary stays whole —
    with ``out_dim`` set to its whole m; the embedding holds its rows
    under ``sharding.param_specs`` (the vocab over 'model' when it
    divides); norms stay whole.  ``params`` is left as it was: the copy
    shares every leaf it does not cut."""
    import copy

    from repro_torch.core import linear as qlinear
    from repro_torch.dispatch.shard import shard_linear
    from repro_torch.distributed import sharding

    out = copy.deepcopy(params, {id(t): t for t in params.buffers()})
    in_dims = {"wq": cfg.d_model, "wk": cfg.d_model, "wv": cfg.d_model,
               "wo": cfg.num_heads * cfg.head_dim, "up": cfg.d_model,
               "gate": cfg.d_model, "down": cfg.d_ff,
               "lm_head": cfg.d_model}
    for path, mod in out.named_modules():
        name = path.rsplit(".", 1)[-1]
        if not isinstance(mod, qlinear.QLinear) or name not in in_dims:
            continue
        leaves = mod.params()
        m = (leaves["w"] if "w" in leaves else leaves["scales"]).shape[0]
        local = shard_linear(cfg.quant, sharding.LINEAR_AXES[name], leaves,
                             m, in_dims[name], mesh, rules=rules)
        if local is not leaves:
            mod.load(local)
            mod.out_dim = m
    with sharding.use(mesh, rules):
        axis = transformer.vocab_axis(cfg)
    if axis is not None:
        spec = (axis, None)
        out.register_buffer("embedding", sharding.local_slice(
            params.embedding, spec, mesh).contiguous().clone())
    return out


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
