"""Input-shape cells for the (architecture x shape) grid; port of
repro.configs.shapes.

  train_4k      seq_len=4096    global_batch=256   -> train step
  prefill_32k   seq_len=32768   global_batch=32    -> serve prefill
  decode_32k    seq_len=32768   global_batch=128   -> serve step (1 token,
                                                      KV cache @ 32k)
  long_500k     seq_len=524288  global_batch=1     -> serve step, only for
                                                      sub-quadratic archs

Skip rule: long_500k runs only for family ssm/hybrid; every
full-attention arch skips it.  Whisper maps seq_len to *encoder frames*
with a fixed 448-token decoder target; a vision config's patches take
``num_patches`` of seq_len.  The reference's ``jax.ShapeDtypeStruct``
stand-ins are :class:`Spec` here, a (shape, dtype) pair that allocates
nothing (the decode cache's are read off ``transformer.block_cache`` on
the ``meta`` device, as the reference's ``jax.eval_shape`` of
``init_cache``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from repro_torch.models.config import ModelConfig


@dataclass(frozen=True)
class Shape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": Shape("train_4k", 4096, 256, "train"),
    "prefill_32k": Shape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": Shape("decode_32k", 32768, 128, "decode"),
    "long_500k": Shape("long_500k", 524288, 1, "decode"),
}


class Spec(NamedTuple):
    """An input's shape and dtype, with no storage."""

    shape: tuple
    dtype: torch.dtype


def subquadratic(cfg: ModelConfig) -> bool:
    """True if sequence mixing is sub-quadratic (long_500k eligibility):
    the reference's ``ModelConfig.subquadratic``, by family."""
    return cfg.family in ("ssm", "hybrid")


def applicable(cfg: ModelConfig, shape_name: str) -> tuple[bool, str]:
    """(runs?, reason-if-skipped)."""
    if shape_name == "long_500k" and not subquadratic(cfg):
        return False, ("full-attention sequence mixing is quadratic at "
                       "524288 tokens (DESIGN.md §5 skip)")
    return True, ""


def cells(cfg: ModelConfig):
    """All live (shape, skip-reason) rows for this arch — 4 per arch."""
    return {s: applicable(cfg, s) for s in SHAPES}


def _whisper_lens(cfg: ModelConfig, shape: Shape) -> tuple[int, int]:
    """(encoder frames, decoder tokens) of an enc-dec cell."""
    return shape.seq_len, min(cfg.max_seq_len, 448)


def _embed_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def train_input_specs(cfg: ModelConfig, shape: Shape, *, batch=None) -> dict:
    """Stand-ins for a train step's batch (no allocation)."""
    B = batch or shape.global_batch
    tok = torch.int32
    if cfg.is_encdec:
        src, dec = _whisper_lens(cfg, shape)
        return {"frames": Spec((B, src, cfg.d_model), _embed_dtype(cfg)),
                "tokens": Spec((B, dec), tok),
                "labels": Spec((B, dec), tok)}
    S = shape.seq_len
    if cfg.frontend == "image_patches":
        P = cfg.num_patches
        return {"patch_embeds": Spec((B, P, cfg.d_model), _embed_dtype(cfg)),
                "tokens": Spec((B, S - P), tok),
                "labels": Spec((B, S), tok)}  # patch positions IGNORE
    return {"tokens": Spec((B, S), tok), "labels": Spec((B, S), tok)}


def prefill_input_specs(cfg: ModelConfig, shape: Shape, *, batch=None
                        ) -> dict:
    specs = train_input_specs(cfg, shape, batch=batch)
    specs.pop("labels")
    return specs


def _cache_specs(cfg: ModelConfig, B: int, max_len: int, dtype) -> list:
    """Mirror ``models.transformer.init_cache`` as Specs, one dict a layer:
    seq_len-deep K/V for an attention layer, the recurrent state (of no
    sequence length) otherwise."""
    from repro_torch.models import transformer  # local to avoid cycles

    return [{name: Spec(tuple(t.shape), t.dtype) for name, t in
             transformer.block_cache(cfg, cfg.kind(i), B, max_len, dtype,
                                     device="meta").items()}
            for i in range(cfg.num_layers)]


def decode_input_specs(cfg: ModelConfig, shape: Shape, *, batch=None,
                       cache_dtype=torch.bfloat16) -> dict:
    """Inputs of a decode step: one new token, its position, and the
    per-layer caches of ``models.transformer.init_cache`` (an enc-dec
    config's: the decoder target deep, the cross K/V at seq_len frames)."""
    B = batch or shape.global_batch
    max_len = shape.seq_len
    if cfg.is_encdec:
        src, max_len = _whisper_lens(cfg, shape)
        cfg = cfg.replace(max_source_len=src)
    return {"token": Spec((B,), torch.int32),
            "pos": Spec((B,), torch.int32),
            "cache": _cache_specs(cfg, B, max_len, cache_dtype)}


def input_specs(cfg: ModelConfig, shape_name: str, **kw) -> dict:
    shape = SHAPES[shape_name]
    if shape.kind == "train":
        return train_input_specs(cfg, shape, **kw)
    if shape.kind == "prefill":
        return prefill_input_specs(cfg, shape, **kw)
    return decode_input_specs(cfg, shape, **kw)
