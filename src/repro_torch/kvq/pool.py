"""Quantized pool tensors and the capacity arithmetic the engine sizes
pools with; port of repro.kvq.pool.

A quantized pool entry holds four tensors instead of two::

    k        (num_blocks, block_size, Hk, Dhp)  uint8 packed codes
    k_scale  (num_blocks, block_size, Hk)       f32 per slot and kv head
    v        (num_blocks, block_size, Hk, Dhp)  uint8
    v_scale  (num_blocks, block_size, Hk)       f32

Dhp = spec.packed_dim(head_dim).  A flat slot id addresses codes and
scales alike, so the block tables never learn what a slot costs.

    bytes/token = num_layers * 2 * Hk * (Dhp + 4)          [quantized]
                = num_layers * 2 * Hk * Dh * itemsize      [kv_quant=None]
"""

from __future__ import annotations

import math

import torch

from repro_torch.kvq.spec import KVQuantSpec

SCALE_BYTES = 4  # scales are f32


def init_kv_pool(spec: KVQuantSpec, num_blocks: int, block_size: int,
                 num_kv_heads: int, head_dim: int, *, device=None) -> dict:
    """One layer's quantized pool (zero-filled: code 0 dequantizes to
    exactly 0 under every code map)."""
    dhp = spec.packed_dim(head_dim)
    codes = (num_blocks, block_size, num_kv_heads, dhp)
    scales = (num_blocks, block_size, num_kv_heads)
    return {"k": torch.zeros(codes, dtype=torch.uint8, device=device),
            "k_scale": torch.zeros(scales, dtype=torch.float32,
                                   device=device),
            "v": torch.zeros(codes, dtype=torch.uint8, device=device),
            "v_scale": torch.zeros(scales, dtype=torch.float32,
                                   device=device)}


def bytes_per_token(cfg, spec: KVQuantSpec | None = None,
                    dtype=torch.float32) -> int:
    """Pool bytes one token slot costs across the layer stack (k + v,
    codes + scales); ``spec=None`` prices the full-precision pool."""
    hk, dh = cfg.num_kv_heads, cfg.head_dim
    if spec is None:
        per_layer = 2 * hk * dh * torch.empty((), dtype=dtype).element_size()
    else:
        per_layer = 2 * hk * (spec.packed_dim(dh) + SCALE_BYTES)
    return cfg.num_layers * per_layer


def pool_bytes(cfg, num_blocks: int, block_size: int,
               spec: KVQuantSpec | None = None, dtype=torch.float32) -> int:
    """Total device bytes of a pool of ``num_blocks`` (incl. scratch)."""
    return num_blocks * block_size * bytes_per_token(cfg, spec, dtype)


def blocks_for_bytes(cfg, budget_bytes: int, block_size: int,
                     spec: KVQuantSpec | None = None,
                     dtype=torch.float32) -> int:
    """Largest pool (block count incl. the scratch block) within a byte
    budget; at least 2 (scratch plus one allocatable block)."""
    bpb = block_size * bytes_per_token(cfg, spec, dtype)
    return max(2, int(math.floor(budget_bytes / bpb)))


def capacity_table(cfg, block_size: int, dtypes=(torch.float32,),
                   specs: dict | None = None) -> list[dict]:
    """Bytes per token and the resident-sequence multiplier against the
    full-precision pool, per storage option."""
    rows = []
    base = bytes_per_token(cfg, None, dtypes[0])
    options = {"kv16": None, "kv8": KVQuantSpec(bits=8),
               "kv4": KVQuantSpec(bits=4)}
    if specs:
        options.update(specs)
    for name, spec in options.items():
        bpt = bytes_per_token(cfg, spec, dtypes[0])
        rows.append({"kv": name, "bytes_per_token": bpt,
                     "bytes_per_block": bpt * block_size,
                     "resident_multiplier": round(base / bpt, 2)})
    return rows
