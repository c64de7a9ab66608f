"""Paged KV cache plumbing (a copy of repro.serving.kv_blocks): a
fixed-size block pool with a free-list
allocator, per-sequence block tables, and the flat "cache view" index
arrays the paged attention path consumes (models.layers.attn_paged).

Block 0 is reserved as a *scratch* block: padding tokens (prefill-chunk
tail, idle decode slots) scatter their K/V there and block tables pad
with it, so every step has fully static shapes while garbage never
reaches a real sequence (masked entries get probability exactly 0).

The allocator is host-side Python (like vLLM's) — allocation decisions
are control flow, not device compute; only the pool tensors live on
device (runtime.serve.init_paged_cache).
"""

from __future__ import annotations

from collections import deque

import numpy as np

from repro_torch import faults

SCRATCH = 0  # reserved block id — never allocated, never trusted


class BlockPool:
    """Free-list allocator over ``num_blocks`` blocks of ``block_size``
    token slots each.  Block ids index the device-side pool tensors."""

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks < 2:
            raise ValueError("need >= 2 blocks (one is scratch)")
        if block_size < 1:
            raise ValueError("block_size must be positive")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self._free: deque[int] = deque(range(1, num_blocks))
        self._free_set: set[int] = set(self._free)

    @property
    def capacity(self) -> int:
        """Allocatable blocks (excludes scratch)."""
        return self.num_blocks - 1

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    def blocks_for(self, num_tokens: int) -> int:
        return -(-num_tokens // self.block_size)

    def alloc(self, n: int) -> list[int] | None:
        """All-or-nothing allocation of ``n`` blocks (None on exhaustion,
        organic or injected by the ``oom`` fault class)."""
        if n > len(self._free):
            return None
        if faults.fire("oom") is not None:
            return None  # injected: the signal real pool pressure gives
        out = [self._free.popleft() for _ in range(n)]
        self._free_set.difference_update(out)
        return out

    def free(self, blocks: list[int]) -> None:
        """Return blocks to the free list.  Double-frees (and frees of
        ids never allocated from this pool) raise instead of silently
        corrupting the free list — a double-freed block would be handed
        to two sequences at once and their K/V writes would interleave."""
        for b in blocks:
            if b == SCRATCH:
                raise ValueError("attempt to free the scratch block")
            if not 0 < b < self.num_blocks:
                raise ValueError(f"block id {b} outside pool "
                                 f"[1, {self.num_blocks})")
            if b in self._free_set:
                raise ValueError(f"double free of block {b}")
            self._free.append(b)
            self._free_set.add(b)


def view_slots(blocks: list[int], max_blocks: int, block_size: int
               ) -> np.ndarray:
    """Flat pool slots (W,) = the sequence's cache view: view index w maps
    to the pool slot holding logical position w (scratch-padded)."""
    ids = np.full((max_blocks,), SCRATCH, np.int32)
    ids[:len(blocks)] = blocks
    off = np.arange(block_size, dtype=np.int32)
    return (ids[:, None] * block_size + off[None, :]).reshape(-1)


def write_slots(blocks: list[int], start: int, count: int, pad_to: int,
                block_size: int) -> np.ndarray:
    """Flat pool slots (pad_to,) where tokens at logical positions
    [start, start+count) scatter their K/V; tail padding goes to scratch."""
    pos = np.arange(start, start + count, dtype=np.int32)
    ids = np.asarray(blocks, np.int32)[pos // block_size]
    ws = ids * block_size + pos % block_size
    pad = np.arange(pad_to - count, dtype=np.int32) % block_size  # scratch
    return np.concatenate([ws, pad]).astype(np.int32)
