"""KVQuantSpec — a frozen description of what the paged KV pool stores;
port of repro.kvq.spec.

* ``bits=8``  one two's-complement int8 code per element in a uint8 byte,
              symmetric scale ``amax / 127`` per (token slot, kv head);
* ``bits=4``  two 4-bit codes per byte (hi nibble first, as
              core.packing.pack_storage), scale ``amax / 7``; codes map
              through the uniform int4 grid or a 16-entry codebook.

Scales are per slot and kv head, so writing a token never re-quantizes
the earlier tokens of its block.  ``codebook`` is a tuple of 16 floats
(hashable) whose entry 0 is pinned at 0.0: code 0 is the padding code.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

NLEVELS = 16  # 4-bit codebook entries (core.packing.NLEVELS)
BITS = (8, 4)
CODEBOOKS = ("none", "learned")


@dataclass(frozen=True)
class KVQuantSpec:
    """What the paged KV pool stores (full precision is ``kv_quant=None``,
    not a spec)."""

    bits: int = 8
    # 16-entry value table for bits=4 (None: the uniform int4 grid), entry
    # 0 == 0.0 so the padding code dequantizes to exactly 0
    codebook: tuple[float, ...] | None = None
    # force a registered paged-attention backend by name
    # ('paged_attn_torch' | 'paged_attn_cuda'; None: auto-selection)
    backend: str | None = None

    def __post_init__(self):
        if self.bits not in BITS:
            raise ValueError(
                f"kv bits must be one of {BITS} (full precision is "
                f"kv_quant=None), got {self.bits}")
        if self.codebook is not None:
            if self.bits != 4:
                raise ValueError("codebooks are a 16-entry (4-bit) "
                                 f"construct; bits={self.bits} cannot use one")
            cb = tuple(float(v) for v in self.codebook)
            if len(cb) != NLEVELS:
                raise ValueError(
                    f"codebook must have {NLEVELS} entries, got {len(cb)}")
            if cb[0] != 0.0:
                raise ValueError("codebook entry 0 is the padding code and "
                                 f"must be 0.0, got {cb[0]}")
            object.__setattr__(self, "codebook", cb)

    @property
    def qmax(self) -> int:
        """Symmetric integer range of the uniform grid (scale = amax/qmax)."""
        return 127 if self.bits == 8 else 7

    @property
    def codebook_kind(self) -> str:
        """'none' | 'learned' — the registry's codebook capability axis."""
        return "none" if self.codebook is None else "learned"

    @property
    def codes_per_byte(self) -> int:
        return 1 if self.bits == 8 else 2

    def packed_dim(self, head_dim: int) -> int:
        """Packed-u8 length of one head's code row (2 codes/byte at 4-bit)."""
        return head_dim if self.bits == 8 else -(-head_dim // 2)

    def code_bytes(self, head_dim: int) -> int:
        return self.packed_dim(head_dim)

    def with_codebook(self, values) -> "KVQuantSpec":
        """A copy carrying ``values`` (any 16 floats) as the codebook."""
        return replace(self, codebook=tuple(float(v) for v in values))

    def describe(self) -> str:
        cb = "learned" if self.codebook is not None else "uniform"
        return f"kv_int{self.bits}[{cb}]"
