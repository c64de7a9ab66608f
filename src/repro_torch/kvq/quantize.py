"""Quantize-on-write / dequantize-on-read ops for the paged KV pool; port
of repro.kvq.quantize.

Shape-generic over a trailing ``head_dim`` axis, with one symmetric scale
per (token, kv head).  ``torch.round`` rounds half to even and
``torch.argmin`` keeps the first minimum, as ``jnp.round`` and
``jnp.argmin`` do, so codes and scales are bit-identical to the
reference's.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.core import packing
from repro_torch.kvq.spec import KVQuantSpec


@functools.lru_cache(maxsize=None)
def codebook_tensor(values: tuple, device: torch.device) -> torch.Tensor:
    """A spec's codebook as an f32 tensor on ``device``, made once: a
    host-to-device copy per call would be illegal inside a CUDA graph
    capture (so is the uniform grid's, ``packing.device_values``)."""
    return torch.tensor(values, dtype=torch.float32, device=device)


def pack_codes(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """codes (..., Dh) uint8 -> packed u8 storage (..., Dhp)."""
    if bits == 8:
        return codes.to(torch.uint8)
    return packing.pack_storage(codes)


def unpack_codes(packed: torch.Tensor, bits: int, head_dim: int
                 ) -> torch.Tensor:
    """Inverse of :func:`pack_codes` (drops 4-bit pad columns)."""
    if bits == 8:
        return packed
    return packing.unpack_storage(packed, head_dim)


def kv_scales(x: torch.Tensor, spec: KVQuantSpec) -> torch.Tensor:
    """amax / qmax over the trailing head_dim; all-zero rows get scale 1
    (their codes are all the zero code, so the round trip stays exact)."""
    amax = x.to(torch.float32).abs().amax(-1)
    return torch.where(amax > 0, amax / spec.qmax,
                       torch.ones_like(amax)).to(torch.float32)


def kv_quantize(x: torch.Tensor, spec: KVQuantSpec
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """x (..., Dh) float -> (packed codes (..., Dhp) uint8, scales (...)
    f32): the write half of the pool's storage format."""
    xf = x.to(torch.float32)
    scale = kv_scales(xf, spec)
    z = xf / scale[..., None]
    if spec.codebook is None:
        q = torch.clamp(torch.round(z), -spec.qmax, spec.qmax) \
            .to(torch.int32)
        mask = 0xFF if spec.bits == 8 else 0xF  # two's complement in u8
        codes = (q & mask).to(torch.uint8)
    else:
        cb = codebook_tensor(spec.codebook, x.device)
        codes = torch.argmin((z[..., None] - cb).abs(), dim=-1) \
            .to(torch.uint8)
    return pack_codes(codes, spec.bits), scale


def decode_values(codes: torch.Tensor, spec: KVQuantSpec) -> torch.Tensor:
    """Unpacked codes (..., Dh) uint8 -> grid or codebook values f32 (the
    table lookup, before the scale multiply)."""
    c = codes.to(torch.int64)
    if spec.codebook is not None:
        return codebook_tensor(spec.codebook, codes.device)[c]
    if spec.bits == 8:
        return torch.where(c < 128, c, c - 256).to(torch.float32)
    return packing.device_values(codes.device)[c]


def kv_dequantize(packed: torch.Tensor, scales: torch.Tensor,
                  spec: KVQuantSpec, head_dim: int,
                  dtype=torch.float32) -> torch.Tensor:
    """(packed (..., Dhp) u8, scales (...)) -> values (..., Dh) ``dtype``:
    the read half, which the torch backend materializes for the whole
    view and the CUDA kernel computes per block on chip."""
    vals = decode_values(unpack_codes(packed, spec.bits, head_dim), spec)
    return (vals * scales[..., None].to(torch.float32)).to(dtype)
