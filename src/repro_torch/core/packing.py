"""int4 code packing for msGeMM (paper §3.1–3.2) — port of repro.core.packing.

Code <-> value is the two's-complement map ``b`` of §3.1 and its inverse
``b_hat``.  Three representations:

* ``codes``      uint8, one 4-bit code per element, shape (m, k)   — canonical
* ``packed_u8``  uint8, two codes per byte (hi nibble first), (m, ceil(k/2))
* ``packed_idx`` int32, one LUT index per d-chunk, (m, ceil(k/d))

``packed_idx`` is big-endian within a chunk (index = sum_r code[j*d + r] *
16**(d-1-r)), matching ``lut.tuple_basis``.  k is zero-padded to a multiple
of d with code 0, whose value is 0.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

INT4_MIN = -8
INT4_MAX = 7
NLEVELS = 16


def b_values(dtype=torch.float32, device=None) -> torch.Tensor:
    """The table b: code (0..15) -> int4 value (§3.1)."""
    v = np.arange(NLEVELS)
    v = np.where(v <= INT4_MAX, v, v - NLEVELS)
    return torch.as_tensor(v, dtype=dtype, device=device)


_DEVICE_VALUES: dict[torch.device, torch.Tensor] = {}


def device_values(device: torch.device) -> torch.Tensor:
    """:func:`b_values` in f32 on ``device``, made once per device (read
    only): a host-to-device copy is illegal inside a CUDA graph capture,
    so every op a captured step runs reads the table from here.  One made
    under a fake-tensor mode (the dry run's) is not kept: a real call
    later in the process could not read it."""
    from torch._subclasses.fake_tensor import FakeTensor

    t = _DEVICE_VALUES.get(device)
    if t is None:
        t = b_values(torch.float32, device)
        if not isinstance(t, FakeTensor):
            _DEVICE_VALUES[device] = t
    return t


def b_hat(values: torch.Tensor) -> torch.Tensor:
    """Inverse map: int4 value -> 4-bit code (§3.2), e.g. -1 -> 0b1111."""
    v = torch.as_tensor(values).to(torch.int32)
    return torch.where(v >= 0, v, v + NLEVELS).to(torch.uint8)


def check_int4(values) -> None:
    """Raise ValueError when any value lies outside [INT4_MIN, INT4_MAX]."""
    v = np.asarray(values)
    if v.size and (v.min() < INT4_MIN or v.max() > INT4_MAX):
        raise ValueError(f"values outside int4 range [{INT4_MIN},{INT4_MAX}]")


def pad_k(arr: torch.Tensor, d: int, axis: int = -1, value=0) -> torch.Tensor:
    """Pad ``axis`` up to a multiple of d (code 0 == value 0)."""
    axis = axis % arr.ndim
    rem = (-arr.shape[axis]) % d
    if rem == 0:
        return arr
    pads = [0, 0] * (arr.ndim - 1 - axis) + [0, rem]
    return F.pad(arr, pads, value=value)


def pack_storage(codes: torch.Tensor) -> torch.Tensor:
    """codes (m, k) uint8 -> packed bytes (m, ceil(k/2)); hi nibble first."""
    c = pad_k(torch.as_tensor(codes).to(torch.uint8), 2)
    hi, lo = c[..., 0::2], c[..., 1::2]
    return (hi << 4 | lo).to(torch.uint8)


def unpack_storage(packed: torch.Tensor, k: int) -> torch.Tensor:
    """Inverse of :func:`pack_storage`."""
    hi = (packed >> 4) & 0xF
    lo = packed & 0xF
    c = torch.stack([hi, lo], dim=-1).reshape(*packed.shape[:-1], -1)
    return c[..., :k].to(torch.uint8)


def pack_indices(codes: torch.Tensor, d: int) -> torch.Tensor:
    """codes (m, k) -> LUT indices (m, ceil(k/d)) int32, big-endian chunks:
    the 4·d-bit concatenation of d consecutive codes is the flat LUT
    index (§4)."""
    c = pad_k(torch.as_tensor(codes).to(torch.int32), d)
    c = c.reshape(*c.shape[:-1], -1, d)
    weights = NLEVELS ** torch.arange(d - 1, -1, -1, dtype=torch.int32,
                                      device=c.device)
    return (c * weights).sum(-1, dtype=torch.int32)


def unpack_indices(idx: torch.Tensor, d: int, k: int) -> torch.Tensor:
    """Inverse of :func:`pack_indices` (drops the zero padding)."""
    idx = torch.as_tensor(idx).to(torch.int32)[..., :, None]
    shifts = 4 * torch.arange(d - 1, -1, -1, dtype=torch.int32,
                              device=idx.device)
    c = (idx >> shifts) & 0xF
    c = c.reshape(*idx.shape[:-2], -1)
    return c[..., :k].to(torch.uint8)


def storage_from_indices(idx: torch.Tensor, d: int, k: int) -> torch.Tensor:
    """The 2-codes/byte storage of LUT indices (the int4 kernel's layout)."""
    return pack_storage(unpack_indices(idx, d, k))


def indices_from_storage(packed_u8: torch.Tensor, d: int, k: int
                         ) -> torch.Tensor:
    """LUT indices from the 2-codes/byte storage: for d=2 the byte is the
    index; other d unpack and repack."""
    if d == 2:
        return packed_u8[..., : (k + 1) // 2].to(torch.int32)
    return pack_indices(unpack_storage(packed_u8, k), d)
