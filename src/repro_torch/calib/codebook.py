"""16-entry codebook abstraction for non-uniform LUT quantization; port of
repro.calib.codebook, on tensors.

msGeMM's consume phase only adds table entries: Eq. 5 never needs the 16
coefficient levels to be the uniform int4 grid, so a learned codebook
costs the kernel nothing (the produce basis ``C_d`` is an operand).

Conventions shared with core.scales, core.lut and the kernels:

* a codebook is a (16,) float32 value table indexed by the 4-bit code;
* ``values[0] == 0.0``: code 0 is the k-padding code (core.packing pads
  with it and relies on a zero contribution);
* scales stay bounding-box normalized (``amax / 7``, as uniform int4), so
  entries live in the normalized domain [-7, 7] and uniform and learned
  tables are comparable on the same scale grid.

The uniform table (the two's-complement value order of paper §3.1) is the
degenerate case: quantizing with it reproduces core.scales.quantize_int4
bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import lut as lut_mod
from repro_torch.core import packing

NLEVELS = packing.NLEVELS


def uniform_values(device=None) -> torch.Tensor:
    """The uniform int4 grid in code order: b(0)=0 ... b(15)=-1 (§3.1),
    float32."""
    return packing.b_values(torch.float32, device)


class Codebook(NamedTuple):
    """A 16-entry value table: ``values`` (16,) float32, values[0] == 0.
    Per layer, or one shared by every linear of a model."""

    values: torch.Tensor

    @classmethod
    def uniform_int4(cls, device=None) -> "Codebook":
        return cls(values=uniform_values(device))

    @classmethod
    def from_centroids(cls, centroids) -> "Codebook":
        """A valid codebook from up to 15 learned centroids: value 0 is
        pinned at code 0, the rest fill codes 1..15 in sorted order."""
        c = torch.as_tensor(centroids).to(torch.float64).reshape(-1)
        c = c[c.abs() > 1e-12]  # 0 is always present through code 0
        if c.numel() > NLEVELS - 1:
            raise ValueError(f"at most {NLEVELS - 1} nonzero centroids, "
                             f"got {c.numel()}")
        vals = torch.zeros((NLEVELS,), dtype=torch.float32, device=c.device)
        vals[1:1 + c.numel()] = torch.sort(c).values.to(torch.float32)
        return cls(values=vals)

    def check(self) -> "Codebook":
        """Validate the invariants the packed and padded paths rely on."""
        v = torch.as_tensor(self.values)
        if tuple(v.shape) != (NLEVELS,):
            raise ValueError(
                f"codebook must be ({NLEVELS},), got {tuple(v.shape)}")
        if float(v[0]) != 0.0:
            raise ValueError(
                "codebook[0] must be 0 — code 0 is the zero-padding code "
                "(core.packing.pad_k) and padded LUT rows must contribute 0")
        if not bool(torch.isfinite(v).all()):
            raise ValueError("codebook values must be finite")
        return self

    def _table(self, device) -> torch.Tensor:
        return torch.as_tensor(self.values).to(device=device,
                                               dtype=torch.float32)

    def encode(self, z: torch.Tensor) -> torch.Tensor:
        """Nearest-entry codes (uint8; the first entry on ties) for
        normalized values z (...,)."""
        cb = self._table(z.device)
        return torch.argmin((z[..., None].to(torch.float32) - cb).abs(),
                            dim=-1).to(torch.uint8)

    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        """codes (...,) uint8 -> values (...,) float32."""
        return self._table(codes.device)[codes.long()]

    def basis(self, d: int, dtype=torch.float32) -> torch.Tensor:
        """The produce-phase tuple basis C_d (16^d, d) over this codebook."""
        v = torch.as_tensor(self.values)
        return lut_mod.tuple_basis(d, dtype, codebook=v, device=v.device)

    @property
    def is_uniform(self) -> bool:
        v = torch.as_tensor(self.values)
        return bool(torch.equal(v.to(torch.float32).cpu(), uniform_values()))
