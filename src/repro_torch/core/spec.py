"""QuantSpec — a frozen description of what the weights are; port of
repro.core.spec (the deprecated ``QuantConfig`` shim is not ported: the
port never had callers to migrate, so :func:`as_spec` takes a QuantSpec
only).

It says nothing about how a GeMM runs: that is ``repro_torch.dispatch``.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

from repro_torch.core import complexity, scales

MODES = ("bf16", "int4_dequant", "msgemm")
STORAGES = ("packed_idx", "packed_u8")
CODEBOOKS = ("none", "learned")


@dataclass(frozen=True)
class QuantSpec:
    """mode: ``bf16`` | ``int4_dequant`` | ``msgemm``.  d: LUT depth in
    [1, 4] or ``'adaptive'`` (per-linear argmax of Eq. 15).  scale_block:
    §3.3 row-block size, 0 resolves to 12·d.  storage: ``packed_idx`` |
    ``packed_u8``.  codebook: ``none`` | ``learned``."""

    mode: str = "bf16"
    d: int | str = 3
    scale_block: int = 0
    storage: str = "packed_idx"
    codebook: str = "none"

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"unknown quant mode {self.mode!r}; one of {MODES}")
        if self.storage not in STORAGES:
            raise ValueError(
                f"unknown storage {self.storage!r}; one of {STORAGES}")
        if self.codebook not in CODEBOOKS:
            raise ValueError(
                f"unknown codebook policy {self.codebook!r}; one of {CODEBOOKS}")
        if self.d != "adaptive":
            if not isinstance(self.d, int) or not 1 <= self.d <= 4:
                raise ValueError(
                    f"LUT depth d={self.d!r} must be 'adaptive' or an int in "
                    "[1, 4] (the 16^d LUT is produced in full)")
        if self.scale_block < 0:
            raise ValueError(f"scale_block={self.scale_block} must be >= 0")
        if self.d != "adaptive" and self.scale_block == 0:
            object.__setattr__(self, "scale_block", 12 * int(self.d))
        elif self.scale_block == 0:
            object.__setattr__(self, "scale_block", 12)
        if self.mode == "msgemm":
            scales.check_applicable(
                self.scale_block, 2 if self.d == "adaptive" else int(self.d))

    def resolve_d(self, in_dim: int, out_dim: int) -> int:
        """The depth this linear uses (static in the shapes)."""
        if self.d != "adaptive":
            return int(self.d)
        d_star, _ = complexity.best_d(out_dim, in_dim, range(2, 5))
        while self.scale_block % d_star:  # the block must stay a multiple of d
            d_star -= 1
        return max(d_star, 2)

    def with_mode(self, mode: str) -> "QuantSpec":
        return replace(self, mode=mode)


DENSE = QuantSpec(mode="bf16")


def expert_spec(spec: QuantSpec) -> QuantSpec:
    """The spec a MoE expert stack is stored and run under: quantized
    experts run ``int4_dequant`` in every quantized mode, as the
    reference's ``moe._expert_ffn`` runs them in msgemm mode (an expert's
    m is below 16^d, so a LUT cannot amortize), and are stored two codes
    a byte (``packed_u8``, the int4 kernel's layout: the same codes and
    scales as the reference's indices, which the kernel would otherwise
    repack every step); dense experts stay ``bf16``."""
    if spec.mode == "bf16":
        return spec
    return replace(spec, mode="int4_dequant", storage="packed_u8")


def as_spec(spec) -> QuantSpec:
    """``spec`` itself when it is a QuantSpec; TypeError otherwise."""
    if isinstance(spec, QuantSpec):
        return spec
    raise TypeError(f"expected QuantSpec, got {type(spec)!r}")
