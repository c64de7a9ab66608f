"""Shared-scale (bounding-box) quantization — paper §3.3; port of
repro.core.scales.

§3.3's applicability rule: scale blocks laid along a ROW of M with block
size r >= d and d | r compose with msGeMM (the scale factors out after the
LUT is consumed); blocks along a COLUMN do not.

``torch.round`` rounds half to even, like ``jnp.round``, so codes come out
identical to the reference.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core import packing


class QuantizedTensor(NamedTuple):
    """Row-block 4-bit quantized matrix (m, k).

    codes: (m, k) uint8; scales: (m, ceil(k/block)) float32; block: the
    scale block r along k; shape: (m, k); codebook: optional (16,) float32
    value table (entry 0 must be 0.0), None for the uniform int4 grid.
    """

    codes: torch.Tensor
    scales: torch.Tensor
    block: int
    shape: tuple
    codebook: torch.Tensor | None = None


def check_applicable(block: int, d: int, axis: str = "row") -> None:
    """§3.3 rule: row-blocked scales with d | r compose with msGeMM."""
    if axis != "row":
        raise ValueError(
            "§3.3: column-wise bounding boxes make msGeMM inapplicable "
            "(each LUT entry would need a per-row scale)")
    if block < d or block % d != 0:
        raise ValueError(
            f"§3.3: scale block r={block} must be >= d and a multiple of d={d}")


def _blocks(w: torch.Tensor, block: int):
    m, k = w.shape
    kp = -(-k // block) * block
    wb = F.pad(w.to(torch.float32), (0, kp - k)).reshape(m, kp // block, block)
    amax = wb.abs().amax(-1)
    return wb, amax, kp


def quantize_int4(w: torch.Tensor, block: int = 32, *,
                  power_of_two: bool = False) -> QuantizedTensor:
    """Symmetric row-block int4 quantization of a dense (m, k) matrix.
    ``power_of_two`` restricts scales to 2^e (MSFP12-like exponents)."""
    m, k = w.shape
    wb, amax, kp = _blocks(w, block)
    scale = amax / packing.INT4_MAX  # amax -> ±7, no clipping error
    if power_of_two:
        scale = torch.exp2(torch.ceil(torch.log2(scale.clamp_min(1e-30))))
    scale = torch.where(amax == 0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(wb / scale[..., None]),
                    packing.INT4_MIN, packing.INT4_MAX).to(torch.int32)
    codes = packing.b_hat(q).reshape(m, kp)[:, :k]
    return QuantizedTensor(codes=codes, scales=scale, block=block,
                           shape=(m, k))


def quantize_codebook(w: torch.Tensor, codebook, block: int = 32
                      ) -> QuantizedTensor:
    """Row-block quantization of (m, k) onto a 16-entry value ``codebook``:
    the same ``amax / 7`` scales as :func:`quantize_int4`, codes are the
    nearest entries (first one on ties, as ``jnp.argmin``)."""
    m, k = w.shape
    wb, amax, kp = _blocks(w, block)
    scale = amax / packing.INT4_MAX
    scale = torch.where(amax == 0, torch.ones_like(scale), scale)
    cb = torch.as_tensor(codebook, dtype=torch.float32, device=w.device)
    z = wb / scale[..., None]
    codes = torch.argmin((z[..., None] - cb).abs(), dim=-1).to(torch.uint8)
    return QuantizedTensor(codes=codes.reshape(m, kp)[:, :k], scales=scale,
                           block=block, shape=(m, k), codebook=cb)


def dequantize(qt: QuantizedTensor, dtype=torch.float32) -> torch.Tensor:
    """Reconstruct the dense matrix."""
    m, k = qt.shape
    dev = qt.codes.device
    values = (packing.device_values(dev) if qt.codebook is None
              else torch.as_tensor(qt.codebook, dtype=torch.float32,
                                   device=dev))
    vals = values[qt.codes.long()]
    q = torch.repeat_interleave(qt.scales, qt.block, dim=1)[:, :k]
    return (vals * q).to(dtype)


def quantization_error(w: torch.Tensor, qt: QuantizedTensor) -> torch.Tensor:
    """Max absolute reconstruction error."""
    return (w - dequantize(qt, w.dtype)).abs().max()


def weighted_quantization_error(w: torch.Tensor, qt: QuantizedTensor,
                                col_weights=None) -> torch.Tensor:
    """Activation-aware reconstruction error: mean over rows of
    ``sum_j cw_j (w_ij - deq_ij)^2 / sum_j cw_j`` — the proxy for the
    layer-output MSE ``E||(W - Q)x||^2`` under diagonal input second
    moments ``cw_j = E[x_j^2]`` (repro_torch.calib's fitting objective).
    Computed in float32, in the reference's op order."""
    err = (w.to(torch.float32) - dequantize(qt, torch.float32)) ** 2
    if col_weights is None:
        return err.mean()
    cw = torch.as_tensor(col_weights, device=w.device).to(torch.float32)
    cw = cw / cw.sum().clamp_min(1e-30)
    return (err * cw[None, :]).sum(dim=1).mean()
