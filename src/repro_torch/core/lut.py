"""msGeMM look-up-table production and consumption (paper §3) in plain
torch; port of repro.core.lut.

Produce (§3.1): ``L[i0..i_{d-1}, j] = sum_r b(i_r) * x(j*d + r)`` — every
linear combination of d consecutive activations with int4 coefficients,
evaluated as ``L = B_d @ x_chunks`` with ``B_d (16^d, d)`` the tuple basis.

Consume (§3.2, Eq. 5): ``y(i) = sum_j L[packed_idx(i, j), j]``.

Shapes follow the paper: ``x`` is (k, b) column activations, ``y`` (m, b).
These are the algorithm's reference functions; the serving path runs the
kernel in ``repro_torch.kernels``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core import packing


@functools.lru_cache(maxsize=8)
def _tuple_codes_np(d: int) -> np.ndarray:
    idx = np.arange(packing.NLEVELS**d)
    cols = [(idx >> (4 * (d - 1 - r))) & 0xF for r in range(d)]
    return np.stack(cols, axis=1)  # (16^d, d) codes, big-endian


@functools.lru_cache(maxsize=None)
def _tuple_codes_on(d: int, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(_tuple_codes_np(d), dtype=torch.int64,
                           device=device)


def tuple_codes(d: int, device=None) -> torch.Tensor:
    """(16^d, d) int64: row i holds the d codes of flat index i (made once
    per device and read only, so a CUDA graph capture can use it)."""
    return _tuple_codes_on(d, torch.device(device or "cpu"))


def tuple_basis(d: int, dtype=torch.float32, *, codebook=None,
                device=None) -> torch.Tensor:
    """C_d (16^d, d): row i holds (C(i_0), ..., C(i_{d-1})); ``codebook``
    (16,) replaces the uniform int4 map (entry 0 must be 0)."""
    values = (packing.device_values(torch.device(device or "cpu")).to(dtype)
              if codebook is None
              else torch.as_tensor(codebook, dtype=dtype, device=device))
    return values[tuple_codes(d, values.device)]


def produce(x: torch.Tensor, d: int, *, dtype=None, codebook=None
            ) -> torch.Tensor:
    """Phase 1.  x (k, b) -> L (16^d, k/d, b)."""
    if x.ndim == 1:
        x = x[:, None]
    k, b = x.shape
    dtype = dtype or torch.promote_types(x.dtype, torch.float32)
    xp = packing.pad_k(x.to(dtype), d, axis=0)
    x_chunks = xp.reshape(-1, d, b)  # (k/d, d, b)
    basis = tuple_basis(d, dtype, codebook=codebook, device=x.device)
    return torch.einsum("nr,jrb->njb", basis, x_chunks)


def consume(lut: torch.Tensor, packed_idx: torch.Tensor, *,
            scales: torch.Tensor | None = None,
            scale_block: int | None = None, d: int | None = None,
            chunk: int = 1) -> torch.Tensor:
    """Phase 2 (Eq. 5).  lut (16^d, k/d, b), packed_idx (m, k/d) -> (m, b).

    ``scales`` (§3.3 row blocks) are applied per chunk, as the reference's
    jnp consume does; the kernel factors them per scale block instead.
    ``chunk`` columns of the table are gathered at once (one indexing op,
    an (m, chunk, b) slab) and summed, and the chunks are added in order:
    at ``chunk=1`` the sum is the reference's, term by term."""
    n, kc, b = lut.shape
    m = packed_idx.shape[0]
    if scales is not None:
        if d is None or scale_block is None:
            raise ValueError("scales require d and scale_block")
        if scale_block % d != 0:
            raise ValueError(
                f"§3.3: msGeMM needs scale blocks aligned to d "
                f"(block={scale_block}, d={d})")
        cpd = scale_block // d
    idx = packed_idx.long()
    acc = torch.zeros((m, b), dtype=lut.dtype, device=lut.device)
    for j0 in range(0, kc, chunk):
        j1 = min(j0 + chunk, kc)
        js = torch.arange(j0, j1, device=lut.device)
        g = lut[idx[:, j0:j1], js]  # (m, c, b)
        if scales is not None:
            q = scales[:, (js // cpd).clamp(max=scales.shape[1] - 1)]
            g = g * q[..., None].to(lut.dtype)
        acc = acc + g.sum(1)
    return acc


def msgemm(codes: torch.Tensor, x: torch.Tensor, d: int, *,
           scales: torch.Tensor | None = None, scale_block: int | None = None,
           chunk: int = 1, dtype=None, codebook=None) -> torch.Tensor:
    """Two-phase msGeMM: y = dequant(codes) @ x (paper Eq. 1/5).
    codes (m, k) uint8; x (k, b) or (k,)."""
    squeeze = x.ndim == 1
    if squeeze:
        x = x[:, None]
    lut = produce(x, d, dtype=dtype, codebook=codebook)
    idx = packing.pack_indices(codes, d)
    y = consume(lut, idx, scales=scales, scale_block=scale_block, d=d,
                chunk=chunk)
    return y[:, 0] if squeeze else y


def msgemm_reference(codes, x, d, *, scales=None, scale_block=None,
                     codebook=None):
    """Naive oracle: dequantize then dense matmul (paper Eq. 14 path)."""
    squeeze = x.ndim == 1
    if squeeze:
        x = x[:, None]
    values = (packing.b_values(x.dtype, x.device) if codebook is None
              else torch.as_tensor(codebook, dtype=x.dtype, device=x.device))
    w = values[torch.as_tensor(codes).long()]
    if scales is not None:
        q = torch.repeat_interleave(scales, scale_block, dim=1)[:, :w.shape[1]]
        w = w * q
    out_dtype = torch.float64 if x.dtype == torch.float64 else torch.float32
    y = w.to(out_dtype) @ x.to(out_dtype)
    return y[:, 0] if squeeze else y
