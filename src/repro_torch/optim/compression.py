"""int8 gradient compression with error feedback; port of
repro.optim.compression.

Reducing gradients over the slow 'pod' axis moves bytes between hosts;
quantizing them to int8 (and one f32 scale a leaf, shared through a
scalar pmax) cuts those bytes 4x against f32.  The codes are summed as
int32 on the wire (gloo and NCCL both sum int32), exactly, given the
shared scale, so the only loss is the quantization itself, which error
feedback folds into the next step: each rank carries its own
quantization error as a residual.

The op order is the reference's: ``pmax(max|g + r|) / 127`` (1 where it
is 0), round, clip to ±127, sum the codes as int32, times the scale,
divided by the axis size.  The train step calls
:func:`compressed_pmean_tree` for its mean over 'pod' when
``TrainConfig.grad_compression == "int8_pod"``.
"""

from __future__ import annotations

import torch

from repro_torch.distributed import collectives as coll
from repro_torch.distributed import compat, sharding


def quantize_int8(x: torch.Tensor):
    """(codes int8, scale f32 0-d): ``scale = max|x| / 127`` (1 where it
    is 0), codes ``clip(round(x / scale), -127, 127)``."""
    amax = torch.amax(torch.abs(x))
    scale = torch.where(amax > 0, amax / 127.0, 1.0).to(torch.float32)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def _codes(x: torch.Tensor, axis: str, mesh):
    """(codes int8, scale) of ``x`` (f32) under the scale shared over
    ``axis``: the pmax of the ranks' max |x|, over 127."""
    scale = coll.pmax(torch.amax(torch.abs(x)), axis, mesh=mesh) / 127.0
    scale = torch.where(scale > 0, scale, 1.0)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def compressed_psum(x: torch.Tensor, axis: str, *, mesh=None
                    ) -> torch.Tensor:
    """The sum of ``x`` over ``axis`` with an int8 wire format: f32
    out."""
    q, scale = _codes(x.to(torch.float32), axis, mesh)
    s = coll.psum(q.to(torch.int32), axis, mesh=mesh)
    return s.to(torch.float32) * scale


def compressed_pmean_tree(grads: dict, axis: str, residual: dict | None = None,
                          *, mesh=None) -> tuple[dict, dict]:
    """The error-feedback compressed mean of a dict of gradients over
    ``axis``.  Returns (mean gradients in each leaf's dtype, the new
    residual: this rank's own quantization error, f32)."""
    n = compat.axes_of(mesh or sharding.active_mesh())[axis]
    mean, res = {}, {}
    for name, g in grads.items():
        gf = g.to(torch.float32)
        if residual is not None:
            gf = gf + residual[name]
        q, scale = _codes(gf, axis, mesh)
        red = coll.psum(q.to(torch.int32), axis, mesh=mesh
                        ).to(torch.float32) * scale / n
        mean[name] = red.to(g.dtype)
        res[name] = gf - q.to(torch.float32) * scale
    return mean, res
