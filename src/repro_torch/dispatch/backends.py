"""The built-in execution backends; port of repro.dispatch.backends.

* ``dense``: the bf16/f32 weight matmul (the paper's naive GeMM).
* ``msgemm_cuda``: the hand-written msGeMM kernel (the counterpart of
  ``msgemm_pallas``), which always fuses the epilogue.  On CPU tensors it
  runs the kernel's plain PyTorch version.

The jnp msGeMM, int4 and ``dense_fallback`` backends wait for their
slices, so a quantized model here has exactly one execution path.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import packing
from repro_torch.core.epilogue import Epilogue
from repro_torch.dispatch.registry import register_backend
from repro_torch.kernels import ops as kops


def run_dense(spec, plan, params, x, *, k, epilogue=None, bias=None,
              residual=None):
    w = params["w"]
    dt = torch.promote_types(x.dtype, w.dtype)
    return torch.matmul(x.to(dt), w.to(dt).t()).to(x.dtype)


def run_msgemm_cuda(spec, plan, params, x, *, k, epilogue=None, bias=None,
                    residual=None):
    m = params["scales"].shape[0]
    d = spec.resolve_d(k, m)
    # the indices go to the kernel as stored (the TPU backend unpacked them
    # to codes only for its wrapper to repack them)
    idx = (params["idx"] if spec.storage == "packed_idx"
           else packing.indices_from_storage(params["u8"], d, k))
    batch = x.shape[:-1]
    # the kernel writes the final dtype straight from its f32 accumulator
    out = epilogue.out_dtype if epilogue and epilogue.out_dtype else \
        str(x.dtype).removeprefix("torch.")
    ep = dataclasses.replace(epilogue, out_dtype=out) if epilogue else \
        Epilogue(out_dtype=out)
    y = kops.msgemm(
        idx, x.reshape(-1, k).t(), d, scales=params["scales"],
        scale_block=spec.scale_block, codebook=params.get("codebook"),
        tiles=plan.tiles, epilogue=ep, bias=bias,
        residual=None if residual is None else residual.reshape(-1, m).t())
    return y.t().reshape(*batch, m)


register_backend(
    "dense", modes=("bf16",), run=run_dense, priority=100,
    description="dense matmul (the paper's naive GeMM, Eq. 14)")

register_backend(
    "msgemm_cuda", modes=("msgemm",), run=run_msgemm_cuda, priority=60,
    is_available=lambda dev: dev in ("cuda", "cpu"),
    epilogue_ok=lambda ep: True,
    description="hand-written Hopper msGeMM kernel: shared-memory LUT "
                "produce, gather-add consume, fused epilogue")
