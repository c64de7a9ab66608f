"""The built-in execution backends; port of repro.dispatch.backends.

* ``dense``: the bf16/f32 weight matmul (the paper's naive GeMM).
* ``msgemm_cuda``: the hand-written msGeMM kernel (the counterpart of
  ``msgemm_pallas``), which always fuses the epilogue.
* ``int4_cuda``: the hand-written int4 dequantize-then-dot kernel (the
  counterpart of ``int4_pallas``), uniform grid only, fused epilogue.

On CPU tensors each kernel backend runs its kernel's plain PyTorch
version.  The jnp msGeMM and int4 backends (``int4_jnp`` also serves
learned-codebook int4 weights) and ``dense_fallback`` wait for their
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


def _final_dtype(epilogue, x) -> Epilogue:
    """The epilogue with its output dtype made explicit (x's when unset):
    the kernels write the final dtype straight from their f32 sums."""
    out = epilogue.out_dtype if epilogue and epilogue.out_dtype else \
        str(x.dtype).removeprefix("torch.")
    return dataclasses.replace(epilogue, out_dtype=out) if epilogue else \
        Epilogue(out_dtype=out)


def run_msgemm_cuda(spec, plan, params, x, *, k, epilogue=None, bias=None,
                    residual=None):
    m = params["scales"].shape[0]
    d = spec.resolve_d(k, m)
    # the indices go to the kernel as stored (the TPU backend unpacked them
    # to codes only for its wrapper to repack them)
    idx = (params["idx"] if spec.storage == "packed_idx"
           else packing.indices_from_storage(params["u8"], d, k))
    batch = x.shape[:-1]
    y = kops.msgemm(
        idx, x.reshape(-1, k).t(), d, scales=params["scales"],
        scale_block=spec.scale_block, codebook=params.get("codebook"),
        tiles=plan.tiles, epilogue=_final_dtype(epilogue, x), bias=bias,
        residual=None if residual is None else residual.reshape(-1, m).t())
    return y.t().reshape(*batch, m)


def run_int4_cuda(spec, plan, params, x, *, k, epilogue=None, bias=None,
                  residual=None):
    m = params["scales"].shape[0]
    # packed_u8 weights go to the kernel as stored; packed_idx ones are
    # repacked to two codes a byte per call, as the reference does
    u8 = (params["u8"] if spec.storage == "packed_u8" else
          packing.pack_storage(packing.unpack_indices(
              params["idx"], spec.resolve_d(k, m), k)))
    batch = x.shape[:-1]
    y = kops.int4_matmul(
        u8, params["scales"], x.reshape(-1, k).t(),
        scale_block=spec.scale_block, tiles=plan.tiles,
        epilogue=_final_dtype(epilogue, x), bias=bias,
        residual=None if residual is None else residual.reshape(-1, m).t())
    return y.t().reshape(*batch, m)


register_backend(
    "dense", modes=("bf16",), run=run_dense, priority=100,
    description="dense matmul (the paper's naive GeMM, Eq. 14)")

register_backend(
    "msgemm_cuda", modes=("msgemm",), run=run_msgemm_cuda, priority=60,
    is_available=lambda dev: dev in ("cuda", "cpu"),
    tunable=("rows", "stage", "tj"), epilogue_ok=lambda ep: True,
    description="hand-written Hopper msGeMM kernel: shared-memory LUT "
                "produce, gather-add consume, fused epilogue")

register_backend(
    "int4_cuda", modes=("int4_dequant",), run=run_int4_cuda, priority=60,
    is_available=lambda dev: dev in ("cuda", "cpu"),
    codebooks=("none",),  # the kernel dequantizes the uniform int4 grid
    tunable=("tk", "nsplit"), epilogue_ok=lambda ep: True,
    description="hand-written Hopper int4 kernel: unpack, scale, dot, "
                "fused epilogue (the paper's dequantize-then-GeMM baseline)")
