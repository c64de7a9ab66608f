"""The built-in execution backends; port of repro.dispatch.backends.

* ``dense``: the bf16/f32 weight matmul (the paper's naive GeMM).
* ``msgemm_cuda``: the hand-written msGeMM kernel (the counterpart of
  ``msgemm_pallas``), which always fuses the epilogue.
* ``int4_cuda``: the hand-written int4 dequantize-then-dot kernel (the
  counterpart of ``int4_pallas``), uniform grid only, fused epilogue.

* ``msgemm_torch``: LUT produce then gather consume in plain torch,
  multiplying each chunk by its scale (the counterpart of ``msgemm_jnp``);
  priority 50, below the kernel on both devices.
* ``int4_torch``: dequantize onto the uniform grid or the leaf's learned
  codebook, then ``torch.matmul`` (the counterpart of ``int4_jnp``);
  priority 50, below ``int4_cuda`` for uniform weights and the only
  backend for learned int4 weights, as ``int4_jnp`` is in the reference
  (``int4_pallas`` refuses codebooks).

* ``dense_fallback``: dequantize to dense, then ``torch.matmul`` (the
  counterpart of the reference's ``dense_fallback``); priority -100, the
  bottom rung of the degradation ladder (``msgemm_cuda`` ->
  ``msgemm_torch`` -> ``dense_fallback``, ``int4_cuda`` -> ``int4_torch``
  -> ``dense_fallback``), selected only when the rungs above are
  quarantined (the engine's NaN guard and watchdog escalation).

On CPU tensors each kernel backend runs its kernel's plain PyTorch
version.

``dense``, ``int4_cuda``, ``int4_torch`` and ``dense_fallback`` also run
an expert stack, the MoE block's linears: params with a leading expert
axis (``w`` (E, m, k); ``u8``/``idx`` (E, m, .), ``scales`` (E, m, nsb))
and x (E, ..., k) -> y (E, ..., m), the int4 kernel in one launch for
all E.  The msGeMM backends take one linear only (the reference runs its
experts int4 in msgemm mode too: ``models.moe``).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import lut, packing, scales
from repro_torch.core.epilogue import Epilogue
from repro_torch.dispatch.registry import register_backend
from repro_torch.kernels import ops as kops


def run_dense(spec, plan, params, x, *, k, epilogue=None, bias=None,
              residual=None):
    w = params["w"]
    dt = torch.promote_types(x.dtype, w.dtype)
    if w.dim() == 3:  # an expert stack: one matmul an expert
        return torch.matmul(x.reshape(w.shape[0], -1, k).to(dt),
                            w.to(dt).transpose(1, 2)
                            ).reshape(*x.shape[:-1], -1).to(x.dtype)
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
    m = params["scales"].shape[-2]
    # packed_u8 weights go to the kernel as stored; packed_idx ones are
    # repacked to two codes a byte per call, as the reference does
    u8 = (params["u8"] if spec.storage == "packed_u8" else
          packing.storage_from_indices(params["idx"], spec.resolve_d(k, m),
                                       k))
    if u8.dim() == 3:  # an expert stack: x (E, ..., k), one launch
        E = u8.shape[0]
        y = kops.int4_matmul(
            u8, params["scales"], x.reshape(E, -1, k).transpose(1, 2),
            scale_block=spec.scale_block, tiles=plan.tiles,
            epilogue=_final_dtype(epilogue, x))
        return y.transpose(1, 2).reshape(*x.shape[:-1], m)
    batch = x.shape[:-1]
    y = kops.int4_matmul(
        u8, params["scales"], x.reshape(-1, k).t(),
        scale_block=spec.scale_block, tiles=plan.tiles,
        epilogue=_final_dtype(epilogue, x), bias=bias,
        residual=None if residual is None else residual.reshape(-1, m).t())
    return y.t().reshape(*batch, m)


def _codes(params, spec, k: int, d: int) -> torch.Tensor:
    if spec.storage == "packed_idx":
        return packing.unpack_indices(params["idx"], d, k)
    return packing.unpack_storage(params["u8"], k)


def run_int4_torch(spec, plan, params, x, *, k, epilogue=None, bias=None,
                   residual=None):
    m = params["scales"].shape[-2]
    codes = _codes(params, spec, k, spec.resolve_d(k, m))
    if codes.dim() == 3:  # an expert stack: each expert on its own table
        E = codes.shape[0]
        cb = params.get("codebook")
        w = torch.stack([scales.dequantize(scales.QuantizedTensor(
            codes=codes[e], scales=params["scales"][e],
            block=spec.scale_block, shape=(m, k),
            codebook=None if cb is None else cb[e]), x.dtype)
            for e in range(E)])
        return torch.matmul(x.reshape(E, -1, k), w.transpose(1, 2)
                            ).reshape(*x.shape[:-1], m)
    qt = scales.QuantizedTensor(
        codes=codes, scales=params["scales"], block=spec.scale_block,
        shape=(m, k), codebook=params.get("codebook"))
    return torch.matmul(x, scales.dequantize(qt, x.dtype).t())


CONSUME_SLAB = 1 << 25  # f32 entries (128 MiB) gathered per consume step


def run_msgemm_torch(spec, plan, params, x, *, k, epilogue=None, bias=None,
                     residual=None):
    m = params["scales"].shape[0]
    d = spec.resolve_d(k, m)
    batch = x.shape[:-1]
    table = lut.produce(x.reshape(-1, k).t(), d, dtype=torch.float32,
                        codebook=params.get("codebook"))
    idx = (params["idx"] if spec.storage == "packed_idx"
           else packing.indices_from_storage(params["u8"], d, k))
    # gather a slab of about CONSUME_SLAB table entries per step: a few
    # ops per GeMM, so a CUDA graph of the step stays small
    chunk = max(1, CONSUME_SLAB // (m * table.shape[2]))
    y = lut.consume(table, idx, scales=params["scales"],
                    scale_block=spec.scale_block, d=d, chunk=chunk)
    return y.t().reshape(*batch, m).to(x.dtype)


register_backend(
    "dense", modes=("bf16",), run=run_dense, priority=100,
    description="dense matmul (the paper's naive GeMM, Eq. 14)")

# the last-resort path for quantized modes: below every other backend,
# selected only when the rest of the ladder is quarantined.  It computes
# what int4_torch does (dequantize, then matmul), as the reference's
# dense_fallback computes what its int4_jnp does, for msgemm weights too.
register_backend(
    "dense_fallback", modes=("msgemm", "int4_dequant"),
    run=run_int4_torch, priority=-100,
    description="dequantize -> dense matmul; quarantine-safe bottom rung "
                "of the degradation ladder (kernel -> torch -> dense)")

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

register_backend(
    "msgemm_torch", modes=("msgemm",), run=run_msgemm_torch, priority=50,
    description="produce/consume msGeMM in plain torch (per-chunk scales)")

register_backend(
    "int4_torch", modes=("int4_dequant",), run=run_int4_torch, priority=50,
    description="dequantize (uniform grid or learned codebook) -> matmul")
