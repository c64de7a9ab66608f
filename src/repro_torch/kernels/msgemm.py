"""msGeMM kernel for Hopper (``csrc/msgemm.cu``), its plain PyTorch
version, and its launch counter.

Replaces the Pallas TPU kernel ``repro/kernels/msgemm.py::msgemm_pallas``:
the fused grid (``_kernel_fused`` + ``_consume_tile``, pallas_call at line
252) and, with the identity epilogue, the legacy grid (``_kernel_legacy``,
pallas_call at line 212), which differ only in where the accumulator lives.

What bounds it on an H100.  Per call the function must read the int32
LUT indices (m·ceil(k/d)·4 B), the scales, x and the residual in their
own type, and write the output; at 3.35 TB/s the index bytes dominate
(5.6 MB for a 2048x2048 linear at d=3: 1.7 µs).  Its operations are the
LUT produce, per chunk and column 16·d distinct products and about one
add per entry, plus m·ceil(k/d)·b gather-adds, all in f32 outside the
tensor cores (67 TFLOP/s).  Both bounds are about 10x below its time: at
one 512-thread block per SM a chunk goes to building its 16^d·TB table
values in shared memory (about a third), to the staged index copies and
the gathers' bank conflicts, and to fixed costs (launch, the split
reduction, the barrier a chunk); ``tools/msgemm_probe.py`` measures the
split (PERF.md, PR 14).

What the design does about it.
* One table per chunk serves a block of 1024 rows, built once, as the TPU
  kernel builds it on the first m-step only; the contraction is split
  along whole scale blocks so that the blocks fill the 132 SMs, and a
  second small kernel adds the splits in j order and applies the
  epilogue.  (Sharing one build across a thread block cluster, with the
  entries stored into every block's shared memory or read from the
  builder's, and splitting builder and gatherer warps were measured
  slower and left out.)
* Cheap produce in the reference's op order: each thread's entries share
  their last two codes, whose products it takes once a chunk; the rest of
  each sum is formed in registers, one float4 store an entry,
  neighbouring threads on neighbouring entries.
* Two table buffers: chunk j+1's table is built while chunk j's is
  gathered, one block barrier per chunk in place of three.
* Staged, coalesced index loads: a block copies its (rows x ``stage``)
  index tile into shared memory with 16-byte ``cp.async`` copies (L2
  only) a stage ahead, from the 16-byte boundary at or below each row's
  first chunk; x of a stage is staged beside it.  (TMA cannot: the index
  rows are 2,732 B apart at k = 2048, not a multiple of 16.)
* x and the residual are read in their own type (bf16 from the engine)
  and widened in registers, so the wrapper copies nothing.
* d=4's 256 KiB table does not fit a block's 227 KB of shared memory: it
  is built in a device-memory scratch per block, at TB = 1.

Op order (see ``csrc/msgemm.cu``) is the Pallas kernel's with one j-tile
per split: gathers summed in chunk order within a scale block, one scale
multiply per block, splits added in j order, then
``cast(act(total + bias) + residual)``.  :func:`msgemm_plain` repeats it
with separate PyTorch ops, so kernel and plain version agree bit for bit
except inside ``tanh``/``exp`` of the gelu/silu epilogues.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.core import lut as lut_mod
from repro_torch.core.epilogue import act_fn
from repro_torch.device import is_fake
from repro_torch.kernels import nvcc

# the codes of csrc/epilogue.cuh's Act and DType enums
ACTS = {"none": 0, "relu": 1, "gelu": 2, "silu": 3}
OUT_TYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
THREADS = 512  # kThreads in csrc/msgemm.cu
SMEM_LIMIT = 232_448  # shared memory a block may use on an H100 (227 KB)
_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 12
             + [ctypes.c_longlong] * 6
             + [ctypes.c_int] * 4 + [ctypes.c_void_p])

# Kernel launches since the last reset; the main path's callers set it to
# 0, drive the model, and read it to prove every GeMM went through the
# kernel.  Only msgemm_cuda adds to it.
launches = 0


class Tiles(NamedTuple):
    """One launch's work split (``ops.msgemm_tiles`` picks it).

    tb: batch columns per block (1 or 4; 1 at d = 4).  rows: output rows
    per block, 512·rpt with rpt in 1, 2, 4.  stage: LUT chunks per staged
    index tile (4, 8, 16 or 32).  tj: LUT chunks per contraction split, a
    multiple of scale_block // d.  Only ``tj`` changes the arithmetic (the
    split sums are added in j order); the plain version takes it too, so
    both devices give the same bits.
    """

    tb: int
    rows: int
    stage: int
    tj: int


def smem_bytes(d: int, tb: int, rows: int, stage: int) -> int:
    """Dynamic shared memory of one block, the formula of ``csrc/msgemm.cu``
    (``smem_bytes``), in 4-byte words times 4: two 16^d x tb tables (d <
    4), two staged x tiles (stage x d x tb), 16 code values, two staged
    index tiles of rows x (stage + 4) words (a row's 16-byte vectors from
    the boundary at or below its first chunk)."""
    table = 2 * 16**d * tb if d < 4 else 0
    return 4 * (table + 2 * stage * d * tb + 16 + 2 * rows * (stage + 4))


def grid(m: int, kc: int, b: int, tiles: Tiles) -> tuple[int, int, int]:
    """The kernel's grid: row tiles, contraction splits, column tiles."""
    return -(-m // tiles.rows), -(-kc // tiles.tj), -(-b // tiles.tb)


def check_tiles(tiles: Tiles, d: int, cpb: int) -> None:
    """Raise unless ``tiles`` names a variant ``csrc/msgemm.cu`` builds and
    a block of it fits the card's shared memory."""
    t = tiles
    ok = (t.tb in ((1,) if d == 4 else (1, 4))
          and t.rows in tuple(THREADS * r for r in (1, 2, 4))
          and t.stage in (4, 8, 16, 32)
          and t.tj > 0 and t.tj % cpb == 0
          and smem_bytes(d, t.tb, t.rows, t.stage) <= SMEM_LIMIT)
    if not ok:
        raise ValueError(f"bad tiles {tiles} for d = {d}, "
                         f"scale_block // d = {cpb}")


def _check(idx, x, scales, values, d, scale_block, bias, residual):
    """Validate shapes/dtypes/devices; returns (m, k, kc, b, cpb, nsb)."""
    if idx.dim() != 2 or x.dim() != 2:
        raise ValueError(f"idx (m, kc) and x (k, b) must be 2-D, got "
                         f"{tuple(idx.shape)} and {tuple(x.shape)}")
    m, kc = idx.shape
    k, b = x.shape
    if not 1 <= d <= 4 or scale_block % d:
        raise ValueError(f"need 1 <= d <= 4 and d | scale_block "
                         f"(d={d}, scale_block={scale_block})")
    cpb = scale_block // d
    nsb = -(-kc // cpb)
    if kc != -(-k // d):
        raise ValueError(f"idx has {kc} chunks, x has k={k} (d={d})")
    if tuple(scales.shape) != (m, nsb):
        raise ValueError(f"scales {tuple(scales.shape)} != {(m, nsb)}")
    if tuple(values.shape) != (16,):
        raise ValueError(f"values {tuple(values.shape)} != (16,)")
    if bias is not None and tuple(bias.shape) != (m,):
        raise ValueError(f"bias {tuple(bias.shape)} != {(m,)}")
    if residual is not None and tuple(residual.shape) != (m, b):
        raise ValueError(f"residual {tuple(residual.shape)} != {(m, b)}")
    dev = idx.device
    for name, t in (("x", x), ("scales", scales), ("values", values),
                    ("bias", bias), ("residual", residual)):
        if t is not None and t.device != dev:
            raise ValueError(f"{name} on {t.device}, idx on {dev}")
    return m, k, kc, b, cpb, nsb


def msgemm_cuda(idx: torch.Tensor, x: torch.Tensor, scales: torch.Tensor,
                values: torch.Tensor, *, d: int, scale_block: int,
                tiles: Tiles, act: str = "none",
                bias: torch.Tensor | None = None,
                residual: torch.Tensor | None = None,
                out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """y (m, b) = cast(act(dequant(idx) @ x + bias) + residual) on the GPU.

    idx (m, ceil(k/d)) int32 contiguous; x (k, b) float32, bfloat16 or
    float16, any strides; scales (m, ceil(k/scale_block)) float32
    contiguous; values (16,) the code->value table; bias (m,) float32;
    residual (m, b) float32, bfloat16 or float16 (any strides).  The
    result is an (m, b) view of a (b, m) buffer, so the model's row-major
    layout is its transpose without a copy.
    """
    global launches
    m, k, kc, b, cpb, nsb = _check(idx, x, scales, values, d, scale_block,
                                   bias, residual)
    if idx.device.type != "cuda":
        raise ValueError(f"msgemm_cuda needs CUDA tensors, got {idx.device}")
    if idx.dtype != torch.int32 or not idx.is_contiguous() \
            or idx.data_ptr() % 16:
        raise ValueError("idx must be contiguous int32, 16-byte aligned")
    for name, t in (("x", x), ("residual", residual)):
        if t is not None and t.dtype not in OUT_TYPES:
            raise ValueError(f"{name} must be float32, bfloat16 or float16, "
                             f"got {t.dtype}")
    for name, t in (("scales", scales), ("values", values), ("bias", bias)):
        if t is not None and t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if out_dtype not in OUT_TYPES:
        raise ValueError(f"unsupported out_dtype {out_dtype}")
    check_tiles(tiles, d, cpb)
    gx, nsplit, gz = grid(m, kc, b, tiles)
    dev = idx.device
    out = torch.empty((b, m), dtype=out_dtype, device=dev).t()
    ws = (torch.empty((nsplit, b, m), dtype=torch.float32, device=dev)
          if nsplit > 1 else None)
    lut_scratch = None
    if d == 4:  # two tables per block of the grid
        lut_scratch = torch.empty(gx * nsplit * gz * 2 * 16**4 * tiles.tb,
                                  dtype=torch.float32, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    rs = residual.stride() if residual is not None else (0, 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = nvcc.load("msgemm", "msgemm_launch", _ARGTYPES)(
        ptr(idx), ptr(x), ptr(scales), ptr(values), ptr(bias), ptr(residual),
        ptr(out), ptr(ws), ptr(lut_scratch),
        m, k, kc, b, d, cpb, nsb, tiles.tj, nsplit, tiles.tb,
        tiles.rows // THREADS, tiles.stage.bit_length() - 1,
        x.stride(0), x.stride(1), rs[0], rs[1], out.stride(0), out.stride(1),
        ACTS[act], OUT_TYPES[out_dtype], OUT_TYPES[x.dtype],
        OUT_TYPES[residual.dtype] if residual is not None else 0, stream)
    if err != 0:
        raise RuntimeError(f"msgemm kernel launch failed: CUDA error {err} "
                           f"(m={m}, k={k}, b={b}, d={d}, tiles={tiles})")
    launches += 1
    return out


def epilogue_cols(acc: torch.Tensor, act: str, bias, residual,
                  out_dtype: torch.dtype) -> torch.Tensor:
    """The fused writeback in the kernels' (m, b) column layout:
    ``cast(act(acc + bias) + residual)`` on the f32 accumulator."""
    if bias is not None:
        acc = acc + bias.to(torch.float32)[:, None]
    acc = act_fn(act)(acc)
    if residual is not None:
        acc = acc + residual.to(torch.float32)
    return acc.to(out_dtype)


def msgemm_plain(idx: torch.Tensor, x: torch.Tensor, scales: torch.Tensor,
                 values: torch.Tensor, *, d: int, scale_block: int,
                 tiles: Tiles, act: str = "none",
                 bias: torch.Tensor | None = None,
                 residual: torch.Tensor | None = None,
                 out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The kernel's function in plain PyTorch, in the kernel's op order
    (the counterpart of ``repro.kernels.ref.msgemm_tiled_ref``, vectorised
    over rows and columns; one LUT per scale block, not the whole k)."""
    m, k, kc, b, cpb, nsb = _check(idx, x, scales, values, d, scale_block,
                                   bias, residual)
    dev = idx.device
    xp = torch.zeros((kc * d, b), dtype=torch.float32, device=dev)
    xp[:k] = x.to(torch.float32)
    xc = xp.reshape(kc, d, b)
    basis = values.to(torch.float32)[lut_mod.tuple_codes(d, dev)]  # (N, d)
    sc = scales.to(torch.float32)
    total = None
    for j0 in range(0, kc, tiles.tj):  # one contraction split
        acc = torch.zeros((m, b), dtype=torch.float32, device=dev)
        for c0 in range(j0, min(j0 + tiles.tj, kc), cpb):  # one scale block
            c1 = min(c0 + cpb, kc)
            # lut[c, n, col] = sum_r basis[n, r] * x[(c0+c)*d + r, col]
            lut = basis[None, :, 0, None] * xc[c0:c1, 0, None, :]
            for r in range(1, d):
                lut = lut + basis[None, :, r, None] * xc[c0:c1, r, None, :]
            part = torch.zeros((m, b), dtype=torch.float32, device=dev)
            for c in range(c1 - c0):
                part = part + lut[c].index_select(0, idx[:, c0 + c].long())
            acc = acc + part * sc[:, c0 // cpb, None]
        total = acc if total is None else total + acc
    return epilogue_cols(total, act, bias, residual, out_dtype)


def msgemm_fake(idx: torch.Tensor, x: torch.Tensor, scales: torch.Tensor,
                values: torch.Tensor, *, d: int, scale_block: int,
                tiles: Tiles, act: str = "none", bias=None, residual=None,
                out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The kernel's call on fake tensors: what :func:`msgemm_cuda`
    allocates (its output, its k-split workspace and, at d = 4, its table
    scratch), with no launch.  The plain version's tables, which the
    kernel keeps in shared memory, are never allocated."""
    m, k, kc, b, cpb, nsb = _check(idx, x, scales, values, d, scale_block,
                                   bias, residual)
    gx, nsplit, gz = grid(m, kc, b, tiles)
    out = torch.empty((b, m), dtype=out_dtype, device=idx.device).t()
    if nsplit > 1:
        torch.empty((nsplit, b, m), dtype=torch.float32, device=idx.device)
    if d == 4:
        torch.empty(gx * nsplit * gz * 2 * 16**4 * tiles.tb,
                    dtype=torch.float32, device=idx.device)
    return out


def msgemm(idx, x, scales, values, **kw) -> torch.Tensor:
    """Route by device: the kernel for CUDA tensors, the plain version for
    CPU tensors, the kernel's allocations alone for fake ones
    (:func:`msgemm_fake`); anything else raises.  There is no fallback
    from one to the other."""
    if is_fake(x):
        return msgemm_fake(idx, x, scales, values, **kw)
    if x.device.type == "cuda":
        return msgemm_cuda(idx, x, scales, values, **kw)
    if x.device.type == "cpu":
        return msgemm_plain(idx, x, scales, values, **kw)
    raise ValueError(f"msgemm: unsupported device {x.device}")
