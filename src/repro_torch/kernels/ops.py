"""Public wrappers around the msGeMM, int4 GeMM and flash-attention
kernels; port of repro.kernels.ops.

The GeMM wrappers handle the vector-x squeeze, the epilogue operands in
the kernels' (m, b) column layout, the code->value table, and the Hopper
tile choice.  Those kernels mask ragged rows, columns and k themselves,
so nothing is padded to tile multiples there (the TPU wrapper had to pad
every operand).  None of the TPU VMEM budgeting carries over.
:func:`flash_attention` keeps the reference's public layout and its
padding, which decides what queries past the last key see.
"""

from __future__ import annotations

import functools
import heapq

import torch

from repro_torch.core import packing
from repro_torch.core.epilogue import Epilogue, torch_dtype
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import int4_matmul as _i4
from repro_torch.kernels import msgemm as _ms
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels.int4_matmul import Int4Tiles
from repro_torch.kernels.msgemm import Tiles

# every kernel's module, whose ``launches`` counts its launches
KERNELS = {"msgemm": _ms, "int4_matmul": _i4, "paged_attention": _pa,
           "flash_attention": _fa}

# H100 SXM streaming multiprocessors.  A constant, not a device query, so
# the CPU path picks the same contraction split (and so the same bits) as
# the card.
NUM_SMS = 132
SM_SMEM = 233_472  # shared memory of one SM; each block also takes 1 KiB
STAGE_WORDS = 8192  # indices in one staged tile: rows x stage
BLOCK_OVERHEAD = 2  # a block's fixed cost (prologue, epilogue) in chunks
# a block's fixed cost (x and scale staging, epilogue) in 256-code steps
# of the int4 kernel: at a fixed share of steps an SM, its time grew by
# about a step for every further block (gemma-2b's down at b = 1, 4 to 64
# splits; PERF.md section 6)
INT4_BLOCK_OVERHEAD = 1
# m x kc from which 2048-row blocks beat 1024-row ones at tb = 1 (on the
# card: gemma-2b gate and down, 11.2M, faster; wq, 1.4M, slower)
ROW_CHUNKS_2048 = 4_000_000


@functools.lru_cache(maxsize=None)
def msgemm_tiles(m: int, kc: int, b: int, d: int, scale_block: int) -> Tiles:
    """Hopper tile choice for (m rows, kc LUT chunks, b columns), a
    function of the shape alone.

    tb: the batch columns one table serves (4, or 1 for b = 1 and d = 4);
    b > 4 runs as several column tiles, each with its own table.  rows:
    1024 a block (512 for m <= 512), so one table build serves as many
    rows as a block's shared memory allows at tb = 4 (two 64 KiB tables
    and two staged index tiles); at tb = 1 the tables are a quarter of
    that and 2048 rows fit, which pays once the GeMM has enough row-chunks
    (ROW_CHUNKS_2048) for the split to fill the card with fewer row tiles.
    stage and tj: :func:`split_tiles`.
    """
    tb = 1 if b == 1 or d == 4 else 4
    rows = (512 if m <= 512 else
            2048 if tb == 1 and m * kc >= ROW_CHUNKS_2048 else 1024)
    return split_tiles(m, kc, b, d, scale_block, tb=tb, rows=rows)


def _makespan(row_tiles: int, col_tiles: int, works: list[int],
              slots: int) -> int:
    """When the last block ends, if blocks start in launch order (row tile
    fastest, then split, then column tile) on the first free of ``slots``
    and split s's blocks take ``works[s]``."""
    free = [0] * slots
    for _ in range(col_tiles):
        for w in works:
            for _ in range(row_tiles):
                heapq.heapreplace(free, free[0] + w)
    return max(free)


def split_tiles(m: int, kc: int, b: int, d: int, scale_block: int, *,
                tb: int, rows: int) -> Tiles:
    """The rest of a tile choice once tb and rows are fixed: the index
    stage of STAGE_WORDS indices, and tj, whole scale blocks per
    contraction split, the one whose blocks end soonest on NUM_SMS SMs
    (as many blocks an SM as this variant's shared memory allows), a block
    costing its chunks plus BLOCK_OVERHEAD; ties go to fewer splits."""
    stage = STAGE_WORDS // rows
    cpb = scale_block // d
    nsb = -(-kc // cpb)
    tiles = Tiles(tb=tb, rows=rows, stage=stage, tj=nsb * cpb)
    gx, _, gz = _ms.grid(m, kc, b, tiles)
    smem = _ms.smem_bytes(d, tb, rows, stage)
    slots = NUM_SMS * max(1, min(2048 // _ms.THREADS,
                                 SM_SMEM // (smem + 1024)))
    best = None
    for tj in sorted({-(-nsb // w) * cpb for w in
                      range(1, min(nsb, 2 * slots // (gx * gz) + 1) + 1)},
                     reverse=True):
        works = [min(tj, kc - j) + BLOCK_OVERHEAD for j in range(0, kc, tj)]
        span = _makespan(gx, gz, works, slots)
        if best is None or span < best[0]:
            best = (span, tj)
    return tiles._replace(tj=best[1])


def launch_counts() -> dict[str, int]:
    return {name: mod.launches for name, mod in KERNELS.items()}


@functools.lru_cache(maxsize=None)
def _int4_values(device: torch.device) -> torch.Tensor:
    return packing.b_values(torch.float32, device)


def msgemm(idx: torch.Tensor, x: torch.Tensor, d: int, *,
           scales: torch.Tensor, scale_block: int = 36,
           codebook: torch.Tensor | None = None, tiles: Tiles | None = None,
           epilogue: Epilogue | None = None,
           bias: torch.Tensor | None = None,
           residual: torch.Tensor | None = None) -> torch.Tensor:
    """y (m, b) = epilogue(dequant(idx) @ x (k, b)) through the kernel
    (CUDA tensors) or its plain version (CPU tensors).

    idx (m, ceil(k/d)) int32 LUT indices; x (k, b) or (k,); scales (m,
    ceil(k/scale_block)); codebook: optional (16,) value table (entry 0 must
    be 0), the uniform int4 grid when None.  ``epilogue`` is fused:
    ``bias`` is (m,), ``residual`` (m, b) column layout.  The output dtype
    is ``epilogue.out_dtype``, float32 when unset.
    """
    ep = epilogue or Epilogue()
    if ep.bias != (bias is not None) or ep.residual != (residual is not None):
        raise ValueError("bias/residual arrays must match the epilogue flags "
                         f"(epilogue={ep}, bias given={bias is not None}, "
                         f"residual given={residual is not None})")
    squeeze = x.ndim == 1
    if squeeze:
        x = x[:, None]
        if residual is not None and residual.ndim == 1:
            residual = residual[:, None]
    m, kc = idx.shape
    if tiles is None:
        tiles = msgemm_tiles(m, kc, x.shape[1], d, scale_block)
    values = (_int4_values(x.device) if codebook is None
              else codebook.to(torch.float32).contiguous())
    f32 = lambda t: None if t is None else t.to(torch.float32)  # noqa: E731
    # x and the residual go as they are when the kernel reads their type
    # (the engine's bf16 activations); the widening to f32 is exact
    own = lambda t: t if t is None or t.dtype in _ms.OUT_TYPES \
        else f32(t)  # noqa: E731
    idx = idx.to(torch.int32).contiguous()
    if idx.data_ptr() % 16:  # the kernel copies 16-byte vectors of idx
        idx = idx.clone()
    y = _ms.msgemm(
        idx, own(x),
        f32(scales).contiguous(), values, d=d, scale_block=scale_block,
        tiles=tiles, act=ep.act,
        bias=None if bias is None else f32(bias).contiguous(),
        residual=own(residual),
        out_dtype=torch_dtype(ep.out_dtype) or torch.float32)
    return y[:, 0] if squeeze else y


@functools.lru_cache(maxsize=None)
def int4_tiles(m: int, k: int, b: int) -> Int4Tiles:
    """Hopper tile choice for the int4 kernel, a function of the shape
    alone: tb columns per block (the batch, rounded up to 1, 2, 4 or 8);
    nsplit, the contraction splits (whole 256-code steps) whose blocks
    end soonest on NUM_SMS SMs; and an x tile of tk codes, a split's
    range at most, that keeps tb·tk floats at 32 KiB of shared memory.

    The split's cost model: the blocks spread evenly over the SMs, and an
    SM takes its share of blocks times a block's steps plus
    INT4_BLOCK_OVERHEAD, but never less than two blocks' worth (one block
    of 8 warps cannot hide the loads' latency); ties go to fewer splits.
    So gemma-2b's down (64 row tiles over 64 steps at b = 4) takes 4
    splits and wk/wv (8 row tiles) 8, while gate/up (512 row tiles) keep
    one: the fewest splits that bring the grid to about two blocks an SM,
    where the blocks divide evenly over the SMs.  On the card it picks
    the fastest split count of ``chip_smoke.py --sweep int4``, or one
    within a few per cent, at every engine shape (PERF.md section 6)."""
    tb = next(t for t in (1, 2, 4, 8) if t >= min(b, 8))
    blocks = -(-m // _i4.rows_per_block(tb)) * -(-b // tb)
    steps = -(-max(k, 1) // _i4.STEP)
    best = None
    for n in range(1, steps + 1):
        per, splits = _i4.split_steps(k, n)
        cost = (max(2, -(-blocks * splits // NUM_SMS))
                * (per + INT4_BLOCK_OVERHEAD))
        if splits == n and (best is None or cost < best[0]):
            best = (cost, per, n)
    _, per, nsplit = best
    return Int4Tiles(tb=tb, tk=min(per * _i4.STEP, 8192 // tb),
                     nsplit=nsplit)


def int4_matmul(u8: torch.Tensor, scales: torch.Tensor, x: torch.Tensor, *,
                scale_block: int = 32, tiles: Int4Tiles | None = None,
                epilogue: Epilogue | None = None,
                bias: torch.Tensor | None = None,
                residual: torch.Tensor | None = None) -> torch.Tensor:
    """y (m, b) = epilogue(dequant(packed u8 (m, k/2)) @ x (k, b)) through
    the int4 kernel (CUDA tensors) or its plain version (CPU tensors).

    scales (m, ceil(k/scale_block)); x (k, b) or (k,).  ``epilogue`` is
    fused: ``bias`` is (m,), ``residual`` (m, b) column layout.  The output
    dtype is ``epilogue.out_dtype``, float32 when unset.  A ragged last
    scale block and odd k are masked in the kernel, not padded.
    """
    ep = epilogue or Epilogue()
    if ep.bias != (bias is not None) or ep.residual != (residual is not None):
        raise ValueError("bias/residual arrays must match the epilogue flags "
                         f"(epilogue={ep}, bias given={bias is not None}, "
                         f"residual given={residual is not None})")
    squeeze = x.ndim == 1
    if squeeze:
        x = x[:, None]
        if residual is not None and residual.ndim == 1:
            residual = residual[:, None]
    if tiles is None:
        tiles = int4_tiles(u8.shape[0], x.shape[0], x.shape[1])
    f32 = lambda t: None if t is None else t.to(torch.float32)  # noqa: E731
    # x and the residual go as they are when the kernel reads their type
    # (the engine's bf16 activations); the widening to f32 is exact
    own = lambda t: t if t is None or t.dtype in _ms.OUT_TYPES \
        else f32(t)  # noqa: E731
    y = _i4.int4_matmul(
        u8.contiguous(), f32(scales).contiguous(), own(x),
        scale_block=scale_block, tiles=tiles, act=ep.act,
        bias=None if bias is None else f32(bias).contiguous(),
        residual=own(residual),
        out_dtype=torch_dtype(ep.out_dtype) or torch.float32)
    return y[:, 0] if squeeze else y


def _round_up(v: int, t: int) -> int:
    return -(-v // t) * t


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0, kernel=None) -> torch.Tensor:
    """Multi-head attention through the flash kernel (CUDA tensors) or its
    plain version (CPU tensors).

    q (B, Sq, H, dh), k/v (B, Skv, Hk, dh) with H % Hk == 0 -> (B, Sq, H,
    dh) in q's dtype.  GQA kv heads are not repeated: the kernel maps
    query head h to kv head h // (H // Hk).  Sq and Skv are padded with
    zeros to the lengths the reference pads to, multiples of its TPU tile
    min(128, round_up(S, 8)): under causal masking a query past the last
    key then sees the zero keys up to its own position, as in the
    reference.  The port's kernel tiles (``flash_tiles``) are its own; the
    kernel masks the ragged edge past the padded lengths.  A non-causal
    call needs Skv a multiple of that tile (ValueError otherwise, where the
    reference asserts).  ``kernel``: the native-layout function to run
    (default: by device); checks pass ``flash_attention_plain``."""
    B, Sq, H, dh = q.shape
    Skv, Hk = k.shape[1], k.shape[2]
    if H % Hk:
        raise ValueError(f"{H} query heads do not group onto {Hk} kv heads")
    sqp = _round_up(Sq, min(128, _round_up(Sq, 8)))
    skp = _round_up(Skv, min(128, _round_up(Skv, 8)))
    if not causal and skp != Skv:
        raise ValueError(f"non-causal flash attention needs Skv={Skv} a "
                         f"multiple of its tile (padded length {skp})")
    pad = torch.nn.functional.pad
    qt = pad(q, (0, 0, 0, 0, 0, sqp - Sq)).transpose(1, 2).contiguous()
    kt = pad(k, (0, 0, 0, 0, 0, skp - Skv)).transpose(1, 2).contiguous()
    vt = pad(v, (0, 0, 0, 0, 0, skp - Skv)).transpose(1, 2).contiguous()
    o = (kernel or _fa.flash_attention)(
        qt, kt, vt, causal=causal, window=window, softcap=softcap)
    return o.transpose(1, 2)[:, :Sq]
