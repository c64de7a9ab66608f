"""Blocked int4 dequantize-then-dot GeMM for Hopper
(``csrc/int4_matmul.cu``), its plain PyTorch version, and its launch
counter.

Replaces the Pallas TPU kernel
``repro/kernels/int4_matmul.py::int4_matmul_pallas``: the fused grid
(``_kernel_fused``, pallas_call at line 165) and, with the identity
epilogue, the legacy grid (``_kernel_legacy``, pallas_call at line 133);
both run ``_dequant_dot``.  It is the baseline the paper's msGeMM is
measured against: unpack two codes per byte (hi nibble first), map them
two's complement (``c <= 7 ? c : c - 16``), scale by the row-block scale,
accumulate in f32 over all of k, then ``cast(act(acc + bias) +
residual)``.

What bounds it on an H100.  Per call it must read 0.5 B per weight plus
the f32 scales, x, and write the output; at decode batch sizes that is
far below the card's operations-to-bytes balance, so the bytes bound it.
For gemma-2b's gate/up (16384x2048) the codes are 16.8 MB and the scales
3.7 MB: about 6 µs at 3.35 TB/s, half the byte bound of msGeMM's int32
indices at d = 3 (m·ceil(k/3)·4 B, 44.7 MB: about 14.5 µs including its
scales).  That decides the paper's comparison on this card: msGeMM's LUT
indices carry 10.7 bits per weight where the packed codes carry 4.

What the design does about it.
* Split k to fill the card.  A GeMM with few row tiles (gemma-2b's down,
  64 of them over k = 16384; wk and wv, 8) would leave most of the 132
  SMs idle, so the contraction is split in whole 256-code steps, the
  grid being (row tiles, splits, column tiles), as many splits as make
  the blocks end soonest (``ops.int4_tiles``); a second small kernel adds
  the splits' f32 partials in split order and applies the epilogue.
* Few instructions a code.  Blocks of 8 warps own 32 rows (4 a warp; 16
  rows, 2 a warp, at 8 batch columns, for the registers) and up to 8
  batch columns.  A code becomes its float with one byte permute and one
  add (an int-to-float conversion runs at an eighth of the fma rate), and
  the scale is applied once per segment (a lane's codes inside one scale
  block), not before every product: one fma per code and column with
  bf16 or f16 x.
* Shared memory that keeps up.  A block stages its split's x, widened to
  f32, in tiles laid out so that a lane reads 4 columns of one code with
  one conflict-free vector load, and each value read serves a warp's 4
  rows (shared memory's 128 bytes a clock would bound the kernel at
  fewer); the tile's scales for the block's rows are staged beside it.
* Loads ahead.  Each lane streams 4 packed bytes of each of its rows per
  256 codes (coalesced 128-byte warp loads), one step ahead of their
  arithmetic.
* x and the residual are read in their own type (f32, or the engine's
  bf16 or f16) and widened in registers, so the wrapper copies nothing.
* A stack of experts in one launch.  The MoE block's expert linears
  (u8 (E, m, k/2), scales (E, m, nsb), x (E, k, b) -> (E, m, b)) run as
  E independent GeMMs whose operands sit at per-expert strides: the grid's
  third axis walks experts times column tiles, the split workspace is
  per expert, and ``ops.int4_tiles`` counts E times the blocks.  The
  reference vmaps ``linear_apply`` over the experts (its ``int4_jnp``
  backend, a dequantize then matmul, ran them on the TPU); here the whole
  stack's bytes stream through one grid.
No tensor cores: ``mma``/``wgmma`` on dequantized bf16 tiles is the
kernel's later work.  Ragged k (a last scale block shorter than
``scale_block``, an odd k) and ragged rows and columns are masked in the
kernel; nothing is padded.

Op order (see ``csrc/int4_matmul.cu``): per split, lane L of a warp sums
the codes k = 256·S + 8·L + t in k order, ``seg = seg + b(code)·x``
within a segment (separate round-to-nearest multiply and add; with bf16
or f16 x the product is exact, so an fma gives the same bits) and
``acc = acc + seg·scale`` when the segment ends (at the end of its scale
block or of the split); the 32 lane sums meet in an xor-shuffle tree;
the splits' sums are added in split order; then the epilogue.
:func:`int4_matmul_plain` repeats exactly these sums, so the kernel and
the plain version agree bit for bit except inside the gelu/silu
epilogues' tanh/exp.  The reference scales each weight before the dot,
so on random floats the two differ in rounding order only.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.device import is_fake
from repro_torch.kernels import nvcc
from repro_torch.kernels.msgemm import ACTS, OUT_TYPES, epilogue_cols

LANES = 32   # lanes of a warp: the kernel's k interleave
WORD = 8     # codes per lane per 256-code step (4 packed bytes)
STEP = LANES * WORD
SMEM_BLOCK = 48 * 1024  # shared memory a block stages at most (the
                        # default a launch may take without opting in)
_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 12
             + [ctypes.c_longlong] * 6
             + [ctypes.c_int] * 4
             + [ctypes.c_uint, ctypes.c_int, ctypes.c_int]
             + [ctypes.c_longlong] * 2 + [ctypes.c_void_p])
MAX_GRID_Z = 65535  # experts x column tiles of one launch

# Kernel launches since the last reset; only int4_matmul_cuda adds to it,
# once a call (a split call's reduction kernel is not counted apart).
launches = 0


class Int4Tiles(NamedTuple):
    """One launch's work split (``ops.int4_tiles`` picks it).

    tb: batch columns per block (1, 2, 4 or 8); tk: codes of x held in
    shared memory at a time (a multiple of 256); nsplit: contraction
    splits, each a range of whole 256-code steps (:func:`split_steps`).
    Only ``nsplit`` changes the arithmetic (a segment ends where a split
    ends, and the splits' sums are added in order); the plain version
    takes it too, so both devices give the same bits.
    """

    tb: int
    tk: int
    nsplit: int


def rows_per_block(tb: int) -> int:
    """Output rows of a block: 8 warps of 4 rows, of 2 at tb = 8
    (``rows_per_warp`` in ``csrc/int4_matmul.cu``)."""
    return 8 * (2 if tb == 8 else 4)


def smem_bytes(tb: int, tk: int, scale_block: int) -> int:
    """Shared memory of one block (``smem_bytes`` in
    ``csrc/int4_matmul.cu``): the x tile, tb x tk f32, and the scales of
    the tile's scale blocks (at most tk // scale_block + 2) for the
    block's rows."""
    return 4 * (tb * tk + rows_per_block(tb) * (tk // scale_block + 2))


def stage_codes(tiles: Int4Tiles, scale_block: int) -> int:
    """The x tile the kernel stages: ``tiles.tk`` codes, or fewer (whole
    steps, at least one) where the tile's scales would take the block
    past SMEM_BLOCK bytes (small scale blocks)."""
    tk = tiles.tk
    while tk > STEP and smem_bytes(tiles.tb, tk, scale_block) > SMEM_BLOCK:
        tk -= STEP
    return tk


def split_steps(k: int, nsplit: int) -> tuple[int, int]:
    """(256-code steps per split, splits) when k is cut into ``nsplit``
    ranges of whole steps, at most one a step; ranges that would be empty
    are dropped."""
    steps = -(-max(k, 1) // STEP)
    per = -(-steps // max(1, min(nsplit, steps)))
    return per, -(-steps // per)


def _check(u8, scales, x, scale_block, bias, residual):
    """Validate shapes and devices; returns (E, m, k, b, nsb), E = 0 for
    one linear (2-D operands), the expert count for a stack (3-D)."""
    if u8.dim() not in (2, 3) or x.dim() != u8.dim():
        raise ValueError(f"u8 (m, k/2) and x (k, b), or an expert stack u8 "
                         f"(E, m, k/2) and x (E, k, b), got "
                         f"{tuple(u8.shape)} and {tuple(x.shape)}")
    E = u8.shape[0] if u8.dim() == 3 else 0
    if E and (x.shape[0] != E or E < 1):
        raise ValueError(f"u8 stacks {E} experts, x {x.shape[0]}")
    if E and (bias is not None or residual is not None):
        raise ValueError("an expert stack takes no bias or residual")
    m, kb = u8.shape[-2:]
    k, b = x.shape[-2:]
    if kb != -(-k // 2):
        raise ValueError(f"u8 has {kb} bytes a row, x has k={k}")
    if scale_block < 1:
        raise ValueError(f"scale_block={scale_block} must be >= 1")
    nsb = -(-k // scale_block)
    lead = (E,) if E else ()
    if tuple(scales.shape) != (*lead, m, nsb):
        raise ValueError(f"scales {tuple(scales.shape)} != "
                         f"{(*lead, m, nsb)}")
    if bias is not None and tuple(bias.shape) != (m,):
        raise ValueError(f"bias {tuple(bias.shape)} != {(m,)}")
    if residual is not None and tuple(residual.shape) != (m, b):
        raise ValueError(f"residual {tuple(residual.shape)} != {(m, b)}")
    for name, t in (("x", x), ("scales", scales), ("bias", bias),
                    ("residual", residual)):
        if t is not None and t.device != u8.device:
            raise ValueError(f"{name} on {t.device}, u8 on {u8.device}")
    return E, m, k, b, nsb


def int4_matmul_cuda(u8: torch.Tensor, scales: torch.Tensor,
                     x: torch.Tensor, *, scale_block: int, tiles: Int4Tiles,
                     act: str = "none", bias: torch.Tensor | None = None,
                     residual: torch.Tensor | None = None,
                     out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """y (m, b) = cast(act(dequant(u8) @ x + bias) + residual) on the GPU.

    u8 (m, ceil(k/2)) uint8 contiguous; scales (m, ceil(k/scale_block))
    f32 contiguous; x (k, b) float32, bfloat16 or float16, any strides;
    bias (m,) f32 contiguous; residual (m, b) float32, bfloat16 or
    float16, any strides.  The result is an (m, b) view of a (b, m)
    buffer, so the model's row-major layout is its transpose without a
    copy.  An expert stack: u8 (E, m, ceil(k/2)) and scales (E, m, nsb)
    contiguous, x (E, k, b) any strides, no bias or residual, one launch
    for all E; the result an (E, m, b) view of an (E, b, m) buffer.
    """
    global launches
    E, m, k, b, nsb = _check(u8, scales, x, scale_block, bias, residual)
    if u8.device.type != "cuda":
        raise ValueError(f"int4_matmul_cuda needs CUDA tensors, got "
                         f"{u8.device}")
    if u8.dtype != torch.uint8 or not u8.is_contiguous():
        raise ValueError("u8 must be contiguous uint8")
    for name, t in (("x", x), ("residual", residual)):
        if t is not None and t.dtype not in OUT_TYPES:
            raise ValueError(f"{name} must be float32, bfloat16 or float16, "
                             f"got {t.dtype}")
    for name, t in (("scales", scales), ("bias", bias)):
        if t is not None and t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if out_dtype not in OUT_TYPES:
        raise ValueError(f"unsupported out_dtype {out_dtype}")
    if (tiles.tb not in (1, 2, 4, 8) or tiles.tk <= 0 or tiles.tk % STEP
            or tiles.nsplit < 1):
        raise ValueError(f"bad tiles {tiles}")
    tk = stage_codes(tiles, scale_block)
    if (k + STEP) * scale_block >= 2**32:  # the kernel's block_of
        raise ValueError(f"k={k} x scale_block={scale_block} too large")
    per, nsplit = split_steps(k, tiles.nsplit)
    ne = max(E, 1)
    if ne * -(-b // tiles.tb) > MAX_GRID_Z:
        raise ValueError(f"{ne} experts x {-(-b // tiles.tb)} column tiles "
                         f"exceed the grid's {MAX_GRID_Z}")
    dev = u8.device
    out = torch.empty((ne, b, m), dtype=out_dtype, device=dev).transpose(1, 2)
    ws = (torch.empty((ne, nsplit, b, m), dtype=torch.float32, device=dev)
          if nsplit > 1 else None)
    # 4-byte word loads need every row start 4-byte aligned
    vec = int(u8.shape[-1] % 4 == 0 and u8.data_ptr() % 4 == 0)
    # x staged with 16-byte loads along k where each column (of each
    # expert) allows them
    xe = x.element_size()
    x_vec = int(x.stride(-2) == 1 and x.data_ptr() % 16 == 0
                and (b == 1 or x.stride(-1) * xe % 16 == 0)
                and (E <= 1 or x.stride(0) * xe % 16 == 0))
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    rs = residual.stride() if residual is not None else (0, 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = nvcc.load("int4_matmul", "int4_matmul_launch", _ARGTYPES)(
        ptr(u8), ptr(scales), ptr(x), ptr(bias), ptr(residual), ptr(out),
        ptr(ws), m, k, u8.shape[-1], b, nsb, scale_block, tk,
        tk // scale_block + 2, per, nsplit, tiles.tb, vec, x.stride(-2),
        x.stride(-1), rs[0], rs[1], out.stride(1), out.stride(2),
        ACTS[act], OUT_TYPES[out_dtype], OUT_TYPES[x.dtype],
        OUT_TYPES[residual.dtype] if residual is not None else 0,
        0 if scale_block == 1 else 2**32 // scale_block + 1, x_vec, ne,
        x.stride(0) if E else 0, out.stride(0), stream)
    if err != 0:
        raise RuntimeError(f"int4 kernel launch failed: CUDA error {err} "
                           f"(E={E}, m={m}, k={k}, b={b}, tiles={tiles})")
    launches += 1
    return out if E else out[0]


def _codes(u8: torch.Tensor, k: int) -> torch.Tensor:
    """The (m, k) f32 two's-complement value of each code, hi nibble
    first."""
    c = torch.stack([u8 >> 4, u8 & 0xF], dim=-1).reshape(u8.shape[0], -1)
    c = c[:, :k].to(torch.int32)
    return torch.where(c <= 7, c, c - 16).to(torch.float32)


def dequantize(u8: torch.Tensor, scales: torch.Tensor, k: int,
               scale_block: int) -> torch.Tensor:
    """The (m, k) f32 weight the kernel multiplies: two's-complement value
    of each code (hi nibble first) times its row-block scale."""
    q = torch.repeat_interleave(scales.to(torch.float32), scale_block,
                                dim=1)[:, :k]
    return _codes(u8, k) * q


@functools.lru_cache(maxsize=256)
def _segment_ends(k: int, scale_block: int, per: int, nsplit: int,
                  device: torch.device):
    """Where the lanes' segments end, split by split: for each (step s,
    code t) of the split, ``(s, t, lanes, blocks)`` with the lanes whose
    segment of scale block ``blocks`` ends before their code t of step s
    (None when no lane's does), then the lanes' last segments,
    ``(lanes, blocks)``, which end with the split.  The kernel's flushes,
    as the host computes them from k alone."""
    out = []
    for sp in range(nsplit):
        cur = [-1] * LANES
        events = []
        for s in range(sp * per, (sp + 1) * per):
            for t in range(WORD):
                ends = []
                for lane in range(LANES):
                    kk = s * STEP + lane * WORD + t
                    if kk < k and kk // scale_block != cur[lane]:
                        if cur[lane] >= 0:
                            ends.append((lane, cur[lane]))
                        cur[lane] = kk // scale_block
                events.append((s, t, *_lane_blocks(ends, device)))
        last = [(lane, c) for lane, c in enumerate(cur) if c >= 0]
        out.append((events, _lane_blocks(last, device)))
    return out


def _lane_blocks(pairs, device):
    if not pairs:
        return None, None
    lanes, blocks = zip(*pairs)
    return (torch.tensor(lanes, device=device),
            torch.tensor(blocks, device=device))


def int4_matmul_plain(u8: torch.Tensor, scales: torch.Tensor,
                      x: torch.Tensor, *, scale_block: int,
                      tiles: Int4Tiles | None = None, act: str = "none",
                      bias: torch.Tensor | None = None,
                      residual: torch.Tensor | None = None,
                      out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The kernel's function in plain PyTorch, in the kernel's op order
    (the counterpart of ``repro.kernels.ref.int4_matmul_ref``): per split,
    per-lane segment sums over k = 256·S + 8·L + t, one scale multiply a
    segment, the shuffle tree; the splits added in order; the epilogue.
    Of ``tiles`` only ``nsplit`` counts (one split when None).  x and the
    residual of any float type are widened to f32, which is exact.  An
    expert stack runs expert by expert, each as one linear."""
    E, m, k, b, nsb = _check(u8, scales, x, scale_block, bias, residual)
    if E:
        return torch.stack([int4_matmul_plain(
            u8[e], scales[e], x[e], scale_block=scale_block, tiles=tiles,
            act=act, out_dtype=out_dtype) for e in range(E)])
    dev = u8.device
    per, nsplit = split_steps(k, tiles.nsplit if tiles is not None else 1)
    ns = per * nsplit
    w = torch.zeros((m, ns * STEP), dtype=torch.float32, device=dev)
    w[:, :k] = _codes(u8, k)
    xp = torch.zeros((ns * STEP, b), dtype=torch.float32, device=dev)
    xp[:k] = x.to(torch.float32)
    nl = min(LANES, -(-k // WORD))  # lanes with codes; the rest sum 0
    w = w.reshape(m, ns, LANES, WORD)[:, :, :nl]
    xp = xp.reshape(ns, LANES, WORD, b)[:, :nl]
    sc = scales.to(torch.float32)
    total = None
    for events, (lanes, blocks) in _segment_ends(k, scale_block, per,
                                                 nsplit, dev):
        acc = torch.zeros((m, LANES, b), dtype=torch.float32, device=dev)
        seg = torch.zeros((m, nl, b), dtype=torch.float32, device=dev)
        for s, t, ends, ended in events:
            if ends is not None:  # acc + seg * scale, then a new segment
                acc[:, ends] = acc[:, ends] + seg[:, ends] * sc[:, ended, None]
                seg[:, ends] = 0.0
            seg = seg + w[:, s, :, t, None] * xp[None, s, :, t, :]
        if lanes is not None:
            acc[:, lanes] = acc[:, lanes] + seg[:, lanes] * sc[:, blocks, None]
        while acc.shape[1] > 1:  # xor-shuffle tree, as lane 0 sees it
            half = acc.shape[1] // 2
            acc = acc[:, :half] + acc[:, half:]
        total = acc[:, 0] if total is None else total + acc[:, 0]
    return epilogue_cols(total, act, bias, residual, out_dtype)


def int4_matmul_fake(u8: torch.Tensor, scales: torch.Tensor,
                     x: torch.Tensor, *, scale_block: int, tiles: Int4Tiles,
                     act: str = "none", bias=None, residual=None,
                     out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The kernel's call on fake tensors: what :func:`int4_matmul_cuda`
    allocates (its output and its k-split workspace), with no launch."""
    E, m, k, b, nsb = _check(u8, scales, x, scale_block, bias, residual)
    ne = max(E, 1)
    _, nsplit = split_steps(k, tiles.nsplit)
    out = torch.empty((ne, b, m), dtype=out_dtype,
                      device=u8.device).transpose(1, 2)
    if nsplit > 1:
        torch.empty((ne, nsplit, b, m), dtype=torch.float32,
                    device=u8.device)
    return out if E else out[0]


def int4_matmul(u8, scales, x, **kw) -> torch.Tensor:
    """Route by device: the kernel for CUDA tensors, the plain version for
    CPU tensors, the kernel's allocations alone for fake ones
    (:func:`int4_matmul_fake`); anything else raises.  There is no
    fallback."""
    if is_fake(x):
        return int4_matmul_fake(u8, scales, x, **kw)
    if x.device.type == "cuda":
        return int4_matmul_cuda(u8, scales, x, **kw)
    if x.device.type == "cpu":
        return int4_matmul_plain(u8, scales, x, **kw)
    raise ValueError(f"int4_matmul: unsupported device {x.device}")
