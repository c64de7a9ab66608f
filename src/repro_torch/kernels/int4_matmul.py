"""Blocked int4 dequantize-then-dot GeMM for Hopper
(``csrc/int4_matmul.cu``), its plain PyTorch version, and its launch
counter.

Replaces the Pallas TPU kernel
``repro/kernels/int4_matmul.py::int4_matmul_pallas``: the fused grid
(``_kernel_fused``, pallas_call at line 165) and, with the identity
epilogue, the legacy grid (``_kernel_legacy``, pallas_call at line 133);
both run ``_dequant_dot``.  It is the baseline the paper's msGeMM is
measured against: unpack two codes per byte (hi nibble first), map them
two's complement (``c <= 7 ? c : c - 16``), multiply by the row-block
scale *before* the product (msGeMM scales after the gathers), accumulate
in f32 over all of k, then ``cast(act(acc + bias) + residual)``.

What bounds it on an H100.  Per call it must read 0.5 B per weight plus
the f32 scales, x, and write the output; at decode batch sizes that is
far below the card's operations-to-bytes balance, so the bytes bound it.
For gemma-2b's gate/up (16384x2048) the codes are 16.8 MB and the scales
3.7 MB: about 6 µs at 3.35 TB/s, half the byte bound of msGeMM's int32
indices at d = 3 (m·ceil(k/3)·4 B, 44.7 MB: about 14.5 µs including its
scales).  That decides the paper's comparison on this card: msGeMM's LUT
indices carry 10.7 bits per weight where the packed codes carry 4.

What the design does about it.  A simple kernel: blocks of 8 warps own 32
rows (4 per warp) and up to 8 batch columns; the x tile sits in shared
memory, laid out so the 32 lanes read consecutive words, and is reused by
every row of the block; each lane streams 4 packed bytes per row per 256
codes (coalesced 128-byte warp loads).  No tensor cores: ``mma``/``wgmma``
on dequantized bf16 tiles is the kernel's later work.  Ragged k (a last
scale block shorter than ``scale_block``, an odd k) and ragged rows and
columns are masked in the kernel; nothing is padded.

Op order (see ``csrc/int4_matmul.cu``): lane L of a warp sums the codes
k = 256·S + 8·L + t in k order with separate round-to-nearest multiplies
and adds, the 32 lane sums meet in an xor-shuffle tree, then the
epilogue.  :func:`int4_matmul_plain` repeats exactly these sums, so the
kernel and the plain version agree bit for bit except inside the
gelu/silu epilogues' tanh/exp.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import nvcc
from repro_torch.kernels.msgemm import ACTS, OUT_TYPES, epilogue_cols

LANES = 32   # lanes of a warp: the kernel's k interleave
WORD = 8     # codes per lane per 256-code step (4 packed bytes)
STEP = LANES * WORD
_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 9
             + [ctypes.c_longlong] * 6
             + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])

# Kernel launches since the last reset; only int4_matmul_cuda adds to it.
launches = 0


class Int4Tiles(NamedTuple):
    """One launch's work split (``ops.int4_tiles`` picks it).

    tb: batch columns per block (1, 2, 4 or 8); tk: codes of x held in
    shared memory at a time (a multiple of 256).  Neither changes the
    arithmetic: each lane's sum runs over the same codes in the same order.
    """

    tb: int
    tk: int


def _check(u8, scales, x, scale_block, bias, residual):
    """Validate shapes and devices; returns (m, k, b, nsb)."""
    if u8.dim() != 2 or x.dim() != 2:
        raise ValueError(f"u8 (m, k/2) and x (k, b) must be 2-D, got "
                         f"{tuple(u8.shape)} and {tuple(x.shape)}")
    m, kb = u8.shape
    k, b = x.shape
    if kb != -(-k // 2):
        raise ValueError(f"u8 has {kb} bytes a row, x has k={k}")
    if scale_block < 1:
        raise ValueError(f"scale_block={scale_block} must be >= 1")
    nsb = -(-k // scale_block)
    if tuple(scales.shape) != (m, nsb):
        raise ValueError(f"scales {tuple(scales.shape)} != {(m, nsb)}")
    if bias is not None and tuple(bias.shape) != (m,):
        raise ValueError(f"bias {tuple(bias.shape)} != {(m,)}")
    if residual is not None and tuple(residual.shape) != (m, b):
        raise ValueError(f"residual {tuple(residual.shape)} != {(m, b)}")
    for name, t in (("x", x), ("scales", scales), ("bias", bias),
                    ("residual", residual)):
        if t is not None and t.device != u8.device:
            raise ValueError(f"{name} on {t.device}, u8 on {u8.device}")
    return m, k, b, nsb


def int4_matmul_cuda(u8: torch.Tensor, scales: torch.Tensor,
                     x: torch.Tensor, *, scale_block: int, tiles: Int4Tiles,
                     act: str = "none", bias: torch.Tensor | None = None,
                     residual: torch.Tensor | None = None,
                     out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """y (m, b) = cast(act(dequant(u8) @ x + bias) + residual) on the GPU.

    u8 (m, ceil(k/2)) uint8 contiguous; scales (m, ceil(k/scale_block))
    f32 contiguous; x (k, b) f32, any strides; bias (m,) f32 contiguous,
    residual (m, b) f32, any strides.  The result is an (m, b) view of a
    (b, m) buffer, so the model's row-major layout is its transpose
    without a copy.
    """
    global launches
    m, k, b, nsb = _check(u8, scales, x, scale_block, bias, residual)
    if u8.device.type != "cuda":
        raise ValueError(f"int4_matmul_cuda needs CUDA tensors, got "
                         f"{u8.device}")
    if u8.dtype != torch.uint8 or not u8.is_contiguous():
        raise ValueError("u8 must be contiguous uint8")
    for name, t in (("x", x), ("scales", scales), ("bias", bias),
                    ("residual", residual)):
        if t is not None and t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
    for name, t in (("scales", scales), ("bias", bias)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if out_dtype not in OUT_TYPES:
        raise ValueError(f"unsupported out_dtype {out_dtype}")
    if tiles.tb not in (1, 2, 4, 8) or tiles.tk <= 0 or tiles.tk % STEP:
        raise ValueError(f"bad tiles {tiles}")
    out = torch.empty((b, m), dtype=out_dtype, device=u8.device).t()
    # 4-byte word loads need every row start 4-byte aligned
    vec = int(u8.shape[1] % 4 == 0 and u8.data_ptr() % 4 == 0)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    rs = residual.stride() if residual is not None else (0, 0)
    stream = torch.cuda.current_stream(u8.device).cuda_stream
    err = nvcc.load("int4_matmul", "int4_matmul_launch", _ARGTYPES)(
        ptr(u8), ptr(scales), ptr(x), ptr(bias), ptr(residual), ptr(out),
        m, k, u8.shape[1], b, nsb, scale_block, tiles.tk, tiles.tb, vec,
        x.stride(0), x.stride(1), rs[0], rs[1], out.stride(0), out.stride(1),
        ACTS[act], OUT_TYPES[out_dtype], stream)
    if err != 0:
        raise RuntimeError(f"int4 kernel launch failed: CUDA error {err} "
                           f"(m={m}, k={k}, b={b}, tiles={tiles})")
    launches += 1
    return out


def dequantize(u8: torch.Tensor, scales: torch.Tensor, k: int,
               scale_block: int) -> torch.Tensor:
    """The (m, k) f32 weight the kernel multiplies: two's-complement value
    of each code (hi nibble first) times its row-block scale."""
    c = torch.stack([u8 >> 4, u8 & 0xF], dim=-1).reshape(u8.shape[0], -1)
    c = c[:, :k].to(torch.int32)
    vals = torch.where(c <= 7, c, c - 16).to(torch.float32)
    q = torch.repeat_interleave(scales.to(torch.float32), scale_block,
                                dim=1)[:, :k]
    return vals * q


def int4_matmul_plain(u8: torch.Tensor, scales: torch.Tensor,
                      x: torch.Tensor, *, scale_block: int,
                      tiles: Int4Tiles | None = None, act: str = "none",
                      bias: torch.Tensor | None = None,
                      residual: torch.Tensor | None = None,
                      out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The kernel's function in plain PyTorch, in the kernel's op order
    (the counterpart of ``repro.kernels.ref.int4_matmul_ref``): per-lane
    sums over k = 256·S + 8·L + t, the shuffle tree, the epilogue.
    ``tiles`` is accepted for the kernel's signature and changes nothing."""
    m, k, b, nsb = _check(u8, scales, x, scale_block, bias, residual)
    dev = u8.device
    ns = -(-k // STEP)
    w = torch.zeros((m, ns * STEP), dtype=torch.float32, device=dev)
    w[:, :k] = dequantize(u8, scales, k, scale_block)
    xp = torch.zeros((ns * STEP, b), dtype=torch.float32, device=dev)
    xp[:k] = x.to(torch.float32)
    w = w.reshape(m, ns, LANES, WORD)
    xp = xp.reshape(ns, LANES, WORD, b)
    lane = torch.zeros((m, LANES, b), dtype=torch.float32, device=dev)
    for s in range(ns):
        for t in range(WORD):
            lane = lane + w[:, s, :, t, None] * xp[None, s, :, t, :]
    while lane.shape[1] > 1:  # xor-shuffle tree, as lane 0 sees it
        half = lane.shape[1] // 2
        lane = lane[:, :half] + lane[:, half:]
    return epilogue_cols(lane[:, 0], act, bias, residual, out_dtype)


def int4_matmul(u8, scales, x, **kw) -> torch.Tensor:
    """Route by device: the kernel for CUDA tensors, the plain version for
    CPU tensors; anything else raises.  There is no fallback."""
    if x.device.type == "cuda":
        return int4_matmul_cuda(u8, scales, x, **kw)
    if x.device.type == "cpu":
        return int4_matmul_plain(u8, scales, x, **kw)
    raise ValueError(f"int4_matmul: unsupported device {x.device}")
