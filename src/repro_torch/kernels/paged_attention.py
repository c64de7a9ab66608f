"""Paged attention over the quantized KV pool for Hopper
(``csrc/paged_attention.cu``), its plain PyTorch version, and its launch
counter.

Replaces the Pallas TPU kernel
``repro/kernels/paged_attention.py::paged_attention_pallas`` (``_kernel``
and ``_decode_block``, pallas_call at line 157): flash online-softmax
attention over the pool of repro_torch.kvq, which stores int8 or packed
int4 codes plus per-slot scales.  K and V are dequantized block by block
on chip, so no dequantized copy of the view ever sits in device memory.

What bounds it on an H100.  A call must read the codes and scales of the
view blocks its queries reach (for gemma-2b, 2·(Dhp + 4) bytes per slot
and kv head), q and the block tables, and write the output; it does about
4·Dh operations per (query head, reached slot) in f32 (q·k and p·v).  At
the engine's decode shape (4 rows, 1 query, 8 heads on one kv head, a few
blocks) both are well under a microsecond: the call is bound by launch
latency and by the serial walk over blocks.  The long-context case (4096
slots) is bytes-bound at about 5 µs for 8 rows at kv8.

What the design does about it.  The TPU grid (B, H, blocks) re-reads each
K/V block once per query head and carries m, l and acc in VMEM across
the sequential block axis.  Here one CUDA block owns one (row, kv head)
and all its query heads and queries (up to 16 rows of (query, head)), and
loops over the row's block table itself: each K/V block is read and
dequantized once into shared memory for every head that shares it, and
m, l and acc stay in shared memory.  The walk ends after the block that
holds the row's largest query position (exact: every later slot is masked
and adds exactly 0).  Splitting the sequence over blocks (flash-decoding),
cp.async/TMA and tensor cores are for the kernel's later work.

Numerics follow the Pallas kernel: q is multiplied by ``dh**-0.5`` before
the dot, softcap is ``c·tanh(s/c)``, masked logits are the finite
``NEG_INF = -1e30`` (never -inf: a fully masked block then has p = 1 until
a valid slot arrives, whose corr = exp(-1e30 - m) = 0 wipes it exactly),
and the output is ``acc / max(l, 1e-30)`` cast to q's dtype.
:func:`paged_attention_plain` repeats the same recurrence block by block;
kernel and plain version differ only in the order of the sums inside a
dot product.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core import packing
from repro_torch.kernels import nvcc
from repro_torch.kernels.msgemm import OUT_TYPES

NEG_INF = -1e30
ROWS = 16  # kRows in csrc/paged_attention.cu: query rows per CUDA block
MAX_SMEM = 232448  # bytes of shared memory one H100 block may use
_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 11
             + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])

# Kernel launches since the last reset; only paged_attention_cuda adds to
# it, so a main-path run can prove that attention went through the kernel.
launches = 0


def _check(q, k_codes, k_scales, v_codes, v_scales, block_tables,
           positions, bits, codebook, block_size):
    """Validate shapes and devices; returns (B, C, H, dh, bs, hk, g, nseq)."""
    if q.dim() != 4 or k_codes.dim() != 4:
        raise ValueError(f"q (B, C, H, Dh) and codes (nb, bs, Hk, Dhp) must "
                         f"be 4-D, got {tuple(q.shape)}, "
                         f"{tuple(k_codes.shape)}")
    B, C, H, dh = q.shape
    nb, bs, hk, dhp = k_codes.shape
    if bits not in (8, 4):
        raise ValueError(f"bits must be 8 or 4, got {bits}")
    if bs != block_size:
        raise ValueError(f"pool block size {bs} != block_size {block_size}")
    if H % hk:
        raise ValueError(f"{H} query heads do not group onto {hk} kv heads")
    if dhp != (dh if bits == 8 else -(-dh // 2)):
        raise ValueError(f"packed head dim {dhp} does not hold Dh={dh} at "
                         f"{bits} bits")
    if tuple(v_codes.shape) != tuple(k_codes.shape):
        raise ValueError(f"v codes {tuple(v_codes.shape)} != k codes "
                         f"{tuple(k_codes.shape)}")
    for name, t in (("k_scales", k_scales), ("v_scales", v_scales)):
        if tuple(t.shape) != (nb, bs, hk):
            raise ValueError(f"{name} {tuple(t.shape)} != {(nb, bs, hk)}")
    if block_tables.dim() != 2 or block_tables.shape[0] != B:
        raise ValueError(f"block_tables {tuple(block_tables.shape)} must be "
                         f"({B}, nseq)")
    if tuple(positions.shape) != (B, C):
        raise ValueError(f"positions {tuple(positions.shape)} != {(B, C)}")
    if codebook is not None and (bits != 4 or tuple(codebook.shape) != (16,)):
        raise ValueError("a codebook is a (16,) table of 4-bit code values")
    for name, t in (("codes", k_codes), ("k_scales", k_scales),
                    ("v_codes", v_codes), ("v_scales", v_scales),
                    ("block_tables", block_tables), ("positions", positions),
                    ("codebook", codebook)):
        if t is not None and t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
    return B, C, H, dh, bs, hk, H // hk, block_tables.shape[1]


def smem_bytes(dh: int, block_size: int) -> int:
    """Dynamic shared memory of one CUDA block (the .cu's formula)."""
    return ((2 * ROWS * dh + 2 * block_size * dh + ROWS * block_size
             + 3 * ROWS + 16) * 4 + ROWS * 4)


def paged_attention_cuda(q: torch.Tensor, k_codes: torch.Tensor,
                         k_scales: torch.Tensor, v_codes: torch.Tensor,
                         v_scales: torch.Tensor, block_tables: torch.Tensor,
                         positions: torch.Tensor, *, bits: int,
                         codebook: torch.Tensor | None = None,
                         block_size: int, window: int = 0,
                         softcap: float = 0.0) -> torch.Tensor:
    """(B, C, H, Dh) attention output in q's dtype, on the GPU.

    q (B, C, H, Dh) f32/bf16/f16 contiguous; codes (nb, bs, Hk, Dhp) uint8
    and scales (nb, bs, Hk) f32, contiguous (the repro_torch.kvq pool);
    block_tables (B, nseq) int32 block ids covering view positions
    [0, nseq*bs); positions (B, C) int32; codebook (16,) f32 or None (the
    uniform int4 grid; ignored at 8 bits).
    """
    global launches
    B, C, H, dh, bs, hk, g, nseq = _check(
        q, k_codes, k_scales, v_codes, v_scales, block_tables, positions,
        bits, codebook, block_size)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention_cuda needs CUDA tensors, got "
                         f"{q.device}")
    if q.dtype not in OUT_TYPES or not q.is_contiguous():
        raise ValueError(f"q must be contiguous f32/bf16/f16, got {q.dtype}")
    for name, t, dt in (("k_codes", k_codes, torch.uint8),
                        ("v_codes", v_codes, torch.uint8),
                        ("k_scales", k_scales, torch.float32),
                        ("v_scales", v_scales, torch.float32),
                        ("block_tables", block_tables, torch.int32),
                        ("positions", positions, torch.int32),
                        ("codebook", codebook, torch.float32)):
        if t is not None and (t.dtype != dt or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous {dt}, got {t.dtype}")
    if smem_bytes(dh, bs) > MAX_SMEM:
        raise ValueError(f"head dim {dh} at block size {bs} needs "
                         f"{smem_bytes(dh, bs)} B of shared memory "
                         f"(> {MAX_SMEM})")
    out = torch.empty_like(q)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = nvcc.load("paged_attention", "paged_attention_launch", _ARGTYPES)(
        ptr(q), ptr(k_codes), ptr(k_scales), ptr(v_codes), ptr(v_scales),
        ptr(block_tables), ptr(positions),
        ptr(codebook) if bits == 4 else None, ptr(out),
        B, C, H, hk, dh, k_codes.shape[3], bs, nseq, bits, int(window),
        OUT_TYPES[q.dtype], float(softcap), float(dh**-0.5), stream)
    if err != 0:
        raise RuntimeError(f"paged attention kernel launch failed: CUDA "
                           f"error {err} (B={B}, C={C}, H={H}, Hk={hk}, "
                           f"Dh={dh}, bs={bs}, nseq={nseq})")
    launches += 1
    return out


def _decode_block(codes, scales, *, bits, table, head_dim):
    """codes (..., Dhp) u8 + scales (...) -> (..., Dh) f32 values."""
    c = codes.to(torch.int64)
    if bits == 8:
        vals = torch.where(c < 128, c, c - 256).to(torch.float32)
    else:
        cc = torch.stack([c >> 4, c & 0xF], dim=-1)  # hi nibble first
        cc = cc.reshape(*c.shape[:-1], -1)[..., :head_dim]
        vals = table[cc]
    return vals * scales.to(torch.float32)[..., None]


def paged_attention_plain(q: torch.Tensor, k_codes: torch.Tensor,
                          k_scales: torch.Tensor, v_codes: torch.Tensor,
                          v_scales: torch.Tensor, block_tables: torch.Tensor,
                          positions: torch.Tensor, *, bits: int,
                          codebook: torch.Tensor | None = None,
                          block_size: int, window: int = 0,
                          softcap: float = 0.0) -> torch.Tensor:
    """The kernel's function in plain PyTorch: the same online-softmax
    recurrence over the block table, one view block per step, in the
    kernel's op order, stopping at the same block per row."""
    B, C, H, dh, bs, hk, g, nseq = _check(
        q, k_codes, k_scales, v_codes, v_scales, block_tables, positions,
        bits, codebook, block_size)
    dev = q.device
    table = (packing.b_values(torch.float32, dev) if codebook is None
             else codebook.to(torch.float32))
    scale = torch.tensor(dh**-0.5, dtype=torch.float32, device=dev)
    qs = (q.to(torch.float32) * scale).reshape(B, C, hk, g, dh)
    pos = positions.to(torch.int64)
    nblk = torch.clamp(torch.clamp(pos.amax(1), min=0) // bs + 1, max=nseq)
    bt = block_tables.to(torch.int64)
    m = torch.full((B, hk, g, C), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, hk, g, C), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, hk, g, C, dh), dtype=torch.float32, device=dev)
    slot = torch.arange(bs, device=dev)
    dec = dict(bits=bits, table=table, head_dim=dh)
    for i in range(int(nblk.max())):
        blk = bt[:, i]
        k = _decode_block(k_codes[blk], k_scales[blk], **dec)  # (B,bs,Hk,Dh)
        v = _decode_block(v_codes[blk], v_scales[blk], **dec)
        s = torch.einsum("bchgd,bjhd->bhgcj", qs, k)
        if softcap:
            s = softcap * torch.tanh(s / softcap)
        kvpos = i * bs + slot
        ok = kvpos[None, None, :] <= pos[:, :, None]  # (B, C, bs)
        if window:
            ok &= kvpos[None, None, :] > pos[:, :, None] - window
        s = torch.where(ok[:, None, None], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l_new = corr * l + p.sum(-1)
        acc_new = corr[..., None] * acc + torch.einsum("bhgcj,bjhd->bhgcd",
                                                       p, v)
        live = (i < nblk).view(B, 1, 1, 1)
        m = torch.where(live, m_new, m)
        l = torch.where(live, l_new, l)
        acc = torch.where(live[..., None], acc_new, acc)
    out = acc / torch.clamp(l, min=1e-30)[..., None]  # (B, Hk, g, C, Dh)
    return out.permute(0, 3, 1, 2, 4).reshape(B, C, H, dh).to(q.dtype)


def paged_attention(q, k_codes, k_scales, v_codes, v_scales, block_tables,
                    positions, **kw) -> torch.Tensor:
    """Route by device: the kernel for CUDA tensors, the plain version for
    CPU tensors; anything else raises.  There is no fallback."""
    args = (q, k_codes, k_scales, v_codes, v_scales, block_tables, positions)
    if q.device.type == "cuda":
        return paged_attention_cuda(*args, **kw)
    if q.device.type == "cpu":
        return paged_attention_plain(*args, **kw)
    raise ValueError(f"paged_attention: unsupported device {q.device}")
