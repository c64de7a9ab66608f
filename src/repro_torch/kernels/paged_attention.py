"""Paged attention over the quantized KV pool for Hopper
(``csrc/paged_attention.cu``), its plain PyTorch version, and its launch
counter.

Replaces the Pallas TPU kernel
``repro/kernels/paged_attention.py::paged_attention_pallas`` (``_kernel``
and ``_decode_block``, pallas_call at line 157): attention over the pool
of repro_torch.kvq, which stores int8 or packed int4 codes plus per-slot
scales.  K and V are dequantized on chip, so no dequantized copy of the
view ever sits in device memory.

What bounds it on an H100.  A call must read the codes and scales of the
view slots its queries reach (for gemma-2b, 2·(Dhp + 4) bytes per slot
and kv head), q and the block tables, and write the output; it does about
4·Dh operations per (query head, reached slot) in f32 (q·k and p·v).  At
every shape the engine and ``chip_smoke.py`` run, both are microseconds
or less (the long-context case, 8 rows of 4096 slots at kv8, needs 17 MB:
5 µs), so latency bounds it: how many blocks run at once and how many
loads each keeps in flight.  The first port walked a row's block table
serially in one CUDA block per (row, kv head), 8 slots a step with four
barriers each and one thread a row for the softmax: 4 blocks on 132 SMs
at gemma-2b decode, 3.8 ms at 4096 slots against sdpa's 0.72.

What the design does about it: split over the sequence (flash-decoding).
Each row's view is cut into chunks of :data:`CHUNK` view slots, a fixed
count that depends on the slot index alone, never on the batch, nseq or
the positions.  One CUDA block owns (row, kv head, up to 8 query rows,
chunk) and handles all the chunk's slots at once: it puts every K and V
code row of the chunk in flight with 16-byte ``cp.async`` copies, takes
q·k for all the query heads that share the kv head against each K row,
dequantized in registers, runs one softmax a row with warp reductions,
then p·v.  How many query rows share a block is picked from the shape
(:func:`rows_per_block`): up to 8 where the grid still fills the card
(long views), fewer where it would be a handful of blocks (decode over a
short view, where one row a block ran 2x faster on the card than eight).
Chunks past the block that holds the row's largest query
position, and chunks wholly below every query's window, are skipped.  A
view of one chunk is written at once; a longer one leaves a partial (m,
l, acc) per chunk in scratch, and a second kernel merges a row's chunks
in chunk order:

    M = max_i m_i;  w_i = exp(m_i - M)
    out = Σ w_i·acc_i / max(Σ w_i·l_i, 1e-30)

Numerics follow the Pallas kernel: q is multiplied by ``dh**-0.5`` before
the dot, softcap is ``c·tanh(s/c)``, masked logits are the finite
``NEG_INF = -1e30`` (never -inf: a chunk masked for a query has m =
-1e30, and its weight exp(-1e30 - M) = 0 wipes it exactly once a valid
slot shows up elsewhere), and the output is cast to q's dtype.
:func:`paged_attention_plain` takes the same chunks, as fixed-shape tiles
of :data:`CHUNK` slots, and the same combine in the same order; kernel and
plain version differ only in the order of the sums inside a product.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core import packing
from repro_torch.kernels import nvcc
from repro_torch.kernels.msgemm import OUT_TYPES

NEG_INF = -1e30
# view slots a chunk: the kernel's default `chunk`, the fastest (or
# within 1%) at the long views of chip_smoke.py --sweep on an H100
CHUNK = 128
MAX_SMEM = 232448  # bytes of shared memory one H100 block may use
SMS = 132  # streaming multiprocessors of an H100 SXM
_ARGTYPES = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 11
             + [ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p])

# Kernel launches since the last reset; only paged_attention_cuda adds to
# it (one a call, the combine included), so a main-path run can prove that
# attention went through the kernel.
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


def rows_per_block(rows: int, blocks_per_group: int) -> int:
    """Query rows a CUDA block takes (RB, 1, 2, 4 or 8): the most, up to
    the kv head's rows rounded up to a power of two, that still give each
    of the card's SMs a block, else 1.  ``blocks_per_group`` is the
    blocks one group of rows takes (chunks x kv heads x batch rows).  A
    block shares each K/V read among its rows; a small grid (a short
    view) gains more from more blocks.  The result changes no bit."""
    rb = 1
    while rb < min(rows, 8):
        rb *= 2
    while rb > 1 and blocks_per_group * -(-rows // rb) < SMS:
        rb //= 2
    return rb


def smem_bytes(dhp: int, bits: int, chunk: int, rb: int) -> int:
    """Dynamic shared memory of one chunk block of ``rb`` query rows (the
    .cu's smem_total): K and V code rows padded to 16-byte units plus 16
    bytes, their scales, q, the scores and the score parts of 256 threads
    in f32, the slots' pool rows."""
    units = -(-dhp // 16)
    dpad = units * (16 if bits == 8 else 32)
    return (2 * chunk * (16 * units + 16) + 2 * chunk * 4 + 4 * rb * dpad
            + 4 * rb * chunk + 4 * rb * 256 + 4 * chunk)


def _check_chunk(chunk: int) -> None:
    if chunk <= 0 or chunk % 16:
        raise ValueError(f"chunk must be a positive multiple of 16 slots, "
                         f"got {chunk}")


def live_chunks(positions: torch.Tensor, *, block_size: int, nseq: int,
                window: int, chunk: int):
    """Per batch row, the chunks [lo, hi) it needs and the view slots it
    reaches [0, hi_slot): up to the block that holds its largest query
    position, from the chunk of its lowest window start (0 without a
    window), at least one chunk (the .cu's live_chunks)."""
    pos = positions.to(torch.int64)
    hi_slot = torch.clamp(torch.clamp(pos.amax(1), min=0) // block_size + 1,
                          max=nseq) * block_size
    hi = -(-hi_slot // chunk)
    lo = (torch.clamp(pos.amin(1) - window + 1, min=0) // chunk if window
          else torch.zeros_like(hi))
    return torch.minimum(lo, hi - 1), hi, hi_slot


def paged_attention_cuda(q: torch.Tensor, k_codes: torch.Tensor,
                         k_scales: torch.Tensor, v_codes: torch.Tensor,
                         v_scales: torch.Tensor, block_tables: torch.Tensor,
                         positions: torch.Tensor, *, bits: int,
                         codebook: torch.Tensor | None = None,
                         block_size: int, window: int = 0,
                         softcap: float = 0.0, chunk: int = CHUNK,
                         rows: int | None = None) -> torch.Tensor:
    """(B, C, H, Dh) attention output in q's dtype, on the GPU.

    q (B, C, H, Dh) f32/bf16/f16 contiguous, Dh <= 256; codes (nb, bs, Hk,
    Dhp) uint8 and scales (nb, bs, Hk) f32, contiguous (the
    repro_torch.kvq pool); block_tables (B, nseq) int32 block ids covering
    view positions [0, nseq*bs); positions (B, C) int32; codebook (16,)
    f32 or None (the uniform int4 grid; ignored at 8 bits); chunk the view
    slots a CUDA block takes (a multiple of 16); rows the query rows a
    block takes (1, 2, 4 or 8; :func:`rows_per_block` when None).  A view
    longer than one chunk also launches the combine, into scratch from
    ``torch.empty``.
    """
    global launches
    B, C, H, dh, bs, hk, g, nseq = _check(
        q, k_codes, k_scales, v_codes, v_scales, block_tables, positions,
        bits, codebook, block_size)
    _check_chunk(chunk)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention_cuda needs CUDA tensors, got "
                         f"{q.device}")
    if q.dtype not in OUT_TYPES or not q.is_contiguous():
        raise ValueError(f"q must be contiguous f32/bf16/f16, got {q.dtype}")
    if dh > 256:
        raise ValueError(f"head dim {dh} > 256")
    for name, t, dt in (("k_codes", k_codes, torch.uint8),
                        ("v_codes", v_codes, torch.uint8),
                        ("k_scales", k_scales, torch.float32),
                        ("v_scales", v_scales, torch.float32),
                        ("block_tables", block_tables, torch.int32),
                        ("positions", positions, torch.int32),
                        ("codebook", codebook, torch.float32)):
        if t is not None and (t.dtype != dt or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous {dt}, got {t.dtype}")
    dhp = k_codes.shape[3]
    nch = -(-nseq * bs // chunk)
    rb = rows or rows_per_block(C * g, nch * hk * B)
    if rb not in (1, 2, 4, 8):
        raise ValueError(f"rows per block must be 1, 2, 4 or 8, got {rb}")
    need = smem_bytes(dhp, bits, chunk, rb)
    if need > MAX_SMEM:
        raise ValueError(f"head dim {dh} at {bits} bits, chunk {chunk} and "
                         f"{rb} rows a block needs {need} B of shared "
                         f"memory (> {MAX_SMEM})")
    out = torch.empty_like(q)
    part_ml = part_acc = None
    if nch > 1:
        f32 = dict(dtype=torch.float32, device=q.device)
        part_ml = torch.empty((B, hk, C * g, nch, 2), **f32)
        part_acc = torch.empty((B, hk, C * g, nch, dh), **f32)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = nvcc.load("paged_attention", "paged_attention_launch", _ARGTYPES)(
        ptr(q), ptr(k_codes), ptr(k_scales), ptr(v_codes), ptr(v_scales),
        ptr(block_tables), ptr(positions),
        ptr(codebook) if bits == 4 else None, ptr(out), ptr(part_ml),
        ptr(part_acc), B, C, H, hk, dh, dhp, bs, nseq, bits, int(window),
        OUT_TYPES[q.dtype], float(softcap), float(dh**-0.5), chunk, rb,
        stream)
    if err != 0:
        raise RuntimeError(f"paged attention kernel launch failed: CUDA "
                           f"error {err} (B={B}, C={C}, H={H}, Hk={hk}, "
                           f"Dh={dh}, bs={bs}, nseq={nseq}, chunk={chunk})")
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
                          softcap: float = 0.0,
                          chunk: int = CHUNK) -> torch.Tensor:
    """The kernel's function in plain PyTorch: the same chunks, each a
    fixed-shape tile of ``chunk`` view slots whatever nseq (slots past a
    row's last needed block masked), each chunk's softmax in the kernel's
    op order, and the same combine in chunk order.  A chunk a row does
    not need is an empty partial (m = -1e30, l = 0, acc = 0), which the
    combine adds as exactly 0, as the kernel skips it.  The kernel's
    rows per block change no bit."""
    B, C, H, dh, bs, hk, g, nseq = _check(
        q, k_codes, k_scales, v_codes, v_scales, block_tables, positions,
        bits, codebook, block_size)
    _check_chunk(chunk)
    dev, f32 = q.device, torch.float32
    table = (packing.b_values(f32, dev) if codebook is None
             else codebook.to(f32))
    scale = torch.tensor(dh**-0.5, dtype=f32, device=dev)
    qs = (q.to(f32) * scale).reshape(B, C, hk, g, dh)
    pos = positions.to(torch.int64)
    lo, hi, hi_slot = live_chunks(positions, block_size=bs, nseq=nseq,
                                  window=window, chunk=chunk)
    nb = k_codes.shape[0]
    flat = lambda t: t.reshape(nb * bs, hk, *t.shape[3:])  # noqa: E731
    kc, ks, vc, vs = map(flat, (k_codes, k_scales, v_codes, v_scales))
    bt = block_tables.to(torch.int64)
    slot = torch.arange(chunk, device=dev)
    dec = dict(bits=bits, table=table, head_dim=dh)
    parts = []
    for c in range(int(lo.min()), int(hi.max())):
        sl = c * chunk + slot
        rows = (bt[:, torch.clamp(sl // bs, max=nseq - 1)] * bs
                + sl % bs)  # (B, chunk) pool rows
        k = _decode_block(kc[rows], ks[rows], **dec)  # (B, chunk, Hk, Dh)
        v = _decode_block(vc[rows], vs[rows], **dec)
        s = torch.einsum("bchgd,bjhd->bhgcj", qs, k)
        if softcap:
            s = softcap * torch.tanh(s / softcap)
        ok = ((sl[None, None, :] <= pos[:, :, None])
              & (sl[None, None, :] < hi_slot[:, None, None]))  # (B, C, chunk)
        if window:
            ok &= sl[None, None, :] > pos[:, :, None] - window
        s = torch.where(ok[:, None, None], s, NEG_INF)
        m = s.amax(-1)
        p = torch.exp(s - m[..., None])
        l = p.sum(-1)
        acc = torch.einsum("bhgcj,bjhd->bhgcd", p, v)
        live = ((c >= lo) & (c < hi)).view(B, 1, 1, 1)
        parts.append((torch.where(live, m, NEG_INF),
                      torch.where(live, l, 0.0),
                      torch.where(live[..., None], acc, 0.0)))
    M = torch.stack([m for m, _, _ in parts]).amax(0)
    num = torch.zeros_like(parts[0][2])
    den = torch.zeros_like(parts[0][1])
    for m, l, acc in parts:
        w = torch.exp(m - M)
        num = num + w[..., None] * acc
        den = den + w * l
    out = num / torch.clamp(den, min=1e-30)[..., None]  # (B, Hk, g, C, Dh)
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
