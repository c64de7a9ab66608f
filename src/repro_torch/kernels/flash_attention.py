"""Flash attention for Hopper (``csrc/flash_attention.cu``), its plain
PyTorch version, and its launch counter.

Replaces the Pallas TPU kernel
``repro/kernels/flash_attention.py::flash_attention_pallas`` (``_kernel``,
pallas_call at line 104): causal, windowed and soft-capped GQA attention
over q (B, H, Sq, dh) and k/v (B, Hk, Skv, dh), kv head ``h // (H //
Hk)``, with the online-softmax recurrence over key tiles

    m' = max(m, rowmax(s));  p = exp(s - m');  c = exp(m - m')
    l' = c·l + rowsum(p);    acc' = c·acc + p @ v

and ``acc / max(l, 1e-30)`` in q's dtype at the end.

What bounds it on an H100.  A call reads q, k and v once and writes the
output (75 MB at gemma-2b's 8k prefill in bf16: 0.023 ms at 3.35 TB/s),
and does 4·dh operations per (query head, visible (q, k) pair): 2.75e11
at that shape, 0.28 ms on the bf16 tensor cores (989 TFLOP/s) and 4.1 ms
in f32 (67 TFLOP/s).  At prefill shapes it is bound by operations, by two
orders of magnitude, and the first port's f32 FMA loop held every bf16
case at 12–13 TFLOP/s.

What the design does about it.  The TPU kernel stages a kv head's whole
(Skv, dh) K and V per grid step; here one CUDA block owns ``tq`` query
rows of one head and streams ``tk``-key tiles of K and V through shared
memory in a loop that takes the place of the TPU's ``fori_loop``.  The
loop starts at the first tile that reaches the lowest window start of the
block's rows and ends at the causal diagonal, and the grid launches the
longest causal rows first.  Two routes:

* **bf16 or f16 q, k and v** (one type): the tensor cores.  A warp owns
  16 query rows; K and V tiles arrive through a ring of ``stages`` shared
  buffers by 16-byte ``cp.async`` copies, so loads overlap the products;
  both products are ``mma.sync.m16n8k16`` with f32 accumulation on
  ``ldmatrix`` fragments (rows padded so no ldmatrix has a bank
  conflict), and the softmax runs on the accumulator fragments in
  registers.  q·k is taken in the inputs' type and ``dh**-0.5`` scales
  s in f32 after the product.  p feeds p·v as two operands, ``p_hi =
  bf16(p)`` and ``p_lo = bf16(p - p_hi)``: rounding p to bf16 once, as
  FlashAttention-2 and sdpa do, puts the outputs tens of bf16 ulps from
  the f32 route on the tests' shapes, where the split keeps them within
  one (``tests/test_torch_flash.py``), for 1.5x the mma work.  The tiles
  are template arguments of the kernel; :data:`MMA_VARIANTS` lists the
  compiled ones and :data:`MMA_TILES` the one taken for each head-dim
  class (dh rounded up to a power of two, the padding zero).
* **anything else** (f32, or mixed types): register-blocked f32 FMA on
  64 x 64 tiles, q scaled by ``dh**-0.5`` before the dot, unchanged from
  the first port.  Tensor cores for f32 (3xTF32) are later work.

Numerics follow the Pallas kernel otherwise: softcap is ``c·tanh(s/c)``
before the mask, masked logits are the finite ``NEG_INF = -1e30`` (never
-inf: a tile masked for a row before any visible key gives p = 1, and the
next visible tile's corr = exp(-1e30 - m) = 0 erases it exactly, so
skipping the tiles below the window changes no bit of a row that sees a
key), and q and k positions both start at 0.  Keys past the end of k do
not exist: they get probability exactly 0.  :func:`flash_attention_plain`
runs the same recurrence over the same key tiles in the route's op
order; kernel and plain version differ only in the order of the sums
inside a product and in the last ulps of tanh and exp.
"""

from __future__ import annotations

import bisect
import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import nvcc
from repro_torch.kernels.msgemm import OUT_TYPES

NEG_INF = -1e30
TQ = TK = 64  # kTQ, kTK in csrc/flash_attention.cu: the FMA route's tiles
MAX_HEAD_DIM = 256  # kMaxDh
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 11
             + [ctypes.c_float, ctypes.c_float] + [ctypes.c_int] * 3
             + [ctypes.c_void_p])
TENSOR_CORE_TYPES = (torch.bfloat16, torch.float16)
# The tensor-core variants compiled into csrc/flash_attention.cu
# (FLASH_MMA_VARIANTS): (dtype, head-dim class, tq, tk, stages)
MMA_VARIANTS = tuple(
    [(dt, dc, 128, 64, 2) for dt in TENSOR_CORE_TYPES
     for dc in (16, 32, 64, 128, 256)]
    + [(torch.bfloat16, 256, tq, tk, st)
       for tq, tk, st in ((64, 64, 2), (64, 32, 2), (128, 32, 2),
                          (64, 32, 3), (128, 32, 3))])
# The variant each head-dim class takes, both types: 128 query rows (8
# warps), 64-key tiles, two stages, the fastest at both 8k prefill
# shapes of chip_smoke.py --sweep on an H100 (PERF.md)
MMA_TILES = {dc: (128, 64, 2) for dc in (16, 32, 64, 128, 256)}

# Kernel launches since the last reset; only flash_attention_cuda adds to
# it, so a run of the op can prove that it went through the kernel.
launches = 0


class FlashTiles(NamedTuple):
    """Query rows per block (tq) and keys per streamed tile (tk), and the
    tensor-core route's ring depth (stages; 1 on the FMA route).  The
    tiles fix where the online softmax rescales, so the kernel and the
    plain version take the same ones."""

    tq: int
    tk: int
    stages: int = 1


def dh_class(dh: int) -> int:
    """The tensor-core route's head-dim class: dh rounded up to a power of
    two, at least 16 (the kernel's DP; the padding columns are zero)."""
    return max(16, 1 << (dh - 1).bit_length())


def tensor_core_dtype(q, k, v):
    """The type the tensor-core route computes in (q, k and v all bf16 or
    all f16), or None for the FMA route."""
    if q.dtype in TENSOR_CORE_TYPES and q.dtype == k.dtype == v.dtype:
        return q.dtype
    return None


def flash_tiles(dh: int, dtype=None) -> FlashTiles:
    """The Hopper tiles for a head dim: on the tensor-core route (dtype
    bf16 or f16) the variant :data:`MMA_TILES` gives its class, else the
    FMA route's 64 x 64; whatever the sequence lengths."""
    if dh > MAX_HEAD_DIM:
        raise ValueError(f"head dim {dh} > {MAX_HEAD_DIM}: the flash kernel "
                         f"is compiled up to {MAX_HEAD_DIM}")
    if dtype in TENSOR_CORE_TYPES:
        return FlashTiles(*MMA_TILES[dh_class(dh)])
    return FlashTiles(TQ, TK)


def _check(q, k, v):
    """Validate shapes and devices; returns (B, H, Sq, dh, Hk, Skv)."""
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q (B, H, Sq, dh) and k/v (B, Hk, Skv, dh) must "
                         f"be 4-D, got {tuple(q.shape)}, {tuple(k.shape)}")
    B, H, Sq, dh = q.shape
    Hk, Skv = k.shape[1], k.shape[2]
    if tuple(k.shape) != (B, Hk, Skv, dh) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} must be "
                         f"({B}, Hk, Skv, {dh})")
    if H % Hk:
        raise ValueError(f"{H} query heads do not group onto {Hk} kv heads")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
    return B, H, Sq, dh, Hk, Skv


def key_tiles(nq: int, nk: int, *, tq: int, tk: int, causal: bool,
              window: int, skip_below_window: bool = True):
    """Per query tile i, the key tiles [lo_i, hi_i) it visits: from the
    tile holding its rows' lowest window start (0 without a window or
    with ``skip_below_window`` off) to the causal diagonal, as the
    Pallas kernel bounds it (every tile when not causal)."""
    lo, hi = [], []
    for i in range(nq):
        lo.append(max(0, i * tq - window + 1) // tk
                  if window and skip_below_window else 0)
        hi.append(min(-(-((i + 1) * tq) // tk), nk) if causal else nk)
    return lo, hi


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int = 0,
                         softcap: float = 0.0, tq: int | None = None,
                         tk: int | None = None,
                         stages: int | None = None) -> torch.Tensor:
    """(B, H, Sq, dh) attention output in q's dtype, on the GPU.

    q (B, H, Sq, dh), k/v (B, Hk, Skv, dh), each contiguous f32, bf16 or
    f16 (they may differ: all bf16 or all f16 take the tensor cores);
    H % Hk == 0; dh <= 256.  Tiles default to :func:`flash_tiles`'; only
    the compiled ones are taken (:data:`MMA_VARIANTS`, 64 x 64 on the
    FMA route)."""
    global launches
    B, H, Sq, dh, Hk, Skv = _check(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_cuda needs CUDA tensors, got "
                         f"{q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype not in OUT_TYPES or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous f32/bf16/f16, got "
                             f"{t.dtype}")
    dtype = tensor_core_dtype(q, k, v)
    dflt = flash_tiles(dh, dtype)
    tq, tk = tq or dflt.tq, tk or dflt.tk
    stages = stages or dflt.stages
    if dtype is not None:
        if (dtype, dh_class(dh), tq, tk, stages) not in MMA_VARIANTS:
            raise ValueError(f"no tensor-core variant compiled for {dtype} "
                             f"at head-dim class {dh_class(dh)} with tiles "
                             f"({tq}, {tk}) and {stages} stages")
    elif (tq, tk) != (TQ, TK):
        raise ValueError(f"the FMA route is compiled for tiles ({TQ}, {TK}), "
                         f"got ({tq}, {tk})")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = nvcc.load("flash_attention", "flash_attention_launch", _ARGTYPES)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, H, Hk, Sq, Skv, dh, int(causal), int(window),
        OUT_TYPES[q.dtype], OUT_TYPES[k.dtype], OUT_TYPES[v.dtype],
        float(softcap), float(dh**-0.5), tq, tk, stages, stream)
    if err != 0:
        raise RuntimeError(f"flash attention kernel launch failed: CUDA "
                           f"error {err} (B={B}, H={H}, Hk={Hk}, Sq={Sq}, "
                           f"Skv={Skv}, dh={dh}, tiles=({tq}, {tk}, "
                           f"{stages}))")
    launches += 1
    return out


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int = 0,
                          softcap: float = 0.0, tq: int | None = None,
                          tk: int | None = None,
                          skip_below_window: bool = True) -> torch.Tensor:
    """The kernel's function in plain PyTorch: the same recurrence over the
    same key tiles in the kernel's op order, vectorized over heads and
    query tiles (so it stays usable at 32k on the card).  Each key tile's
    scores are computed for every row from the first query tile that
    visits it, and the rows of the tiles that do not (past the causal
    diagonal's end, or below their window with ``skip_below_window``)
    keep their state: so the products have the same shapes either way,
    and skipping changes no bit of a row that sees a key.

    On the tensor-core route (q, k and v all bf16 or all f16) the scale
    multiplies the f32 product, and p enters p·v as ``p_hi = bf16(p)``
    plus ``p_lo = bf16(p - p_hi)`` (f16 for f16), two products; on the FMA
    route q is scaled before the dot and p stays f32.  Tiles default to
    :func:`flash_tiles`', as the kernel's do."""
    B, H, Sq, dh, Hk, Skv = _check(q, k, v)
    dtype = tensor_core_dtype(q, k, v)
    dflt = flash_tiles(dh, dtype)
    tq, tk = tq or dflt.tq, tk or dflt.tk
    g = H // Hk
    dev, f32 = q.device, torch.float32
    scale = torch.tensor(dh**-0.5, dtype=f32, device=dev)
    qs = q.to(f32) if dtype is not None else q.to(f32) * scale
    qs = qs.reshape(B, Hk, g, Sq, dh)
    m = torch.full((B, Hk, g, Sq), NEG_INF, dtype=f32, device=dev)
    l = torch.zeros((B, Hk, g, Sq), dtype=f32, device=dev)
    acc = torch.zeros((B, Hk, g, Sq, dh), dtype=f32, device=dev)
    nq, nk = -(-Sq // tq), -(-Skv // tk)
    lo, hi = key_tiles(nq, nk, tq=tq, tk=tk, causal=causal, window=window,
                       skip_below_window=skip_below_window)
    qpos = torch.arange(Sq, device=dev)
    for j in range(nk):
        # lo and hi do not decrease with i: tiles [i0, i1) visit tile j
        i0, i1 = bisect.bisect_right(hi, j), bisect.bisect_right(lo, j)
        if i0 >= i1:
            continue
        r0 = i0 * tq
        k0, k1 = j * tk, min((j + 1) * tk, Skv)
        kb, vb = k[:, :, k0:k1].to(f32), v[:, :, k0:k1].to(f32)
        s = torch.einsum("bhgqd,bhkd->bhgqk", qs[:, :, :, r0:], kb)
        if dtype is not None:
            s = s * scale
        if softcap:
            s = softcap * torch.tanh(s / softcap)
        qp = qpos[r0:, None]
        kp = torch.arange(k0, k1, device=dev)[None, :]
        ok = torch.ones((Sq - r0, k1 - k0), dtype=torch.bool, device=dev)
        if causal:
            ok &= kp <= qp
        if window:
            ok &= kp > qp - window
        s = torch.where(ok, s, NEG_INF)
        m_old, l_old, acc_old = m[..., r0:], l[..., r0:], acc[..., r0:, :]
        m_new = torch.maximum(m_old, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m_old - m_new)
        l_new = corr * l_old + p.sum(-1)
        if dtype is None:
            pv = torch.einsum("bhgqk,bhkd->bhgqd", p, vb)
        else:
            p_hi = p.to(dtype).to(f32)
            p_lo = (p - p_hi).to(dtype).to(f32)
            pv = (torch.einsum("bhgqk,bhkd->bhgqd", p_hi, vb)
                  + torch.einsum("bhgqk,bhkd->bhgqd", p_lo, vb))
        acc_new = corr[..., None] * acc_old + pv
        live = qpos[r0:] < i1 * tq  # rows of the tiles that visit j
        m[..., r0:] = torch.where(live, m_new, m_old)
        l[..., r0:] = torch.where(live, l_new, l_old)
        acc[..., r0:, :] = torch.where(live[:, None], acc_new, acc_old)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(B, H, Sq, dh).to(q.dtype)


def flash_attention(q, k, v, **kw) -> torch.Tensor:
    """Route by device: the kernel for CUDA tensors, the plain version for
    CPU tensors; anything else raises.  There is no fallback."""
    if q.device.type == "cuda":
        return flash_attention_cuda(q, k, v, **kw)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, **kw)
    raise ValueError(f"flash_attention: unsupported device {q.device}")
