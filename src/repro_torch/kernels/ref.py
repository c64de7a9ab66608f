"""Plain PyTorch oracles for the kernels; port of repro.kernels.ref.

Each function repeats its JAX twin's op order on torch tensors, so the
tests can hold the two against each other on the same numpy inputs and
then use either as the oracle of a kernel:

* :func:`msgemm_ref`        LUT produce then the per-chunk scaled consume
                            (paper Eq. 5 with §3.3 scales);
* :func:`msgemm_tiled_ref`  the op-order replay of the TPU's fused msGeMM
                            kernel: its (b, j, m) tile loops, per-tile
                            produce, chunk gathers summed within a scale
                            block, one scale multiply per block, j-ordered
                            stripe sums and the epilogue at write-back;
* :func:`int4_matmul_ref`   dequantize, then a dense matmul;
* :func:`flash_attention_ref`  masked softmax attention over whole rows.
"""

from __future__ import annotations

import torch

from repro_torch.core import lut, packing
from repro_torch.core.epilogue import Epilogue, torch_dtype

NEG_INF = -1e30


def msgemm_ref(idx: torch.Tensor, x: torch.Tensor, scales: torch.Tensor, *,
               d: int, scale_block: int, codebook=None) -> torch.Tensor:
    """Oracle for the msGeMM kernel: idx (m, ceil(k/d)) LUT indices, x
    (k, b), scales (m, ceil(k/scale_block)) -> (m, b) f32."""
    table = lut.produce(x.to(torch.float32), d, dtype=torch.float32,
                        codebook=codebook)
    return lut.consume(table, idx, scales=scales, scale_block=scale_block,
                       d=d)


def _rup(v: int, t: int) -> int:
    return -(-v // t) * t


def msgemm_tiled_ref(codes: torch.Tensor, x: torch.Tensor,
                     scales: torch.Tensor, *, d: int, scale_block: int,
                     tm: int, tj: int, tb: int, codebook=None,
                     epilogue: Epilogue | None = None, bias=None,
                     residual=None) -> torch.Tensor:
    """Op-order replay of the TPU's fused msGeMM kernel with tiles (tm,
    tj, tb), padding as its wrapper pads.  codes (m, k) unpacked, x (k,
    b), bias (m,) and residual (m, b) in the kernels' column layout."""
    ep = epilogue or Epilogue()
    f32 = torch.float32
    m, k = codes.shape
    b = x.shape[1]
    idx = packing.pack_indices(codes, d).long()
    kc = idx.shape[1]
    mp, kcp, bp = _rup(m, tm), _rup(kc, tj), _rup(b, tb)
    sj = kcp * d // scale_block
    pad = torch.nn.functional.pad
    idx = pad(idx, (0, kcp - kc, 0, mp - m))
    xp = pad(x.to(f32), (0, bp - b, 0, kcp * d - x.shape[0]))
    sc = pad(scales.to(f32), (0, sj - scales.shape[1], 0, mp - m))
    basis = lut.tuple_basis(d, f32, codebook=codebook, device=x.device)
    bias_p = pad(bias.to(f32), (0, mp - m)) if ep.bias else None
    res_p = (pad(residual.to(f32), (0, bp - b, 0, mp - m))
             if ep.residual else None)
    out_dtype = torch_dtype(ep.out_dtype) or f32
    act = ep.act_fn()
    cpb = scale_block // d
    nsb_t = tj * d // scale_block  # scale blocks per j tile
    cols = []
    for ib in range(bp // tb):
        stripe_acc = [None] * (mp // tm)
        for ij in range(kcp // tj):
            xblk = xp[ij * tj * d:(ij + 1) * tj * d,
                      ib * tb:(ib + 1) * tb].reshape(tj, d, tb)
            lut_t = torch.einsum("nr,jrb->njb", basis, xblk)
            for im in range(mp // tm):
                idx_t = idx[im * tm:(im + 1) * tm, ij * tj:(ij + 1) * tj]
                sc_t = sc[im * tm:(im + 1) * tm,
                          ij * nsb_t:(ij + 1) * nsb_t]
                acc = torch.zeros((tm, tb), dtype=f32, device=x.device)
                for blk in range(tj // cpb):
                    part = torch.zeros((tm, tb), dtype=f32, device=x.device)
                    for c in range(cpb):
                        tjc = blk * cpb + c
                        part = part + lut_t[:, tjc, :][idx_t[:, tjc]]
                    acc = acc + part * sc_t[:, blk][:, None]
                stripe_acc[im] = (acc if stripe_acc[im] is None
                                  else stripe_acc[im] + acc)
        stripe = []
        for im, total in enumerate(stripe_acc):
            if ep.bias:
                total = total + bias_p[im * tm:(im + 1) * tm][:, None]
            total = act(total)
            if ep.residual:
                total = total + res_p[im * tm:(im + 1) * tm,
                                      ib * tb:(ib + 1) * tb]
            stripe.append(total.to(out_dtype))
        cols.append(torch.cat(stripe, dim=0))
    return torch.cat(cols, dim=1)[:m, :b]


def int4_matmul_ref(u8: torch.Tensor, scales: torch.Tensor, x: torch.Tensor,
                    *, scale_block: int) -> torch.Tensor:
    """Oracle for the int4 GeMM kernel: packed u8 (m, ceil(k/2)), scales
    (m, ceil(k/scale_block)), x (k, b) -> (m, b) f32."""
    k = x.shape[0]
    codes = packing.unpack_storage(u8, k).to(torch.int32)
    vals = torch.where(codes <= 7, codes, codes - 16).to(torch.float32)
    q = torch.repeat_interleave(scales, scale_block, dim=1)[:, :k] \
        .to(torch.float32)
    return (vals * q) @ x.to(torch.float32)


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                        softcap: float = 0.0) -> torch.Tensor:
    """Oracle for the flash-attention kernel: q (BH, Sq, dh), k/v (BH, Skv,
    dh).  The scale multiplies the logits after the dot; positions start
    at 0 for both queries and keys."""
    dh = q.shape[-1]
    s = torch.einsum("bqd,bkd->bqk", q.to(torch.float32),
                     k.to(torch.float32)) * dh**-0.5
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    Sq, Skv = s.shape[1], s.shape[2]
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Skv, device=q.device)[None, :]
    ok = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        ok &= kpos <= qpos
    if window:
        ok &= kpos > qpos - window
    s = torch.where(ok[None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p,
                        v.to(torch.float32)).to(q.dtype)
