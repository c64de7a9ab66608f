"""Attention (GQA/MQA, RoPE, sliding window, soft-cap, cross-attention)
with full-sequence, single-step-decode and paged paths; port of
repro.models.layers.  The reference's ``_chunk_mask`` (a q chunk's mask
at a traced offset) is :func:`causal_mask` with ``offset``.

The paged path keeps a full-precision KV pool, or with ``cfg.kv_quant``
the quantized pool of repro_torch.kvq, read through its paged-attention
backends.

Serving on a mesh (``distributed.sharding.use``) runs the training
layout, by the :func:`head_layout` that ``runtime.serve.shard_params``
cut the weights by and recorded (``Attention.layout``): where the query heads split evenly over
'model' (and the kv heads do too, or there is one), wq returns this
rank's heads, wk/wv its kv heads (every kv head, from whole weights, when
there is one), attention runs on them and ``wo`` takes its heads' output
as its k slice.  Otherwise every rank attends every head, as before: the
projections' outputs are gathered whole.  The paged pool holds this
rank's kv heads (``PAGED_CACHE_AXES``; whole when they do not split), and
a step's new K/V rows are gathered over the batch axis when its rows are
split (the pool is whole over 'data').  The static decode cache holds
this rank's kv heads, or, where the kv heads cannot take 'model', this
rank's block of the sequence (``CACHE_AXES``' 'kv_seq'): prefill writes
each rank's positions, decode writes the new K/V on the rank that owns
``pos``, and every rank attends every head over its positions, the ranks'
partial softmax combined (:func:`_sdpa_split`).

Where the query heads cannot take 'model' (:attr:`HeadLayout.q_whole`)
every rank holds the attention's weights whole, and a full-sequence pass
(prefill, the encoder, a prefill's cross attention) splits its query
positions over 'model' instead, as the reference's 'seq' rule does
(``sharding.residual_axis``: where S divides the axis): this rank's
block of S/M positions, the residual's block, runs the projections, its
queries attend over every key (K and V computed on the block and
gathered), and ``wo`` and the residual act on the block, which stays
this rank's (:func:`_attn_seq`).  A softmax row sees all its keys, so
no partial softmax is combined.  Where the heads split, the residual's
block is gathered whole at entry and ``wo``'s partial sums are
reduce-scattered over the positions.

A training step on a mesh runs :func:`attn_apply_tp` instead, on the
weights ``constrain_params`` gathered over 'data' — the decoder's causal
attention, the encoder's non-causal one and the cross attention: with
the query heads split over 'model', wq is column-parallel, its heads
stay sharded through the attention (qk-norm too) into a row-parallel
``wo`` that ends in a reduce-scatter over the positions (a psum where
the residual stays whole), and each rank computes the kv heads its
query heads read (whole when they do not split: MQA), of the encoder's
output in a cross attention; where the heads cannot split (their count,
or an uneven grouping over the kv heads) the query positions split with
the residual, on weights gathered whole; otherwise every rank runs the
whole attention.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from repro_torch import kvq
from repro_torch.distributed import collectives as coll
from repro_torch.distributed import compat
from repro_torch.distributed import sharding
from repro_torch.models import common

NEG_INF = -1e30  # finite mask value: masked entries get probability exactly 0
# the collective of a query block (a ``collectives.counts`` kind): the
# block's K and V gathered over the sequence
SEQ_KV = "seq_kv_gather"


# ---------------------------------------------------------------- RoPE
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return theta ** (-torch.arange(0, head_dim, 2, dtype=torch.float32,
                                   device=device) / head_dim)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x (B, S, H, Dh), positions (B, S) -> rotated x.  The rotation pairs
    the two halves of Dh (not interleaved pairs), as the reference."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    ang = positions[..., None].to(torch.float32) * freqs  # (B, S, Dh/2)
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------- attention
class HeadLayout(NamedTuple):
    """How attention's heads lie on the 'model' axis (``M`` ranks, this
    one ``r``): ``q_local`` — this rank runs query heads [r·H/M,
    (r+1)·H/M), from wq's block; ``kv_local`` — and holds kv heads
    [r·Hk/M, (r+1)·Hk/M) (its cache and pool too).  With ``q_local`` but
    not ``kv_local`` there is one kv head, which every rank computes
    whole."""

    M: int = 1
    r: int = 0
    q_local: bool = False
    kv_local: bool = False

    @property
    def kv_whole(self) -> bool:
        """wk/wv held whole by every rank (one kv head)."""
        return self.q_local and not self.kv_local

    @property
    def seq_split(self) -> bool:
        """The static cache splits its sequence over 'model'."""
        return self.M > 1 and not self.kv_local

    @property
    def q_whole(self) -> bool:
        """The query heads cannot take 'model': every rank holds wq, wk,
        wv and wo whole, and a full-sequence pass splits its query
        positions over 'model' instead (:func:`_attn_seq`).  The cache
        then splits its sequence too (:attr:`seq_split`)."""
        return self.M > 1 and not self.q_local


def head_layout(cfg, mesh) -> HeadLayout:
    """The :class:`HeadLayout` of ``cfg`` on ``mesh``
    (``runtime.serve.shard_params`` cuts the weights by it and records it
    as ``Attention.layout``)."""
    M = sharding.tp_size(mesh)
    if M == 1:
        return HeadLayout()
    h, hk = cfg.num_heads, cfg.num_kv_heads
    kv_local = hk % M == 0
    return HeadLayout(M, sharding.coord(mesh, sharding.TP_AXIS),
                      h % M == 0 and (kv_local or hk == 1), kv_local)


class Attention(nn.Module):
    """wq / wk / wv / wo linears (+ q/k norms when ``cfg.qk_norm``).
    ``layout``: the :class:`HeadLayout` ``runtime.serve.shard_params`` cut
    the heads by on a mesh (every head on one device otherwise)."""

    layout = HeadLayout()

    def __init__(self, wq, wk, wv, wo, q_norm=None, k_norm=None):
        super().__init__()
        self.wq, self.wk, self.wv, self.wo = wq, wk, wv, wo
        if q_norm is not None:
            self.q_norm, self.k_norm = q_norm, k_norm


def attn_init(cfg, *, generator: torch.Generator, device=None) -> Attention:
    d, h, hk, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    kw = dict(generator=generator, device=device)
    lin = lambda i, o: common.linear_init(i, o, cfg, cfg.quant, **kw)  # noqa: E731
    norms = ((common.norm_init(dh, "rmsnorm", device=device),
              common.norm_init(dh, "rmsnorm", device=device))
             if cfg.qk_norm else ())
    return Attention(lin(d, h * dh), lin(d, hk * dh), lin(d, hk * dh),
                     lin(h * dh, d), *norms)


def _kv(p: Attention, cfg, x):
    """wk/wv of ``x``: this rank's kv heads, or all of them."""
    kw = dict(in_dim=cfg.d_model, local=p.layout.kv_local)
    k = common.linear_apply(p.wk, x, cfg.quant, tag="wk", **kw)
    v = common.linear_apply(p.wv, x, cfg.quant, tag="wv", **kw)
    shape = (*x.shape[:2], -1, cfg.head_dim)
    return k.reshape(shape), v.reshape(shape)


def _qkv(p: Attention, cfg, x, positions):
    dh = cfg.head_dim
    q = common.linear_apply(p.wq, x, cfg.quant, in_dim=cfg.d_model,
                            tag="wq", local=p.layout.q_local)
    q = q.reshape(*x.shape[:2], -1, dh)
    k, v = _kv(p, cfg, x)
    if cfg.qk_norm:
        q = common.norm_apply(p.q_norm, q, "rmsnorm")
        k = common.norm_apply(p.k_norm, k, "rmsnorm")
    if cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _sdpa(cfg, q, k, v, mask) -> torch.Tensor:
    """q (B,Sq,H,Dh), k/v (B,Skv,Hk,Dh), mask (B|1,1,Sq,Skv) bool or None.
    The reference's einsum + softmax with a finite mask value."""
    B, Sq, h, dh = q.shape
    hk = k.shape[2]
    qg = q.reshape(B, Sq, hk, h // hk, dh)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg.to(torch.float32),
                          k.to(torch.float32)) * dh**-0.5
    logits = common.softcap(logits, cfg.attn_logit_softcap)
    if mask is not None:
        logits = torch.where(mask[:, :, None] if mask.ndim == 4 else mask,
                             logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.to(torch.float32))
    return out.reshape(B, Sq, h * dh).to(q.dtype)


def _sdpa_split(cfg, q, k, v, mask, axis: str) -> torch.Tensor:
    """:func:`_sdpa` where ``k``/``v`` (B, Sl, Hk, Dh) are this rank's
    block of the key positions over ``axis`` (``mask`` (B|1, 1, Sq, Sl)
    or None) and ``q`` holds every head: each rank's logits, their max
    over the ranks (``collectives.pmax``), then the exp-sums and the
    weighted values summed over the ranks in one psum.  Returns (B, Sq,
    H·Dh), the same on every rank."""
    B, Sq, h, dh = q.shape
    hk = k.shape[2]
    qg = q.reshape(B, Sq, hk, h // hk, dh)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg.to(torch.float32),
                          k.to(torch.float32)) * dh**-0.5
    logits = common.softcap(logits, cfg.attn_logit_softcap)
    if mask is not None:
        logits = torch.where(mask[:, :, None], logits, NEG_INF)
    top = coll.pmax(logits.amax(dim=-1, keepdim=True), axis)
    probs = torch.exp(logits - top)
    both = torch.cat([torch.einsum("bhgqk,bkhd->bhgqd", probs,
                                   v.to(torch.float32)),
                      probs.sum(dim=-1, keepdim=True)], dim=-1)
    both = coll.psum(both, axis)
    out = both[..., :dh] / both[..., dh:]  # (B, Hk, G, Sq, Dh)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, h * dh).to(q.dtype)


def _wo(p: Attention, cfg, out, *, local: bool, residual=None, seq=None):
    """``wo`` of the heads' output: this rank's heads (``local``: its k
    slice) or every head; ``seq``: its output on this rank's block of
    the positions over that axis (``common.linear_apply``)."""
    return common.linear_apply(
        p.wo, out, cfg.quant, in_dim=cfg.num_heads * cfg.head_dim,
        tag="wo", residual=residual,
        x_axis=sharding.TP_AXIS if local else None, seq=seq)


def seq_block(t: torch.Tensor, lay: HeadLayout) -> torch.Tensor:
    """This rank's block of ``t``'s positions (dim 1) where the static
    cache splits its sequence; ``t`` itself otherwise."""
    if not lay.seq_split:
        return t
    n = t.shape[1] // lay.M
    return t.narrow(1, lay.r * n, n)


def write_prefill(cache: dict, name: str, t: torch.Tensor,
                  lay: HeadLayout) -> None:
    """Write a prompt's K or V ``t`` (B, S, ., Dh) at positions 0..S-1
    of ``cache[name]``: where the cache splits its sequence, the
    positions of this rank's block."""
    c = cache[name]
    lo = lay.r * c.shape[1] if lay.seq_split else 0
    n = max(0, min(t.shape[1] - lo, c.shape[1]))
    c[:, :n] = t[:, lo:lo + n].to(c.dtype)


def causal_mask(Sq: int, Skv: int, *, window: int = 0, offset: int = 0,
                device=None) -> torch.Tensor:
    """(1, 1, Sq, Skv) bool; offset = start position of the query block."""
    qpos = offset + torch.arange(Sq, device=device)[:, None]
    kpos = torch.arange(Skv, device=device)[None, :]
    m = kpos <= qpos
    if window:
        m &= kpos > qpos - window
    return m[None, None]


def view_mask(Skv: int, positions: torch.Tensor, *, window: int = 0
              ) -> torch.Tensor:
    """Causal (+ window) mask over a logically ordered KV view: view index
    w holds the KV of position w.  positions (B, C) -> (B, C, Skv) bool."""
    kpos = torch.arange(Skv, device=positions.device)[None, None, :]
    qpos = positions[:, :, None]
    m = kpos <= qpos
    if window:
        m &= kpos > qpos - window
    return m


def _attend(cfg, q, k, v, *, causal: bool = True, window: int = 0,
            offset: int = 0) -> torch.Tensor:
    """The queries ``q`` (B, Sq, H, Dh), at positions offset..offset+Sq-1,
    over every key ``k``/``v`` (B, Skv, Hk, Dh): causal (+ window) at
    their true positions, or unmasked.  Above ``cfg.attn_chunk`` the
    queries run in chunks of it (exact math, bounded logits memory)."""
    Sq, Skv = q.shape[1], k.shape[1]
    C = cfg.attn_chunk
    if not (C and Sq > C and Sq % C == 0):
        C = Sq
    outs = [_sdpa(cfg, q[:, i:i + C], k, v,
                  causal_mask(C, Skv, window=window, offset=offset + i,
                              device=q.device) if causal else None)
            for i in range(0, Sq, C)]
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


def attn_apply(p: Attention, cfg, x, positions, *, window: int = 0,
               causal: bool = True, return_kv: bool = False, residual=None,
               seq: str | None = None):
    """Full-sequence self-attention (prefill).  ``residual`` rides the
    output projection's epilogue.  Above ``cfg.attn_chunk`` the queries
    run in chunks (exact math, bounded logits memory).  ``seq``: the
    residual's positions lie over that axis (``sharding.
    residual_axis``), ``x`` and ``residual`` are this rank's block of
    them and so is the output; where the query heads split, the block is
    gathered whole and ``wo``'s partial sums are reduce-scattered over
    the positions, and where they cannot take 'model' the block's
    queries run on whole weights (:func:`_attn_seq`).  ``return_kv``
    returns every position's K/V (``positions`` are always whole)."""
    lay = p.layout
    if seq is not None and lay.q_whole:
        return _attn_seq(p, cfg, x, positions, seq, window=window,
                         causal=causal, return_kv=return_kv,
                         residual=residual)
    x = common.seq_gather(x, seq)
    q, k, v = _qkv(p, cfg, x, positions)
    out = _attend(cfg, q, k, v, causal=causal, window=window)
    out = _wo(p, cfg, out, local=lay.q_local, residual=residual, seq=seq)
    return (out, k, v) if return_kv else out


def _attn_seq(p: Attention, cfg, x, positions, axis: str, *, window: int,
              causal: bool, return_kv: bool, residual):
    """:func:`attn_apply` on this rank's block ``x`` [r·S/M, (r+1)·S/M)
    of the positions over ``axis`` (the attention's weights whole on
    every rank): the block runs wq, wk and wv, qk-norm and RoPE at its
    true positions; its K and V are gathered over ``axis``
    (``SEQ_KV``), its queries attend over every key, causal at their
    true offset; ``wo`` and the residual act on the block, which is the
    output (B, S/M, d); with ``return_kv`` also the whole K/V."""
    lo, n = sharding.seq_block(positions.shape[1], axis)
    q, k, v = _qkv(p, cfg, x, positions.narrow(1, lo, n))
    k = coll.all_gather(k, axis, dim=1, kind=SEQ_KV)
    v = coll.all_gather(v, axis, dim=1, kind=SEQ_KV)
    out = _attend(cfg, q, k, v, causal=causal, window=window, offset=lo)
    out = _wo(p, cfg, out, local=False, residual=residual)
    return (out, k, v) if return_kv else out


def _gather_heads(q: torch.Tensor, lay: HeadLayout) -> torch.Tensor:
    """Every query head (dim 2) where this rank holds its own only."""
    return coll.all_gather(q, sharding.TP_AXIS, dim=2) if lay.q_local \
        else q


def attn_decode(p: Attention, cfg, x, cache_k, cache_v, pos, *,
                window: int = 0, residual=None):
    """Single-token decode.  x (B, 1, d); cache (B, Skv, Hk, Dh); pos (B,).
    The new K/V are written into the caches in place (the reference
    returns updated copies).  Where the cache holds this rank's block of
    the sequence (:attr:`HeadLayout.seq_split`), the rank owning ``pos``
    writes, and every head attends over each rank's block
    (:func:`_sdpa_split`)."""
    lay = p.layout
    q, k, v = _qkv(p, cfg, x, pos[:, None])
    B, Skv = cache_k.shape[0], cache_k.shape[1]
    rows = torch.arange(B, device=x.device)
    if lay.seq_split:
        lo = lay.r * Skv
        own = ((pos >= lo) & (pos < lo + Skv))[:, None, None]
        at = (pos - lo).clamp(0, Skv - 1)
        for c, t in ((cache_k, k), (cache_v, v)):
            c[rows, at] = torch.where(own, t[:, 0].to(c.dtype), c[rows, at])
        m = view_mask(Skv, pos[:, None] - lo, window=window)[:, 0]
        out = _sdpa_split(cfg, _gather_heads(q, lay), cache_k, cache_v,
                          m[:, None, None, :], sharding.TP_AXIS)
        local = False
    else:
        cache_k[rows, pos] = k[:, 0].to(cache_k.dtype)
        cache_v[rows, pos] = v[:, 0].to(cache_v.dtype)
        m = view_mask(Skv, pos[:, None], window=window)[:, 0]
        out = _sdpa(cfg, q, cache_k, cache_v, m[:, None, None, :])
        local = lay.q_local
    out = _wo(p, cfg, out, local=local, residual=residual)
    return out, cache_k, cache_v


def cross_attn_apply(p: Attention, cfg, x, enc_k, enc_v, *, residual=None,
                     split: bool = False, seq: str | None = None):
    """Decoder cross-attention against the encoder's projected K/V
    (B, S_src, Hk, Dh): q from ``wq``, no mask and no RoPE, ``residual``
    riding ``wo``'s epilogue.  ``split``: ``enc_k``/``enc_v`` are this
    rank's block of the source positions (the decode cache's, where its
    sequence splits), combined over the ranks.  ``seq``: ``x`` and
    ``residual`` are this rank's block of the decoder's positions over
    that axis, and so is the output: where the query heads cannot take
    'model' the block's queries run on whole weights (every source
    position on every rank), else the block is gathered and ``wo``'s
    partial sums reduce-scattered over the positions."""
    lay = p.layout
    if seq is not None and not lay.q_whole:
        x = common.seq_gather(x, seq)
    q = common.linear_apply(p.wq, x, cfg.quant, in_dim=cfg.d_model,
                            tag="wq", local=lay.q_local)
    q = q.reshape(*x.shape[:2], -1, cfg.head_dim)
    if split:
        out = _sdpa_split(cfg, _gather_heads(q, lay), enc_k, enc_v, None,
                          sharding.TP_AXIS)
        return _wo(p, cfg, out, local=False, residual=residual)
    out = _sdpa(cfg, q, enc_k, enc_v, None)
    return _wo(p, cfg, out, local=lay.q_local, residual=residual,
               seq=None if lay.q_whole else seq)


def cross_kv(p: Attention, cfg, enc_out):
    """The encoder output (B, S_src, d) projected once by ``wk``/``wv`` to
    (B, S_src, Hk, Dh) each (this rank's kv heads on a mesh that splits
    them); prefill caches them for every decode step."""
    return _kv(p, cfg, enc_out)


def attn_paged(p: Attention, cfg, x, cache: dict, positions, write_slots,
               view_slots, *, window: int = 0, residual=None):
    """Self-attention over a paged KV pool — one chunked-prefill step
    (C > 1) or one batched decode step (C == 1).

    x (B, C, d); cache {"k", "v"} (num_blocks, bs, Hk, Dh) at full
    precision, or the quantized {"k", "k_scale", "v", "v_scale"} layout
    of repro_torch.kvq.pool when ``cfg.kv_quant`` is set;
    positions/write_slots (B, C); view_slots (B, W) flat pool slots such
    that view index w holds position w (scratch-padded).  The pool is
    updated in place with ``index_copy_`` (the reference scatters into a
    donated copy); masked view entries get probability exactly 0.

    Returns (out, cache).
    """
    lay = p.layout
    q, k, v = _qkv(p, cfg, x, positions)
    if sharding.active_mesh() is not None:
        # the pool is whole over the batch axis: every rank writes every
        # row's new K/V
        k, v = sharding.gather_rows(k), sharding.gather_rows(v)
        write_slots = sharding.gather_rows(write_slots)
    if cfg.kv_quant is not None:
        out = _attn_paged_quantized(cfg, q, k, v, cache, positions,
                                    write_slots, view_slots, window=window)
    else:
        k_pool, v_pool = cache["k"], cache["v"]
        nb, bs, hk, dh = k_pool.shape
        kp = k_pool.view(nb * bs, hk, dh)
        vp = v_pool.view(nb * bs, hk, dh)
        ws = write_slots.reshape(-1).long()
        kp.index_copy_(0, ws, k.reshape(-1, hk, dh).to(kp.dtype))
        vp.index_copy_(0, ws, v.reshape(-1, hk, dh).to(vp.dtype))
        vs = view_slots.long()
        m = view_mask(view_slots.shape[1], positions, window=window)
        out = _sdpa(cfg, q, kp[vs], vp[vs], m[:, None])
    out = _wo(p, cfg, out, local=lay.q_local, residual=residual)
    return out, cache


def _attn_paged_quantized(cfg, q, k, v, cache, positions, write_slots,
                          view_slots, *, window: int = 0):
    """Quantize on write into the codes + scales pool (in place, as the
    full-precision branch), then run the attention through the selected
    paged-attention backend (repro_torch.kvq.attention: the torch
    gather-and-dequantize reference, or the CUDA kernel that dequantizes
    on chip).  Returns (B, C, H*Dh)."""
    spec = cfg.kv_quant
    nb, bs, hk, dhp = cache["k"].shape
    ws = write_slots.reshape(-1).long()
    for name, new in (("k", k), ("v", v)):
        codes, scales = kvq.kv_quantize(new, spec)  # (B,C,Hk,Dhp), (B,C,Hk)
        cache[name].view(nb * bs, hk, dhp).index_copy_(
            0, ws, codes.reshape(-1, hk, dhp))
        cache[f"{name}_scale"].view(nb * bs, hk).index_copy_(
            0, ws, scales.reshape(-1, hk))
    return kvq.attention.run(spec, cfg, q, cache, view_slots, positions,
                             window=window)


# ------------------------------------------------------- training on a mesh
def _kv_rows(w, cfg, M: int, kv0: int, kv1: int, axis: str):
    """This rank's rows of ``wk``/``wv`` for kv heads kv0..kv1-1 (those
    its query heads read): its own block when the kv heads split over
    ``axis`` as the query heads do, else cut from the whole weight,
    gathered where its rows split finer than a head (its consumers are
    this rank's heads: their gradients sum over the ranks)."""
    hk, dh = cfg.num_kv_heads, cfg.head_dim
    if hk % M == 0 and w.shape[0] == hk * dh // M:
        return w
    w = common.whole_rows(w, hk * dh, 0, axis, partial=True)
    return w[kv0 * dh:kv1 * dh]


def attn_apply_tp(p: Attention, cfg, x, positions, *, window: int = 0,
                  residual, causal: bool = True, kv=None,
                  axis: str = "model", seq: str | None = None):
    """:func:`attn_apply` of a training step on a mesh, ``residual`` added
    after ``wo``: causal (a decoder's), or with ``causal=False`` an
    encoder's non-causal self-attention, or with ``kv`` (B, S_src, d),
    the encoder's output whole on every rank, a decoder's cross
    attention (keys and values from ``kv``, no mask and no RoPE:
    :func:`cross_attn_apply`).  ``seq``: the residual's positions lie
    over that axis (``sharding.residual_axis``: S divides M), and ``x``,
    ``residual`` and the output are this rank's block [r·S/M,
    (r+1)·S/M) of them; ``positions`` are whole.

    Where the query heads split over ``axis`` (:func:`heads_split`, M
    ranks, r this one's coordinate), this rank runs heads [r·H/M,
    (r+1)·H/M): wq's block is its heads' rows, ``x`` enters whole (the
    block gathered, ``common.seq_gather``, whose backward
    reduce-scatters; a whole ``x`` through ``ad_identity``), and so does
    ``kv`` (through ``ad_identity``), the kv heads those heads read come
    from wk/wv's block, or from the whole weights (gathered over
    ``axis`` when their rows split finer than a head), the qk-norm
    scales (over ``head_dim``, so local) through ``ad_identity``, and
    ``wo``'s block ends in a reduce-scatter over the positions (a psum
    where the residual is whole).

    Otherwise, with the residual split, the query positions split as it
    does (the reference's 'seq' rule): the weights are gathered whole,
    each leaf's gradient summed over the ranks (their consumers see this
    rank's positions only), ``kv`` and the norm scales enter through
    ``ad_identity``; the block runs the projections, RoPE at its true
    positions; K and V are computed on the block (of ``kv``'s positions
    too, where they divide M; else on all of them) and gathered
    (``ad_all_gather``, whose backward reduce-scatters); the block's
    queries attend over every key at their true offset, and ``wo`` and
    the residual act on the block.  Otherwise each rank runs every head,
    on weights gathered whole."""
    mesh = sharding.active_mesh()
    M = compat.axes_of(mesh).get(axis, 1)
    h, hk, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    tp = heads_split(cfg, M)
    # qk-norm on self-attention only, as attn_apply / cross_attn_apply
    norms = (p.q_norm.scale, p.k_norm.scale) \
        if cfg.qk_norm and kv is None else None
    if tp:
        r = sharding.coord(mesh, axis)
        hl = h // M
        kv0, kv1 = _kv_span(cfg, M, r)
        wq, wo = p.wq.w, p.wo.w  # this rank's heads' rows and columns
        if wq.shape[0] != hl * dh or wo.shape[1] != hl * dh:
            raise NotImplementedError(
                f"{cfg.name}: wq {tuple(wq.shape)} / wo {tuple(wo.shape)} "
                f"are not split over {axis!r} as the heads are (rules "
                f"{sharding.active_rules()!r})")
        wk = _kv_rows(p.wk.w, cfg, M, kv0, kv1, axis)
        wv = _kv_rows(p.wv.w, cfg, M, kv0, kv1, axis)
        x = common.seq_gather(x, seq, partial=True) if seq is not None \
            else coll.ad_identity(x, axis)
    else:
        hl = h
        part = seq is not None

        def whole(w, rows, dim):
            return common.whole_rows(w, rows, dim, axis, partial=part)

        wq, wk = whole(p.wq.w, h * dh, 0), whole(p.wk.w, hk * dh, 0)
        wv, wo = whole(p.wv.w, hk * dh, 0), whole(p.wo.w, h * dh, 1)
    if tp or seq is not None:
        if kv is not None:
            kv = coll.ad_identity(kv, axis)
        if norms is not None:
            norms = tuple(coll.ad_identity(n, axis) for n in norms)
    B, n, _ = x.shape
    src = x if kv is None else kv
    lo, kv_seq = 0, False
    if seq is not None and not tp:
        lo, n = sharding.seq_block(positions.shape[1] if positions
                                   is not None else n * M, seq, mesh)
        if positions is not None:
            positions = positions.narrow(1, lo, n)
        kv_seq = kv is None or src.shape[1] % M == 0
        if kv is not None and kv_seq:
            src = src.narrow(1, *sharding.seq_block(src.shape[1], seq,
                                                     mesh))
    q = common.local_linear(wq, x, tag="wq").reshape(B, n, hl, dh)
    k = common.local_linear(wk, src, tag="wk").reshape(
        B, src.shape[1], -1, dh)
    v = common.local_linear(wv, src, tag="wv").reshape(
        B, src.shape[1], -1, dh)
    if norms is not None:
        q = common.norm_apply(common.Norm(norms[0]), q, "rmsnorm")
        k = common.norm_apply(common.Norm(norms[1]), k, "rmsnorm")
    if kv is None and cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    if kv_seq:
        k = coll.ad_all_gather(k, axis, dim=1, kind=SEQ_KV)
        v = coll.ad_all_gather(v, axis, dim=1, kind=SEQ_KV)
    if kv is not None:  # cross attention: every source position
        out = _sdpa(cfg, q, k, v, None)
    else:
        out = _attend(cfg, q, k, v, causal=causal, window=window,
                      offset=lo)
    y = common.local_linear(wo, out, tag="wo")
    if tp:
        y = common.seq_scatter(y, seq, partial=True) if seq is not None \
            else coll.ad_psum(y, axis)
    return common.add_residual(y, residual)


def _kv_span(cfg, M: int, r: int) -> tuple[int, int] | None:
    """(first, last + 1) of the kv heads that rank ``r``'s H/M query
    heads read; None where those heads do not group evenly over them."""
    h, hk = cfg.num_heads, cfg.num_kv_heads
    hl, g = h // M, h // hk
    q0 = r * hl
    kv0, kv1 = q0 // g, (q0 + hl - 1) // g + 1
    if hl % (kv1 - kv0) or any((q0 + i) // g - kv0 != i // (hl // (
            kv1 - kv0)) for i in range(hl)):
        return None
    return kv0, kv1


def heads_split(cfg, M: int) -> bool:
    """Whether a training step on a mesh of ``M`` ranks over 'model'
    splits the query heads: they divide M and each rank's group evenly
    over the kv heads they read (:func:`_kv_span`).  Otherwise the query
    positions split where they divide M (:func:`attn_apply_tp`)."""
    return M > 1 and cfg.num_heads % M == 0 and all(
        _kv_span(cfg, M, r) is not None for r in range(M))
