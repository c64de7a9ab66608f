"""Mamba-1 (S6 selective scan) block — jamba's sequence mixer; port of
repro.models.mamba.

Prefill runs the scan chunk by chunk, carrying the (B, d_inner, N) state
from one chunk to the next; inside a chunk a Hillis–Steele doubling scan
(log2(chunk) steps of the reference's ``(a, b)`` combine) gives every
position's state at once.  A ragged last chunk is simply shorter, where
the reference pads it with ``dA = 1`` and ``dBu = 0``, which leaves the
state as it is: both give the same state.  A training forward scans all
chunks at once, and their ends alike (:func:`_scan_chunked`).
Single-token decode is the same code at L = 1, one recurrence step ``h =
dBu + dA * h``, with the SSM state and the conv tail as the cache
(linear in the sequence length).

``in_proj``, ``x_proj`` and ``out_proj`` go through
``common.linear_apply``, so through the weight kernels; ``dt_proj`` and
the scan are plain f32 PyTorch, as the reference computes them outside
any Pallas kernel.

On a mesh whose 'model' axis divides d_inner (:func:`tensor_parallel`,
recorded as ``Mamba.tp``) each rank runs its block of the channels
(``mamba_inner``):
``in_proj`` is column-parallel, its rows cut so that this rank's block
holds its channels of both halves (``runtime.serve.shard_params``), the
conv, ``dt_proj``, the scan, ``D`` and the state are this rank's
channels, ``x_proj`` contracts over them (its dt/B/C partials summed in
f32) and ``out_proj`` is row-parallel.  Otherwise every rank runs the
block whole.  A training step on a mesh runs the same layout
(:func:`mamba_apply_tp`) on the leaves ``sharding.shard_model`` cut.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.distributed import collectives as coll
from repro_torch.distributed import sharding
from repro_torch.models import common


class Mamba(common.Tree):
    """in_proj, conv_w (K, di), conv_b, x_proj, dt_proj {w (di, dt_rank),
    b}, A_log (di, N), D, out_proj: the reference's ``mamba_init`` tree.
    ``tp``: ``runtime.serve.shard_params`` cut this rank's channels
    (:func:`tensor_parallel`)."""

    tp = False


def mamba_init(cfg, *, generator: torch.Generator, device=None) -> Mamba:
    d, di, n, dr = cfg.d_model, cfg.mamba_d_inner, cfg.mamba_d_state, \
        cfg.dt_rank
    kw = dict(generator=generator, device=device)
    in_proj = common.linear_init(d, 2 * di, cfg, cfg.quant, **kw)
    conv_w = common.truncated_normal((cfg.mamba_d_conv, di),
                                     cfg.mamba_d_conv**-0.5, **kw)
    x_proj = common.linear_init(di, dr + 2 * n, cfg, cfg.quant, **kw)
    dt_w = common.truncated_normal((di, dr), dr**-0.5, **kw)
    lo, hi = math.log(1e-3), math.log(1e-1)
    dt = torch.exp(torch.rand((di,), **kw) * (hi - lo) + lo)
    dt_b = torch.log(torch.expm1(dt))  # softplus^-1 of dt_init
    A_log = torch.log(torch.arange(1, n + 1, dtype=torch.float32,
                                   device=device)).repeat(di, 1)
    out_proj = common.linear_init(di, d, cfg, cfg.quant, **kw)
    return Mamba(in_proj=in_proj, conv_w=conv_w,
                 conv_b=torch.zeros(di, device=device), x_proj=x_proj,
                 dt_proj=common.Tree(w=dt_w, b=dt_b), A_log=A_log,
                 D=torch.ones(di, device=device), out_proj=out_proj)


def _causal_conv(x, w, b, tail=None):
    """Depthwise causal conv.  x (B, L, di), w (K, di) f32; tail (B, K-1,
    di).  Returns (f32 out, the new tail in the dtype of x and tail)."""
    K = w.shape[0]
    pad = tail if tail is not None else x.new_zeros(
        (x.shape[0], K - 1, x.shape[2]))
    xp = torch.cat([pad, x], dim=1)  # (B, L+K-1, di)
    out = sum(xp[:, i:i + x.shape[1], :] * w[i] for i in range(K))
    new_tail = xp[:, xp.shape[1] - (K - 1):, :]
    return out + b, new_tail


def tensor_parallel(cfg, mesh) -> bool:
    """Whether the ranks of 'model' on ``mesh`` split the block's
    channels."""
    M = sharding.tp_size(mesh)
    return M > 1 and cfg.mamba_d_inner % M == 0


def _doubling(a, b, dim: int):
    """Hillis–Steele inclusive scan along ``dim`` of the pairs (a, b)
    under the reference's combine(l, r) = (al·ar, bl·ar + br):
    log2(n) steps, each over every position at once."""
    n, step = a.shape[dim], 1
    while step < n:
        lo, hi = step, n - step
        b = torch.cat([b.narrow(dim, 0, lo), b.narrow(dim, 0, hi)
                       * a.narrow(dim, lo, hi) + b.narrow(dim, lo, hi)],
                      dim=dim)
        a = torch.cat([a.narrow(dim, 0, lo), a.narrow(dim, 0, hi)
                       * a.narrow(dim, lo, hi)], dim=dim)
        step *= 2
    return a, b


def _scan_chunked(dA, dBu, C, h0, chunk: int):
    """h_t = dA_t * h_{t-1} + dBu_t ; y_t = <C_t, h_t>.

    dA/dBu (B, L, di, N), C (B, L, N), h0 (B, di, N).  Returns (y (B, L,
    di), h_L).  Each chunk of ``chunk`` positions is scanned by
    :func:`_doubling`.  Without a backward pass to come the chunks run
    one after the other, the state carried between them (memory bounded
    by a chunk; a ragged last chunk is simply shorter, where the
    reference pads it with dA = 1 and dBu = 0, which leaves the state as
    it is).  With one, the autograd graph keeps every chunk's steps
    anyway, so all chunks are scanned at once (the ragged one padded as
    the reference pads it) and the chunks' ends, scanned alike, give
    each chunk's incoming state: the number of steps does not grow with
    L, and the sums differ from the chunk-by-chunk ones in rounding
    only."""
    if common.needs_grad(dA, dBu, C, h0):
        return _scan_all(dA, dBu, C, h0, chunk)
    L = dA.shape[1]
    h, ys = h0, []
    for s in range(0, L, chunk):
        a, b = _doubling(dA[:, s:s + chunk], dBu[:, s:s + chunk], 1)
        h_all = b + a * h[:, None]  # (B, W, di, N)
        ys.append(torch.einsum("bldn,bln->bld", h_all, C[:, s:s + chunk]))
        h = h_all[:, -1]
    return torch.cat(ys, dim=1), h


def _scan_all(dA, dBu, C, h0, chunk: int):
    """:func:`_scan_chunked` with every chunk scanned at once."""
    B, L, di, N = dA.shape
    W = min(chunk, L)
    nc = -(-L // W)
    pad = nc * W - L
    if pad:
        dA = torch.cat([dA, dA.new_ones((B, pad, di, N))], dim=1)
        dBu = torch.cat([dBu, dBu.new_zeros((B, pad, di, N))], dim=1)
        C = torch.cat([C, C.new_zeros((B, pad, N))], dim=1)
    a, b = _doubling(dA.reshape(B, nc, W, di, N),
                     dBu.reshape(B, nc, W, di, N), 2)
    ends_a, ends_b = _doubling(a[:, :, -1], b[:, :, -1], 1)
    h_in = torch.cat([h0[:, None], (ends_b + ends_a * h0[:, None])[:, :-1]],
                     dim=1)  # (B, nc, di, N): each chunk's incoming state
    h_all = (b + a * h_in[:, :, None]).reshape(B, nc * W, di, N)
    y = torch.einsum("bldn,bln->bld", h_all, C)
    return y[:, :L], h_all[:, L - 1]


def _mix(p: Mamba, cfg, xz, x_proj, dtype, state=None):
    """The block between its input and output projections: ``xz`` (B, L,
    2·di: this rank's channels of x, then of z) -> (y (B, L, di) in
    ``dtype``, the state after it): the causal conv, ``x_proj`` (a map
    of the conv's output to f32 (B, L, dt_rank + 2N): dt's rank, B and
    C), ``dt_proj``, the scan from ``state`` (or zeros), ``D`` and the
    gate by z."""
    di = xz.shape[-1] // 2
    xs, z = torch.split(xz, di, dim=-1)
    tail = state["conv"] if state is not None else None
    xc, new_tail = _causal_conv(xs, p.conv_w, p.conv_b, tail)
    xc = F.silu(xc)
    n, dr = cfg.mamba_d_state, cfg.dt_rank
    dtr, Bm, Cm = torch.split(x_proj(xc), [dr, n, n], dim=-1)
    dt = torch.logaddexp(dtr @ p.dt_proj.w.t() + p.dt_proj.b,
                         torch.zeros((), device=xc.device))  # softplus
    A = -torch.exp(p.A_log)  # (di, N)
    xf = xc.to(torch.float32)
    dA = torch.exp(dt[..., None] * A)  # (B, L, di, N)
    dBu = (dt * xf)[..., None] * Bm[:, :, None, :]
    h0 = (state["ssm"] if state is not None else
          xz.new_zeros((xz.shape[0], di, n), dtype=torch.float32))
    y, h_last = _scan_chunked(dA, dBu, Cm, h0, cfg.mamba_chunk)
    y = y + p.D * xf
    y = (y * F.silu(z.to(torch.float32))).to(dtype)
    return y, {"ssm": h_last, "conv": new_tail}


def mamba_apply(p: Mamba, cfg, x, *, state=None, seq: str | None = None):
    """Full-sequence pass, or one decode step at L = 1 with ``state``.
    x (B, L, d) -> (y (B, L, d), {"ssm", "conv"}: the state after x).
    ``seq``: ``x`` and ``y`` are this rank's block of the positions over
    that axis; the scan needs the whole sequence, so the block is
    gathered and ``out_proj``'s partial sums reduce-scattered over the
    positions."""
    axis = sharding.TP_AXIS if p.tp else None
    x = common.seq_gather(x, seq)
    xz = common.linear_apply(p.in_proj, x, cfg.quant, in_dim=cfg.d_model,
                             tag="in_proj", local=p.tp)

    def x_proj(xc):  # its dt/B/C partials summed in f32 on a mesh
        return common.linear_apply(
            p.x_proj, xc, cfg.quant, in_dim=cfg.mamba_d_inner,
            tag="x_proj", x_axis=axis).to(torch.float32)

    y, state = _mix(p, cfg, xz, x_proj, x.dtype, state)
    out = common.linear_apply(
        p.out_proj, y, cfg.quant, in_dim=cfg.mamba_d_inner, tag="out_proj",
        x_axis=axis, seq=seq)
    return out, state


def mamba_apply_tp(p: Mamba, cfg, x, *, axis: str = "model",
                   seq: str | None = None):
    """:func:`mamba_apply` (full sequence, no state) of a training step
    on a mesh, on this rank's weights gathered over 'data' (a model cut
    by ``sharding.shard_model``).  Where its leaves hold this rank's
    channels (``mamba_inner`` split over ``axis``; ``in_proj``'s rows its
    channels of both halves, ``sharding.HALVES``): ``x`` enters through
    ``ad_identity``, ``in_proj`` and ``dt_proj`` are column-parallel,
    the conv, the scan, ``A_log`` and ``D`` local to the channels,
    ``x_proj``'s partial dt/B/C are summed over ``axis`` in f32 by an
    ``ad_psum`` whose backward sums the ranks' cotangents too (each
    rank's channels use all of dt's rank, B and C), and ``out_proj`` is
    row-parallel, ending in ``ad_psum``.  Otherwise every rank runs the
    block whole.  ``seq``: ``x`` and y are this rank's block of the
    positions over that axis: the block is gathered whole at entry
    (``common.seq_gather``, in place of ``ad_identity``) and
    ``out_proj``'s partials are reduce-scattered over the positions (a
    whole block's output cut to this rank's positions).  Returns y (B,
    L, d)."""
    tp = p.in_proj.w.shape[0] != 2 * cfg.mamba_d_inner
    if seq is not None:
        x = common.seq_gather(x, seq, partial=tp)
    elif tp:
        x = coll.ad_identity(x, axis)
    xz = common.local_linear(p.in_proj.w, x, tag="in_proj")

    def x_proj(xc):
        proj = common.local_linear(p.x_proj.w, xc, tag="x_proj").to(
            torch.float32)
        return coll.ad_psum(proj, axis, partial=True) if tp else proj

    y, _ = _mix(p, cfg, xz, x_proj, x.dtype)
    out = common.local_linear(p.out_proj.w, y, tag="out_proj")
    if seq is not None:
        return common.seq_scatter(out, seq, partial=tp)
    return coll.ad_psum(out, axis) if tp else out


def init_state(cfg, batch: int, dtype=torch.float32, *, device=None
               ) -> dict:
    """The zero state: ``ssm`` (batch, di, N) f32, ``conv`` (batch, K-1,
    di) in ``dtype`` (the activations')."""
    di = cfg.mamba_d_inner
    return {"ssm": torch.zeros((batch, di, cfg.mamba_d_state),
                               device=device),
            "conv": torch.zeros((batch, cfg.mamba_d_conv - 1, di),
                                dtype=dtype, device=device)}
