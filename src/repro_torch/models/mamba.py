"""Mamba-1 (S6 selective scan) block — jamba's sequence mixer; port of
repro.models.mamba.

Prefill runs the scan chunk by chunk, carrying the (B, d_inner, N) state
from one chunk to the next; inside a chunk a Hillis–Steele doubling scan
(log2(chunk) steps of the reference's ``(a, b)`` combine) gives every
position's state at once.  A ragged last chunk is simply shorter, where
the reference pads it with ``dA = 1`` and ``dBu = 0``, which leaves the
state as it is: both give the same state.  Single-token decode is the
same code at L = 1, one recurrence step ``h = dBu + dA * h``, with the
SSM state and the conv tail as the cache (linear in the sequence length).

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
block whole.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

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


def _ssm_params(p: Mamba, cfg, xc, tp: bool = False):
    """xc (B, L, di) -> dt (B, L, di), B/C (B, L, N), all f32 (di: this
    rank's channels with ``tp``)."""
    n, dr = cfg.mamba_d_state, cfg.dt_rank
    proj = common.linear_apply(
        p.x_proj, xc, cfg.quant, in_dim=cfg.mamba_d_inner, tag="x_proj",
        x_axis=sharding.TP_AXIS if tp else None)
    dtr, Bm, Cm = torch.split(proj.to(torch.float32), [dr, n, n], dim=-1)
    dt = torch.logaddexp(dtr @ p.dt_proj.w.t() + p.dt_proj.b,
                         torch.zeros((), device=xc.device))  # softplus
    return dt, Bm, Cm


def _scan_chunked(dA, dBu, C, h0, chunk: int):
    """h_t = dA_t * h_{t-1} + dBu_t ; y_t = <C_t, h_t>.

    dA/dBu (B, L, di, N), C (B, L, N), h0 (B, di, N).  Returns (y (B, L,
    di), h_L)."""
    L = dA.shape[1]
    h, ys = h0, []
    for s in range(0, L, chunk):
        a, b = dA[:, s:s + chunk], dBu[:, s:s + chunk]
        step = 1
        while step < a.shape[1]:  # combine(l, r) = (al*ar, bl*ar + br)
            b = torch.cat([b[:, :step], b[:, :-step] * a[:, step:]
                           + b[:, step:]], dim=1)
            a = torch.cat([a[:, :step], a[:, :-step] * a[:, step:]], dim=1)
            step *= 2
        h_all = b + a * h[:, None]  # (B, W, di, N)
        ys.append(torch.einsum("bldn,bln->bld", h_all, C[:, s:s + chunk]))
        h = h_all[:, -1]
    return torch.cat(ys, dim=1), h


def mamba_apply(p: Mamba, cfg, x, *, state=None):
    """Full-sequence pass, or one decode step at L = 1 with ``state``.
    x (B, L, d) -> (y (B, L, d), {"ssm", "conv"}: the state after x)."""
    tp = p.tp
    xz = common.linear_apply(p.in_proj, x, cfg.quant, in_dim=cfg.d_model,
                             tag="in_proj", local=tp)
    di = xz.shape[-1] // 2  # this rank's channels
    xs, z = torch.split(xz, di, dim=-1)
    tail = state["conv"] if state is not None else None
    xc, new_tail = _causal_conv(xs, p.conv_w, p.conv_b, tail)
    xc = F.silu(xc)
    dt, Bm, Cm = _ssm_params(p, cfg, xc, tp)
    A = -torch.exp(p.A_log)  # (di, N)
    xf = xc.to(torch.float32)
    dA = torch.exp(dt[..., None] * A)  # (B, L, di, N)
    dBu = (dt * xf)[..., None] * Bm[:, :, None, :]
    h0 = (state["ssm"] if state is not None else
          x.new_zeros((x.shape[0], di, cfg.mamba_d_state),
                      dtype=torch.float32))
    y, h_last = _scan_chunked(dA, dBu, Cm, h0, cfg.mamba_chunk)
    y = y + p.D * xf
    y = (y * F.silu(z.to(torch.float32))).to(x.dtype)
    out = common.linear_apply(
        p.out_proj, y, cfg.quant, in_dim=cfg.mamba_d_inner, tag="out_proj",
        x_axis=sharding.TP_AXIS if tp else None)
    return out, {"ssm": h_last, "conv": new_tail}


def init_state(cfg, batch: int, dtype=torch.float32, *, device=None
               ) -> dict:
    """The zero state: ``ssm`` (batch, di, N) f32, ``conv`` (batch, K-1,
    di) in ``dtype`` (the activations')."""
    di = cfg.mamba_d_inner
    return {"ssm": torch.zeros((batch, di, cfg.mamba_d_state),
                               device=device),
            "conv": torch.zeros((batch, cfg.mamba_d_conv - 1, di),
                                dtype=dtype, device=device)}
