"""xLSTM blocks (arXiv:2405.04517): mLSTM (matrix memory, per-head C in
R^{dh x dh}) and sLSTM (scalar memory with recurrent memory mixing), both
with exponential gating and a max-stabilizer state m; port of
repro.models.xlstm.

The mLSTM has two exact forms: the sequential recurrence (decode, one
step a token) and the chunkwise-parallel one (prefill), attention-like
inside a chunk of ``xlstm_chunk`` positions with the state carried from
chunk to chunk.  The sLSTM is sequential.  Every recurrence here runs
over the true sequence length: the reference pads the time axis to a
multiple of ``xlstm_chunk`` when L > xlstm_chunk, which is exact for the
mLSTM (a zero step rescales C, n and m alike) but not for the sLSTM,
whose recurrent mixing ``h @ R.T`` moves the state on every padded step;
so the reference's sLSTM hands decode a wrong state after such a prompt,
and the port's does not (ROADMAP C).

``xl_up``, ``xl_o``, ``xl_down`` and the sLSTM's GeGLU MLP go through the
weight kernels; the block-diagonal q/k/v, the scalar gates and the
sLSTM's W and R stay plain f32 products, as in the reference.

On a mesh whose 'model' axis divides the mLSTM's heads
(:func:`mlstm_tensor_parallel`, recorded as ``MLSTM.tp``) each rank runs
its heads (``xl_inner``):
``xl_up`` and ``xl_o`` column-parallel (``xl_up``'s rows cut so that
this rank's block holds its channels of both halves,
``runtime.serve.shard_params``), the conv, the block-diagonal q/k/v, the
cell and its state (C, n, m) on its heads, the gates' contraction over
the channels summed over the ranks (f32), ``xl_down`` row-parallel.
Otherwise every rank runs the mLSTM whole.  The sLSTM's W and R ('embed'
axes) stay whole under the serve rules; its MLP runs tensor-parallel as
any MLP does.

A training step on a mesh runs the same layouts
(:func:`mlstm_block_apply_tp`, :func:`slstm_block_apply_tp`) on the
leaves ``sharding.shard_model`` cut.

On fake tensors (the dry run) the sLSTM's step loop and the mLSTM's
chunk loop run through twins that allocate what the loops hold and
compute nothing (:class:`_SLSTMFake`, :class:`_MLSTMChunkFake`), so
xlstm's cells at 4,096 and 32,768 positions finish in minutes.
"""

from __future__ import annotations

import threading
import weakref

import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.device import is_fake
from repro_torch.distributed import collectives as coll
from repro_torch.distributed import sharding
from repro_torch.models import common
from repro_torch.models.mamba import _causal_conv  # the shared depthwise conv


def _dims(cfg):
    """(di, H, dh) of the mLSTM: dh is ``di // H``, not ``cfg.head_dim``."""
    di = int(cfg.d_model * cfg.xlstm_proj_factor)
    return di, cfg.num_heads, di // cfg.num_heads


def mlstm_tensor_parallel(cfg, mesh) -> bool:
    """Whether the ranks of 'model' on ``mesh`` split the mLSTM's
    heads."""
    M = sharding.tp_size(mesh)
    return M > 1 and cfg.num_heads % M == 0


# =========================================================== mLSTM block
class MLSTM(common.Tree):
    """norm, xl_up, xl_conv_w (K, di), xl_conv_b, xl_q/xl_k/xl_v {w (H, dh,
    dh)}, xl_gates {w (2H, di), b}, xl_o, xl_down, lskip: the reference's
    ``mlstm_init`` tree.  ``tp``: ``runtime.serve.shard_params`` cut this
    rank's heads (:func:`mlstm_tensor_parallel`)."""

    tp = False


def mlstm_init(cfg, *, generator: torch.Generator, device=None) -> MLSTM:
    d = cfg.d_model
    di, H, dh = _dims(cfg)
    kw = dict(generator=generator, device=device)
    lin = lambda i, o: common.linear_init(i, o, cfg, cfg.quant, **kw)  # noqa: E731
    bd = lambda: common.Tree(w=common.truncated_normal(  # noqa: E731
        (H, dh, dh), dh**-0.5, **kw))
    xl_up = lin(d, 2 * di)
    conv_w = common.truncated_normal((cfg.xlstm_conv, di),
                                     cfg.xlstm_conv**-0.5, **kw)
    q, k, v = bd(), bd(), bd()
    gates = common.Tree(
        w=common.truncated_normal((2 * H, di), di**-0.5, **kw),
        b=torch.cat([torch.zeros(H, device=device),
                     3.0 * torch.ones(H, device=device)]))  # f bias 3
    return MLSTM(norm=common.norm_init(d, cfg.norm, device=device),
                 xl_up=xl_up, xl_conv_w=conv_w,
                 xl_conv_b=torch.zeros(di, device=device),
                 xl_q=q, xl_k=k, xl_v=v, xl_gates=gates, xl_o=lin(d, di),
                 xl_down=lin(di, d), lskip=torch.ones(di, device=device))


def _blockdiag(w, x, B, L, H, dh):
    """x (B, L, di) -> per-head block-diagonal projection (B, L, H, dh);
    w (H, out, in)."""
    xh = x.reshape(B, L, H, dh).to(torch.float32)
    return torch.einsum("blhd,hed->blhe", xh, w)


def _mlstm_step(state, inp):
    """Stabilized mLSTM recurrence (paper eqs. 19-27).

    state: C (B,H,dh,dh), n (B,H,dh), m (B,H)
    inp:   q,k,v (B,H,dh); i~, f~ (B,H)
    """
    C, n, m = state
    q, k, v, it, ft = inp
    m_new = torch.maximum(ft + m, it)
    i_p = torch.exp(it - m_new)[..., None]
    f_p = torch.exp(ft + m - m_new)[..., None]
    C = f_p[..., None] * C + i_p[..., None] * (v[..., :, None]
                                               * k[..., None, :])
    n = f_p * n + i_p * k
    num = torch.einsum("bhij,bhj->bhi", C, q)
    # C/n are exp(-m)-stabilized, so the paper's max(|n.q|, 1) floor is
    # exp(-m) in stabilized units
    den = torch.maximum(torch.einsum("bhj,bhj->bh", n, q).abs(),
                        torch.exp(-m_new))
    return (C, n, m_new), num / den[..., None]


def _scan(step, state, xs, chunk: int):
    """``common.chunked_scan`` over the true length T of ``xs``: the whole
    chunks, then the ragged rest (no padding)."""
    T = xs[0].shape[0]
    head = T - T % chunk if T > chunk else T
    state, ys = common.chunked_scan(step, state, tuple(x[:head] for x in xs),
                                    chunk=chunk)
    if head < T:
        state, rest = common.chunked_scan(
            step, state, tuple(x[head:] for x in xs), chunk=chunk)
        ys = torch.cat([ys, rest])
    return state, ys


def mlstm_sequence(q, k, v, it, ft, state, *, chunk: int = 128):
    """The sequential form.  q/k/v (B, L, H, dh); it/ft (B, L, H).
    Returns (h (B, L, H, dh), state)."""
    xs = tuple(t.movedim(1, 0) for t in (q, k, v, it, ft))
    state, hs = _scan(_mlstm_step, state, xs, chunk)
    return hs.movedim(0, 1), state


def _mlstm_chunk_parallel(state, inp):
    """One chunk of the parallel (attention-like) stabilized mLSTM.

    state: C (B,H,dh,dh), n (B,H,dh), m (B,H) — absolute stabilizer.
    inp:   q,k,v (B,W,H,dh); it,ft (B,W,H)  (ft already log-sigmoid).

    Within the chunk, position t sees
        h_t = [ exp(m0-a_t)·q_t C0  +  Σ_{s<=t} exp(g_s-a_t)(q_t·k_s) v_s ]
              / max(|den_t|, exp(-m_t))
    with b_t = Σ_{s<=t} f̃_s,  g_s = ĩ_s - b_s,
    a_t = max(m0, cummax g),  m_t = b_t + a_t: the sequential recurrence
    rearranged.  m0 = -inf (the initial state) gives exp(m0 - a_t) = 0,
    never NaN: a_t is finite.
    """
    C0, n0, m0 = state
    q, k, v, it, ft = inp
    W = q.shape[1]
    b = torch.cumsum(ft, dim=1)  # (B, W, H)
    g = it - b
    a = torch.maximum(m0[:, None], torch.cummax(g, dim=1).values)
    m = b + a

    # intra-chunk: D[t, s] = exp(g_s - a_t), s <= t
    decay = torch.exp(g[:, None, :, :] - a[:, :, None, :])  # (B, t, s, H)
    mask = torch.ones((W, W), dtype=torch.bool, device=q.device).tril()
    decay = torch.where(mask[None, :, :, None], decay, 0.0)
    w_ts = torch.einsum("bthd,bshd->btsh", q, k) * decay
    num = torch.einsum("btsh,bshd->bthd", w_ts, v)
    den = w_ts.sum(dim=2)  # (B, t, H)

    # inter-chunk: carried memory, decayed to position t.  C[i, j] = v_i k_j,
    # retrieval contracts the k index: (C0 q)_i = sum_j C0[i, j] q_j.
    scale0 = torch.exp(m0[:, None] - a)  # (B, W, H)
    num = num + torch.einsum("bthd,bhed->bthe", q, C0) * scale0[..., None]
    den = den + torch.einsum("bthd,bhd->bth", q, n0) * scale0

    h = num / torch.maximum(den.abs(), torch.exp(-m))[..., None]

    # carry to the next chunk (position W)
    aW, bW = a[:, -1], b[:, -1]  # (B, H)
    wk = torch.exp(g - aW[:, None])  # (B, W, H)
    carry = torch.exp(m0 - aW)
    C = (torch.einsum("bshd,bshe,bsh->bhde", v, k, wk)
         + carry[..., None, None] * C0)
    n = torch.einsum("bshd,bsh->bhd", k, wk) + carry[..., None] * n0
    return (C, n, bW + aW), h


def mlstm_sequence_parallel(q, k, v, it, ft, state, *, chunk: int = 128):
    """The chunkwise-parallel form, chunks of ``chunk`` positions (the last
    one ragged), the state carried between them; equal to
    :func:`mlstm_sequence`.  With a backward pass to come, each chunk is
    rematerialized (``common.remat``)."""
    grad = common.needs_grad(state, q, k, v, it, ft)
    one = _mlstm_chunk_fake if is_fake(q) else _mlstm_chunk_parallel
    hs = []
    for s in range(0, q.shape[1], chunk):
        inp = tuple(t[:, s:s + chunk] for t in (q, k, v, it, ft))
        # each chunk rematerialized for the backward pass, as the
        # reference's jax.checkpoint of the chunk function
        state, h = (common.remat(one, state, inp) if grad
                    else one(state, inp))
        hs.append(h)
    return torch.cat(hs, dim=1), state


# ------------------------------------- fake-tensor twins (the dry run)
class _Allocations(TorchDispatchMode):
    """The bytes of the storages that the ops run under it create: live
    (a storage counts until it is freed) and at their peak since
    :meth:`reset`."""

    def __init__(self):
        super().__init__()
        self.live = self.peak = 0
        self._seen: set = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_flatten(out)[0]:
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            if st._cdata in self._seen:
                continue
            self._seen.add(st._cdata)
            self.live += st.nbytes()
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, st._cdata, st.nbytes())
        return out

    def _free(self, key, n):
        self.live -= n
        self._seen.discard(key)

    def reset(self) -> int:
        self.peak = self.live
        return self.live


_CHUNK_COST: dict = {}


def _measure_chunk(key: tuple, out: dict) -> None:
    """One rematerialized :func:`_mlstm_chunk_parallel` on fake tensors of
    ``key``'s shapes and dtypes, forward and backward, its inputs
    counted before either: out["cost"] = (the forward's peak bytes above
    its start, the backward's, its recompute included).  The sequence's
    inputs and the outputs' cotangents are slices of a longer sequence,
    as a chunk of :func:`mlstm_sequence_parallel` sees them."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    def chunk_of(shape, dt):  # a chunk-long slice of two chunks' positions
        return torch.empty((shape[0], 2 * shape[1], *shape[2:]),
                           dtype=dt)[:, :shape[1]]

    try:
        with FakeTensorMode():
            args = [torch.empty(shape, dtype=dt) if i < 3 else
                    chunk_of(shape, dt) for i, (shape, dt) in enumerate(key)]
            args = [a.requires_grad_() for a in args]
            track = _Allocations()
            with track:
                args = [a.view_as(a) for a in args]
                base = track.reset()
                st, h = common.remat(_mlstm_chunk_parallel, tuple(args[:3]),
                                     tuple(args[3:]))
                fwd = track.peak - base
                outs = (*st, h)
                cts = [torch.ones_like(t) for t in st] + [chunk_of(
                    h.shape, h.dtype)]
                base = track.reset()
                torch.autograd.grad(outs, args, cts)
                out["cost"] = (fwd, track.peak - base)
    except Exception as e:  # raised in the caller's thread
        out["error"] = e


def _chunk_cost(key: tuple) -> tuple[int, int]:
    """:func:`_measure_chunk`'s cost of a chunk of ``key``'s shapes,
    measured once a shape in a thread of its own, so that none of the
    caller's dispatch modes (its fake mode, ``MemTracker``) or saved-
    tensor hooks (remat's) sees it."""
    if key not in _CHUNK_COST:
        out: dict = {}
        worker = threading.Thread(target=_measure_chunk, args=(key, out))
        worker.start()
        worker.join()
        if "error" in out:
            raise out["error"]
        _CHUNK_COST[key] = out["cost"]
    return _CHUNK_COST[key]


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


class _MLSTMChunkFake(torch.autograd.Function):
    """:func:`_mlstm_chunk_parallel` over fake tensors (the dry run),
    where its some forty ops a chunk, over every chunk of every layer and
    pass, would take the cell past ten minutes: it allocates the chunk's
    outputs and, in one piece each, the rest of the forward's peak and
    of the backward's (its recompute included), as measured for these
    shapes by :func:`_chunk_cost`; nothing is computed.  It saves an
    input, as the chunk's ops do, so that remat keeps the chunk's inputs
    (the carried state) for its recompute, and reads it back in the
    backward, which runs the recompute."""

    @staticmethod
    def forward(ctx, fwd, bwd, C0, n0, m0, q, k, v, it, ft):
        outs = (C0.new_empty(C0.shape), n0.new_empty(n0.shape),
                m0.new_empty(m0.shape), q.new_empty(q.shape))
        work = q.new_empty((max(fwd - _nbytes(*outs), 0),),
                           dtype=torch.uint8)
        del work
        ctx.save_for_backward(q)
        ctx.cost = bwd - _nbytes(*outs)  # the recompute holds its outputs
        ctx.ins = [(t.shape, t.dtype) for t in (C0, n0, m0, q, k, v, it, ft)]
        return outs

    @staticmethod
    def backward(ctx, *cts):
        (like,) = ctx.saved_tensors
        grads = [like.new_empty(shape, dtype=dt) if need else None
                 for (shape, dt), need in zip(ctx.ins,
                                              ctx.needs_input_grad[2:])]
        every = sum(torch.Size(shape).numel() * dt.itemsize
                    for shape, dt in ctx.ins)
        work = like.new_empty((max(ctx.cost - every, 0),), dtype=torch.uint8)
        del work
        return (None, None, *grads)


def _mlstm_chunk_fake(state, inp):
    """:func:`_mlstm_chunk_parallel`'s allocations alone
    (:class:`_MLSTMChunkFake`)."""
    key = tuple((tuple(t.shape), t.dtype) for t in (*state, *inp))
    C, n, m, h = _MLSTMChunkFake.apply(*_chunk_cost(key), *state, *inp)
    return (C, n, m), h


def _mix(cfg, ab, w: dict, gates_of, o, dtype, state=None, h0: int = 0):
    """The mLSTM between its projections: ``ab`` (B, L, 2·di: this rank's
    channels of a, then of b) -> (the input of ``xl_down`` (B, L, di) in
    ``dtype``, the state after it).  ``w``: this rank's ``conv_w``,
    ``conv_b``, ``q``, ``k``, ``v`` and ``lskip``; ``gates_of`` maps the
    conv's output to every head's f32 gates with their bias (B, L, 2H),
    of which this rank reads heads ``h0`` on; ``o`` the f32 output gate
    (B, L, di).  Prefill (L > 1, ``cfg.xlstm_parallel``) takes the
    parallel form, decode the sequential step, from ``state`` (or the
    initial one)."""
    B, L = ab.shape[:2]
    _, H_all, dh = _dims(cfg)
    di = ab.shape[-1] // 2  # this rank's channels
    H = di // dh  # and heads
    a, b = torch.split(ab, di, dim=-1)
    tail = state["conv"] if state is not None else None
    ac, new_tail = _causal_conv(a, w["conv_w"], w["conv_b"], tail)
    ac = F.silu(ac)
    q = _blockdiag(w["q"], ac, B, L, H, dh)
    k = _blockdiag(w["k"], ac, B, L, H, dh) * dh**-0.5
    v = _blockdiag(w["v"], a, B, L, H, dh)
    gates = gates_of(ac)
    it = gates[..., h0:h0 + H]
    ft = F.logsigmoid(gates[..., H_all + h0:H_all + h0 + H])
    st = ((state["C"], state["n"], state["m"]) if state is not None
          else tuple(mlstm_state(cfg, B, device=ab.device, heads=H)[n]
                     for n in ("C", "n", "m")))
    seq_fn = (mlstm_sequence_parallel if L > 1 and cfg.xlstm_parallel
              else mlstm_sequence)
    hseq, (C, n, m) = seq_fn(q, k, v, it, ft, st, chunk=cfg.xlstm_chunk)
    hseq = hseq.reshape(B, L, di) * o
    # learnable skip from the conv branch
    hseq = (hseq + w["lskip"] * ac.to(torch.float32)).to(dtype)
    return hseq * F.silu(b), {"C": C, "n": n, "m": m, "conv": new_tail}


def mlstm_block_apply(p: MLSTM, cfg, x, *, state=None,
                      seq: str | None = None):
    """x (B, L, d) -> (x + block(x), {"C", "n", "m", "conv"}).  Prefill
    (L > 1, ``cfg.xlstm_parallel``) takes the parallel form, decode the
    sequential step.  ``seq``: ``x`` is this rank's block of the
    positions over that axis, and so is the output: the normed block is
    gathered and ``xl_down``'s partial sums reduce-scattered over the
    positions."""
    d = x.shape[-1]
    di_all, _, dh = _dims(cfg)
    tp = p.tp
    col = dict(in_dim=d, local=tp)
    h_in = common.seq_gather(common.norm_apply(p.norm, x, cfg.norm), seq)
    ab = common.linear_apply(p.xl_up, h_in, cfg.quant, tag="xl_up", **col)

    def gates_of(ac):
        gates = ac.to(torch.float32) @ p.xl_gates.w.t()
        if tp:  # every head's gates contract over every rank's channels
            gates = coll.psum(gates, sharding.TP_AXIS)
        return gates + p.xl_gates.b

    h0 = sharding.coord(sharding.active_mesh(), sharding.TP_AXIS) * (
        ab.shape[-1] // 2 // dh) if tp else 0
    o = torch.sigmoid(common.linear_apply(p.xl_o, h_in, cfg.quant,
                                          tag="xl_o", **col)
                      .to(torch.float32))
    w = dict(conv_w=p.xl_conv_w, conv_b=p.xl_conv_b, q=p.xl_q.w, k=p.xl_k.w,
             v=p.xl_v.w, lskip=p.lskip)
    y, state = _mix(cfg, ab, w, gates_of, o, x.dtype, state, h0)
    out = common.linear_apply(
        p.xl_down, y, cfg.quant, in_dim=di_all, tag="xl_down",
        x_axis=sharding.TP_AXIS if tp else None, seq=seq)
    return x + out, state


def mlstm_block_apply_tp(p: MLSTM, cfg, x, *, axis: str = "model",
                         seq: str | None = None):
    """:func:`mlstm_block_apply` (full sequence, no state) of a training
    step on a mesh, on this rank's weights gathered over 'data' (a model
    cut by ``sharding.shard_model``).  Where its leaves hold this rank's
    channels (``xl_inner`` split over ``axis``; ``xl_up``'s rows its
    channels of both halves, ``sharding.HALVES``) and the heads divide
    the ``axis`` size M, the block runs on this rank's heads: the
    normed input enters through ``ad_identity`` into the column-parallel
    ``xl_up`` and ``xl_o``, the conv, q/k/v and the cell are local, the
    gates' contraction over the channels is summed over ``axis`` by an
    ``ad_psum`` and its bias added before one ``ad_identity`` (each rank
    reads its heads' gates, so the backward sums the ranks' cotangents),
    the whole ``lskip`` enters through ``ad_identity`` before this
    rank's channels of it are read, and ``xl_down`` is row-parallel,
    ending in ``ad_psum``.  Where the channels split but the heads do
    not, each rank gathers every leaf whole (``xl_up`` back to the
    single-device order) and runs the block whole, as it does where
    nothing splits.  ``seq``: ``x`` and the output are this rank's block
    of the positions over that axis: the norm acts on the block
    (``common.norm_block``), its output is gathered whole
    (``common.seq_gather``, in place of ``ad_identity``) and ``xl_down``
    reduce-scatters over the positions (a whole block's output is cut
    to this rank's).  Returns x + block(x)."""
    di_all, H_all, dh = _dims(cfg)
    whole = common.whole_rows
    split = p.xl_up.w.shape[0] != 2 * di_all
    mesh = sharding.active_mesh()
    M = sharding.tp_size(mesh)
    tp = split and H_all % M == 0
    h_in = common.norm_block(p.norm, x, cfg.norm, seq)
    up, down, o_w = p.xl_up.w, p.xl_down.w, p.xl_o.w
    w = dict(conv_w=p.xl_conv_w, conv_b=p.xl_conv_b, q=p.xl_q.w, k=p.xl_k.w,
             v=p.xl_v.w, lskip=p.lskip)
    gates_w = p.xl_gates.w
    h0 = 0
    if seq is not None:
        h_in = common.seq_gather(h_in, seq, partial=tp)
    elif tp:
        h_in = coll.ad_identity(h_in, axis)
    if tp:
        n = up.shape[0] // 2
        r = sharding.coord(mesh, axis)
        w["lskip"] = coll.ad_identity(w["lskip"], axis).narrow(0, r * n, n)
        h0 = r * (n // dh)
    elif split:
        kw = dict(partial=False)
        up = sharding.from_blocks(whole(up, 2 * di_all, 0, axis, **kw), M)
        w["conv_w"] = whole(w["conv_w"], di_all, 1, axis, **kw)
        w["conv_b"] = whole(w["conv_b"], di_all, 0, axis, **kw)
        for name in ("q", "k", "v"):
            w[name] = whole(w[name], H_all, 0, axis, **kw)
        gates_w = whole(gates_w, di_all, 1, axis, **kw)
        o_w = whole(o_w, di_all, 0, axis, **kw)
        down = whole(down, di_all, 1, axis, **kw)
    ab = common.local_linear(up, h_in, tag="xl_up")

    def gates_of(ac):
        gates = ac.to(torch.float32) @ gates_w.t()
        if tp:
            return coll.ad_identity(coll.ad_psum(gates, axis)
                                    + p.xl_gates.b, axis)
        return gates + p.xl_gates.b

    o = torch.sigmoid(common.local_linear(o_w, h_in, tag="xl_o")
                      .to(torch.float32))
    y, _ = _mix(cfg, ab, w, gates_of, o, x.dtype, h0=h0)
    out = common.local_linear(down, y, tag="xl_down")
    if seq is not None:
        return x + common.seq_scatter(out, seq, partial=tp)
    return x + (coll.ad_psum(out, axis) if tp else out)


def mlstm_state(cfg, batch: int, dtype=torch.float32, *, device=None,
                heads: int | None = None) -> dict:
    """The initial state: C, n zero and the stabilizer m at -inf (f32),
    the conv tail (batch, K-1, di) in ``dtype``; of ``heads`` heads (and
    their channels) where a rank holds some of them."""
    di, H, dh = _dims(cfg)
    if heads is not None:
        di, H = heads * dh, heads
    return {"C": torch.zeros((batch, H, dh, dh), device=device),
            "n": torch.zeros((batch, H, dh), device=device),
            "m": torch.full((batch, H), -torch.inf, device=device),
            "conv": torch.zeros((batch, cfg.xlstm_conv - 1, di), dtype=dtype,
                                device=device)}


# =========================================================== sLSTM block
class SLSTM(common.Tree):
    """norm, norm2, sl_w {w (4d, d), b}, sl_r {w (4d, d)}, mlp (GeGLU):
    the reference's ``slstm_init`` tree."""


def _mlp_cfg(cfg):
    return cfg.replace(mlp_activation="geglu")


def slstm_init(cfg, *, generator: torch.Generator, device=None) -> SLSTM:
    d = cfg.d_model
    kw = dict(generator=generator, device=device)
    w = common.truncated_normal((4 * d, d), d**-0.5, **kw)
    r = common.truncated_normal((4 * d, d), d**-0.5, **kw)
    b = torch.cat([torch.zeros(2 * d, device=device),
                   3.0 * torch.ones(d, device=device),
                   torch.zeros(d, device=device)])
    return SLSTM(norm=common.norm_init(d, cfg.norm, device=device),
                 norm2=common.norm_init(d, cfg.norm, device=device),
                 sl_w=common.Tree(w=w, b=b), sl_r=common.Tree(w=r),
                 mlp=common.mlp_init(_mlp_cfg(cfg),
                                     int(d * cfg.slstm_mlp_factor), **kw))


def _slstm_step(state, wx, R):
    """state: (h, c, n, m) each (B, d); wx (B, 4d) precomputed W x_t + b."""
    h, c, n, m = state
    zifo = wx + h @ R.t()  # memory mixing through the recurrent matrix
    z, it, ft, o = torch.chunk(zifo, 4, dim=-1)
    ft = F.logsigmoid(ft)
    m_new = torch.maximum(ft + m, it)
    i_p = torch.exp(it - m_new)
    f_p = torch.exp(ft + m - m_new)
    c_new = f_p * c + i_p * torch.tanh(z)
    n_new = f_p * n + i_p
    h_new = torch.sigmoid(o) * c_new / torch.clamp(n_new, min=1e-6)
    return (h_new, c_new, n_new, m_new), h_new


class _SLSTMFake(torch.autograd.Function):
    """The sLSTM's recurrence over fake tensors (the dry run), where the
    step loop would trace every position of a long sequence: it
    allocates, in one piece each, what the loop does (``common.
    chunked_scan``: the outputs stacked over the time axis beside their
    pieces, and with a backward pass to come the carry of every
    rematerialized chunk but the first, which the loop keeps for it),
    and in the backward the gradients of ``wx``, ``R`` and the state.
    Nothing is computed."""

    @staticmethod
    def forward(ctx, wx, R, h, c, n, m, chunk):
        T, B, d = wx.shape[0], wx.shape[1], R.shape[1]
        pieces = wx.new_empty((T, B, d))  # the steps' outputs, stacked
        hs = wx.new_empty((T, B, d))
        del pieces
        kept = wx.new_empty((0,))
        if chunk < T and any(ctx.needs_input_grad):
            kept = wx.new_empty((T // chunk - 1, 4, B, d))
        ctx.chunk = chunk
        ctx.save_for_backward(wx, R, kept)
        return (hs,) + tuple(t.new_empty(t.shape) for t in (h, c, n, m))

    @staticmethod
    def backward(ctx, *cts):
        wx, R, _ = ctx.saved_tensors
        state = [wx.new_empty(cts[1].shape) for _ in range(4)]
        # a chunk's recompute keeps its steps' activations (about 18 of
        # (B, d) a step) beside the gradient summed so far, and a step's
        # gradient of the chunk's wx lands in a zero tensor of the
        # chunk's size before it is added to the chunk's sum; then the
        # chunk's gradient lands in a zero tensor of wx's size, which is
        # added to the sum out of place
        T, B, d = wx.shape[0], wx.shape[1], R.shape[1]
        n = min(ctx.chunk, T)
        grad = wx.new_empty(wx.shape)
        steps = wx.new_empty((n, B, 18 * d))
        step_part = wx.new_empty((2, n, B, 4 * d))
        del steps, step_part
        part, acc = wx.new_empty(wx.shape), wx.new_empty(wx.shape)
        del part, acc
        return (grad, R.new_empty(R.shape), *state, None)


def _slstm_scan(wx, R, st: tuple, chunk: int):
    """The sLSTM's steps over the time-major ``wx`` (T, B, 4d) from the
    state ``st`` (h, c, n, m): (the state after them, the outputs (T, B,
    d)); :class:`_SLSTMFake`'s allocations alone on fake tensors."""
    if is_fake(wx):
        hs, *last = _SLSTMFake.apply(wx, R, *st, chunk)
        return tuple(last), hs
    return _scan(lambda s, xt: _slstm_step(s, xt[0], R), st, (wx,), chunk)


def _recurrence(p: SLSTM, cfg, x, state=None, seq: str | None = None):
    """(x plus the sLSTM's outputs over x's L true steps from ``state``
    (or the initial one), the state after them).  ``seq``: ``x`` is
    this rank's block of the positions over that axis, and so is the
    output: the normed block is gathered whole, the recurrence runs
    whole on every rank (its weights' gradients whole on each: none is
    summed), and its outputs are cut to the block."""
    xi = common.seq_gather(common.norm_block(p.norm, x, cfg.norm, seq), seq)
    B = xi.shape[0]
    wx = xi.to(torch.float32) @ p.sl_w.w.t() + p.sl_w.b  # (B, L, 4d)
    if state is None:
        state = slstm_state(cfg, B, device=x.device)
    st = tuple(state[n] for n in ("h", "c", "n", "m"))
    (h, c, n, m), hs = _slstm_scan(wx.movedim(1, 0), p.sl_r.w, st,
                                   cfg.xlstm_chunk)
    hs = common.seq_scatter(hs.movedim(0, 1), seq, partial=False)
    return x + hs.to(x.dtype), {"h": h, "c": c, "n": n, "m": m}


def slstm_block_apply(p: SLSTM, cfg, x, *, state=None,
                      seq: str | None = None):
    """x (B, L, d) -> (x + sLSTM + MLP, {"h", "c", "n", "m"}: the state
    after the L true steps).  ``seq``: ``x`` and the output are this
    rank's block of the positions over that axis (:func:`_recurrence`;
    the MLP gathers its normed block, ``common.mlp_apply``)."""
    x, state = _recurrence(p, cfg, x, state, seq)
    x = x + common.mlp_apply(p.mlp, common.norm_apply(p.norm2, x, cfg.norm),
                             _mlp_cfg(cfg), seq=seq)
    return x, state


def slstm_block_apply_tp(p: SLSTM, cfg, x, *, axis: str = "model",
                         seq: str | None = None):
    """:func:`slstm_block_apply` (full sequence, no state) of a training
    step on a mesh: the recurrence runs whole on every rank (W and R
    gathered over 'data', the 'embed' axes, never split over ``axis``),
    so every rank holds their whole gradients and none is summed over
    ``axis``; the GeGLU MLP runs as any MLP of the step does
    (``common.mlp_apply_tp``).  ``seq``: ``x`` and the output are this
    rank's block of the positions over that axis (the norms act on it,
    their scales' gradients summed over the ranks; the recurrence's
    input gathered and its output cut, :func:`_recurrence`).  Returns
    the block's output."""
    x, _ = _recurrence(p, cfg, x, seq=seq)
    return common.mlp_apply_tp(
        p.mlp, common.norm_block(p.norm2, x, cfg.norm, seq), _mlp_cfg(cfg),
        residual=x, d_ff=int(x.shape[-1] * cfg.slstm_mlp_factor),
        axis=axis, seq=seq)


def slstm_state(cfg, batch: int, dtype=torch.float32, *, device=None
                ) -> dict:
    """The initial state: h, c, n zero and m at -inf, (batch, d) f32
    (``dtype`` is unused: the sLSTM keeps no activation-dtype tail)."""
    z = lambda: torch.zeros((batch, cfg.d_model), device=device)  # noqa: E731
    return {"h": z(), "c": z(), "n": z(),
            "m": torch.full((batch, cfg.d_model), -torch.inf, device=device)}
