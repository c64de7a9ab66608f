"""The collectives of the port's mesh; port of repro.distributed.collectives.

Every collective the port issues goes through this module, so its
transport lives in one place.  :func:`backend_for` picks the process
group's backend by layout: when each rank has a card of its own, NCCL
carries CUDA tensors on the card (gloo beside it carries host tensors,
the leader's step arrays); when ranks share a card (NCCL refuses two
ranks of one communicator on one device) or run on the CPU, the group is
gloo, and a CUDA tensor crosses it from host memory: copied to the host
(into pinned memory, about ten times faster both ways than pageable),
reduced or gathered there, and copied back (a gather's blocks are
concatenated on the card).  :func:`transport` names which of the two a
group uses.  Compute stays on the rank's device.

* :func:`psum`, :func:`psum_scatter`, :func:`all_gather`,
  :func:`broadcast` — the group's own collectives over one mesh axis
  (``psum_scatter`` is NCCL's reduce-scatter; over gloo the all-reduce
  followed by this rank's block, gloo's reduce-scatter not being relied
  on);
* :func:`ring_reduce_scatter`, :func:`ring_all_gather`,
  :func:`ring_psum` — the same reductions as N-1 (or 2(N-1))
  point-to-point hops over the axis's group (``batch_isend_irecv``),
  with the reference's block-to-rank assignment: rank p of the axis ends
  with block p;
* :func:`all_to_all` — block j of a tensor along one dim to rank j of
  an axis, the blocks a rank receives concatenated along another dim
  (the MoE's return of the experts' outputs to the tokens' ranks);
* :func:`pmax` — the elementwise maximum over one mesh axis;
* :func:`ad_all_gather`, :func:`ad_psum_scatter`, :func:`ad_psum`,
  :func:`ad_identity`, :func:`ad_all_to_all`, :func:`ad_block` — the
  forms the train step differentiates through (autograd functions): an
  all-gather whose backward reduce-scatters (or, for a gather whose
  consumers run replicated, takes this rank's block), a reduce-scatter
  whose backward all-gathers, this rank's block of a replicated tensor
  whose backward all-gathers, a psum whose backward passes the cotangent
  through (or,
  for ranks that each use a part of the sum, psums it), an identity
  whose backward psums (the input of a column-parallel region, whose
  ranks each see a part of its gradient), and an all-to-all whose
  backward is the all-to-all with the two dims swapped;
* :func:`int8_all_gather` — an FSDP gather in int8 (one scale a leaf,
  the pmax of the shards' max |x|), whose backward reduce-scatters the
  cotangent;
* :func:`collective_cost` — the analytic (hops, bytes) model, the
  reference's unchanged.

``counts`` tallies the collectives issued, by kind (a ring counts each
hop), the way a kernel module counts its launches, and ``nbytes`` the
bytes of their results on this rank (a reduce-scatter counts as one
whatever carries it: over host-staged gloo it is an all-reduce and a
slice).  With :func:`set_timing` on, ``seconds`` adds up the host-clock
time of each blocking collective by kind, the device synchronised before
and after it (off by default: the synchronisation costs a wait).
"""

from __future__ import annotations

import contextlib
import time
from collections import Counter

import torch
import torch.distributed as dist

from repro_torch.distributed import compat

NCCL = "nccl"
STAGED = "gloo, host-staged"
# the kinds of the residual stream's collectives where its positions lie
# over 'seq' (``sharding.residual_axis``): a block's input gathered
# whole at its entry, and its row-parallel partial sums reduce-scattered
# back onto this rank's positions at its exit
SEQ_IN, SEQ_OUT = "seq_in_gather", "seq_out_scatter"

# collectives issued since the last reset, by kind, and their result bytes
counts: Counter = Counter()
nbytes: Counter = Counter()
seconds: Counter = Counter()
_TIMING = False


def reset_counts() -> None:
    counts.clear()
    nbytes.clear()
    seconds.clear()


def set_timing(on: bool) -> None:
    """Time every blocking collective into ``seconds`` (by kind)."""
    global _TIMING
    _TIMING = bool(on)


@contextlib.contextmanager
def _timed(kind: str, t: torch.Tensor):
    if not _TIMING:
        yield
        return
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if t.is_cuda:
            torch.cuda.synchronize(t.device)
        seconds[kind] += time.perf_counter() - t0


def _count(kind: str, result: torch.Tensor) -> None:
    counts[kind] += 1
    nbytes[kind] += result.numel() * result.element_size()


def _mesh(mesh):
    if mesh is not None:
        return mesh
    from repro_torch.distributed.sharding import active_mesh

    mesh = active_mesh()
    if mesh is None:
        raise RuntimeError("a collective outside a mesh (sharding.use)")
    return mesh


def _size(mesh, axis: str) -> int:
    return compat.axes_of(mesh)[axis]


def backend_for(devices) -> str:
    """The process-group backend of ranks on ``devices`` (one a rank):
    NCCL for CUDA tensors, beside gloo for host ones, when each rank has
    a card of its own; gloo alone otherwise."""
    devs = [torch.device(d) for d in devices]
    own = all(d.type == "cuda" for d in devs) and \
        len({d.index or 0 for d in devs}) == len(devs)
    return "cpu:gloo,cuda:nccl" if own else "gloo"


def transport(group=None) -> str:
    """How ``group`` (default the whole world) carries a CUDA tensor:
    :data:`NCCL` on the card, or :data:`STAGED` through host memory."""
    return NCCL if "cuda:nccl" in dist.get_backend_config(group) \
        else STAGED


def _wire(t: torch.Tensor, group) -> torch.Tensor:
    """A fresh contiguous copy of ``t`` for a collective to work on in
    place (never the caller's tensor): on the card when NCCL carries it,
    else in host memory (pinned for a CUDA tensor)."""
    if t.is_cuda and transport(group) == NCCL:
        return t.detach().clone(memory_format=torch.contiguous_format)
    if t.is_cuda:
        return torch.empty(t.shape, dtype=t.dtype,
                           pin_memory=True).copy_(t.detach())
    return t.detach().to("cpu", copy=True).contiguous()


def _back(h: torch.Tensor, device) -> torch.Tensor:
    """A wire buffer's contents on ``device`` (from pinned memory without
    waiting: the caching host allocator keeps the buffer until the copy
    is done)."""
    return h.to(device, non_blocking=h.is_pinned())


def psum(y: torch.Tensor, axis: str, *, mesh=None) -> torch.Tensor:
    """The sum of ``y`` over the ranks of ``axis`` (all-reduce)."""
    with _timed("all_reduce", y):
        return psum_async(y, axis, mesh=mesh).wait()


class Pending:
    """An all-reduce in flight: :meth:`wait` returns its result on the
    device of the tensor that went in."""

    def __init__(self, host, work, device):
        self.host, self.work, self.device = host, work, device

    def wait(self) -> torch.Tensor:
        if self.work is not None:
            self.work.wait()
        return _back(self.host, self.device)


def psum_async(y: torch.Tensor, axis: str, *, mesh=None,
               op=dist.ReduceOp.SUM, kind: str = "all_reduce") -> Pending:
    """:func:`psum` issued without waiting: compute issued before
    ``wait()`` runs while the reduction is in flight.  ``op``: the
    reduction; ``kind``: the name it is counted under ('' for none)."""
    mesh = _mesh(mesh)
    if _size(mesh, axis) == 1:
        return Pending(y, None, y.device)
    group = mesh.get_group(axis)
    h = _wire(y, group)
    if kind:
        _count(kind, h)
    work = dist.all_reduce(h, op=op, group=group, async_op=True)
    return Pending(h, work, y.device)


def pmax(y: torch.Tensor, axis: str, *, mesh=None) -> torch.Tensor:
    """The elementwise maximum of ``y`` over the ranks of ``axis``."""
    with _timed("all_reduce_max", y):
        return psum_async(y, axis, mesh=mesh, op=dist.ReduceOp.MAX,
                          kind="all_reduce_max").wait()


def psum_scatter(y: torch.Tensor, axis: str, *, dim: int = -1,
                 mesh=None, kind: str = "reduce_scatter") -> torch.Tensor:
    """This rank's block (along ``dim``) of the sum of ``y`` over
    ``axis``: block p to rank p, as ``lax.psum_scatter(tiled=True)``;
    counted under ``kind``."""
    mesh = _mesh(mesh)
    n = _size(mesh, axis)
    dim = dim % y.ndim
    if y.shape[dim] % n:
        raise ValueError(f"psum_scatter: dim {dim} of {tuple(y.shape)} not "
                         f"divisible by axis {axis!r} size {n}")
    if n == 1:
        return y
    group = mesh.get_group(axis)
    size = y.shape[dim] // n
    with _timed(kind, y):
        if y.is_cuda and transport(group) == NCCL:
            h = y.detach().movedim(dim, 0).contiguous()
            out = h.new_empty((size,) + h.shape[1:])
            _count(kind, out)
            dist.reduce_scatter_tensor(out, h, group=group)
            return out.movedim(0, dim).contiguous()
        # the whole sum in host memory; this rank's block cut on the
        # device (a CUDA tensor's whole sum goes back: pinned copies cost
        # less than a strided cut on the host)
        h = _wire(y, group)
        dist.all_reduce(h, group=group)
        if not h.is_pinned():
            h = h.narrow(dim, mesh.get_local_rank(axis) * size, size)
        out = _back(h, y.device)
        if h.is_pinned():
            out = out.narrow(dim, mesh.get_local_rank(axis) * size, size)
        out = out.contiguous()
        _count(kind, out)
        return out


def all_gather(y: torch.Tensor, axis: str, *, dim: int = -1,
               mesh=None, kind: str = "all_gather") -> torch.Tensor:
    """The ranks' ``y`` of ``axis`` concatenated along ``dim`` in axis
    order; counted under ``kind`` (serving's gathers of FSDP-stored
    weights count as ``fsdp_gather``)."""
    mesh = _mesh(mesh)
    n = _size(mesh, axis)
    if n == 1:
        return y
    group = mesh.get_group(axis)
    with _timed(kind, y):
        # the blocks land in one buffer (pinned with the wire), and are
        # concatenated on the rank's device
        h = _wire(y, group)
        flat = torch.empty(n * h.numel(), dtype=h.dtype, device=h.device,
                           pin_memory=h.is_pinned())
        dist.all_gather_into_tensor(flat, h.reshape(-1), group=group)
        blocks = _back(flat, y.device).view((n,) + tuple(h.shape))
        out = torch.cat(blocks.unbind(0), dim=dim)
    _count(kind, out)
    return out


def all_to_all(y: torch.Tensor, axis: str, *, split_dim: int,
               concat_dim: int, mesh=None,
               kind: str = "all_to_all") -> torch.Tensor:
    """Block j of ``y`` along ``split_dim`` (which must divide by the axis
    size N) sent to rank j of ``axis``; the N blocks this rank receives
    concatenated along ``concat_dim`` in axis order.  Counted under
    ``kind``, by the bytes of the result (the bytes sent too: every block
    has one size)."""
    mesh = _mesh(mesh)
    n = _size(mesh, axis)
    if n == 1:
        return y
    split_dim, concat_dim = split_dim % y.ndim, concat_dim % y.ndim
    if y.shape[split_dim] % n:
        raise ValueError(f"all_to_all: dim {split_dim} of {tuple(y.shape)} "
                         f"not divisible by axis {axis!r} size {n}")
    group = mesh.get_group(axis)
    with _timed(kind, y):
        # the blocks one after another along dim 0, each contiguous
        src = y.movedim(split_dim, 0)
        h = _wire(src.reshape((n, src.shape[0] // n) + src.shape[1:]),
                  group)
        recv = torch.empty(h.shape, dtype=h.dtype, device=h.device,
                           pin_memory=h.is_pinned())
        dist.all_to_all_single(recv, h, group=group)
        blocks = _back(recv, y.device).movedim(1, split_dim + 1)
        out = torch.cat(blocks.unbind(0), dim=concat_dim)
    _count(kind, out)
    return out


def broadcast(t: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    """``t`` overwritten in place with global rank ``src``'s (over
    ``group``, default the whole world); returns ``t``."""
    h = _wire(t, group)
    _count("broadcast", h)
    dist.broadcast(h, src, group=group)
    t.copy_(h)
    return t


# ------------------------------------------------------------------ rings
def _ring(mesh, axis: str):
    """(n, this rank's index p, the group, global rank of p+1, of p-1)."""
    group = mesh.get_group(axis)
    ranks = dist.get_process_group_ranks(group)
    n = len(ranks)
    p = mesh.get_local_rank(axis)
    return n, p, group, ranks[(p + 1) % n], ranks[(p - 1) % n]


def _hop(t: torch.Tensor, group, nxt: int, prv: int) -> torch.Tensor:
    """Send ``t`` (a wire buffer) to the next rank and receive the
    previous one's."""
    r = torch.empty_like(t)
    _count("ring_hop", r)
    ops = [dist.P2POp(dist.isend, t.contiguous(), nxt, group),
           dist.P2POp(dist.irecv, r, prv, group)]
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    return r


def ring_reduce_scatter(y: torch.Tensor, axis: str, *, dim: int = -1,
                        mesh=None) -> torch.Tensor:
    """Block ring reduce-scatter of ``y`` over ``axis``: ``y.shape[dim]``
    must divide by the axis size N; rank p ends with block p of the sum,
    after N-1 hops of one block each."""
    mesh = _mesh(mesh)
    n, p, group, nxt, prv = _ring(mesh, axis)
    if n == 1:
        return y
    dim = dim % y.ndim
    if y.shape[dim] % n:
        raise ValueError(
            f"ring_reduce_scatter: dim {dim} of {tuple(y.shape)} not "
            f"divisible by axis {axis!r} size {n}")
    h = _wire(y, group)
    sz = h.shape[dim] // n

    def blk(i):
        return h.narrow(dim, (i % n) * sz, sz)

    # rank p seeds the ring with block p-1; after hop t it holds the
    # running sum of block (p-t-2 mod n) over ranks p-t-1..p, so after
    # n-1 hops it ends with block p fully reduced
    acc = blk(p + n - 1).clone()
    for t in range(n - 1):
        acc = _hop(acc, group, nxt, prv)
        acc = acc + blk(p + 2 * n - t - 2)
    return acc.to(y.device)


def ring_all_gather(y: torch.Tensor, axis: str, *, dim: int = -1,
                    mesh=None) -> torch.Tensor:
    """Ring all-gather over ``axis`` (the inverse of the scatter): rank p
    contributes block p; the output concatenates all N blocks along
    ``dim`` in axis order, after N-1 single-block hops."""
    mesh = _mesh(mesh)
    n, p, group, nxt, prv = _ring(mesh, axis)
    if n == 1:
        return y
    dim = dim % y.ndim
    cur = _wire(y, group)
    blocks = [None] * n
    blocks[p] = cur
    for t in range(n - 1):
        cur = _hop(cur, group, nxt, prv)
        blocks[(p - t - 1) % n] = cur  # hop t delivers rank p-t-1's block
    return torch.cat(blocks, dim=dim).to(y.device)


def ring_psum(y: torch.Tensor, axis: str, *, mesh=None) -> torch.Tensor:
    """Ring all-reduce of ``y`` over ``axis``: the reduce-scatter +
    all-gather ring (2(N-1) hops of 1/N blocks) when the last dim divides
    by N, else the full-buffer ring (N-1 hops of the whole partial)."""
    mesh = _mesh(mesh)
    n, p, group, nxt, prv = _ring(mesh, axis)
    if n == 1:
        return y
    if y.shape[-1] % n == 0:
        sc = ring_reduce_scatter(y, axis, dim=-1, mesh=mesh)
        return ring_all_gather(sc, axis, dim=-1, mesh=mesh)
    h = _wire(y, group)
    acc, cur = h.clone(), h
    for _ in range(n - 1):
        cur = _hop(cur, group, nxt, prv)
        acc = acc + cur
    return acc.to(y.device)


def collective_cost(*, impl: str, collective: str, axis_size: int,
                    elems: int, dtype_bytes: int = 4,
                    pipeline_chunks: int = 1):
    """Analytic (hops, bytes) one device moves to resolve a k-sharded
    contraction whose full (unscattered) partial output has ``elems``
    elements, split into ``pipeline_chunks`` k-chunks.

    Returns ``(hops_total, bytes_total)`` summed over all chunks.  The
    ring impls count their actual hops; the group's own collectives are
    modeled as one logical hop per chunk moving the standard-algorithm
    byte volume (ring-equivalent: (N-1)/N of the buffer for a
    reduce-scatter, twice that for an all-reduce)."""
    n = int(axis_size)
    pc = max(int(pipeline_chunks), 1)
    if n <= 1:
        return 0, 0.0
    chunk_bytes = elems / pc * dtype_bytes
    if impl == "ring":
        if collective == "reduce_scatter":
            hops_c = n - 1
            bytes_c = (n - 1) * chunk_bytes / n
        elif chunk_bytes and elems % (pc * n) == 0:
            # rs+ag ring: 2(N-1) hops of 1/N-size blocks
            hops_c = 2 * (n - 1)
            bytes_c = 2 * (n - 1) * chunk_bytes / n
        else:
            # naive full-buffer ring
            hops_c = n - 1
            bytes_c = (n - 1) * chunk_bytes
    else:  # the group's own psum / psum_scatter
        hops_c = 1
        scale = 1 if collective == "reduce_scatter" else 2
        bytes_c = scale * (n - 1) * chunk_bytes / n
    return hops_c * pc, bytes_c * pc


def broadcast_object(obj, src: int = 0, group=None):
    """Global rank ``src``'s ``obj`` on every rank (pickled, over the
    host group)."""
    box = [obj]
    counts["broadcast"] += 1
    dist.broadcast_object_list(box, src=src, group=group)
    return box[0]


# ---------------------------------------------------------------- autograd
class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim, mesh, reduce_grad, kind):
        ctx.args = (axis, dim, mesh, reduce_grad)
        return all_gather(x, axis, dim=dim, mesh=mesh, kind=kind)

    @staticmethod
    def backward(ctx, ct):
        axis, dim, mesh, reduce_grad = ctx.args
        if reduce_grad:
            return psum_scatter(ct, axis, dim=dim, mesh=mesh), \
                None, None, None, None, None
        from repro_torch.distributed.sharding import coord

        size = ct.shape[dim] // _size(mesh, axis)
        return ct.narrow(dim, coord(mesh, axis) * size, size).contiguous(), \
            None, None, None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, split_dim, concat_dim, mesh, kind):
        ctx.args = (axis, split_dim, concat_dim, mesh, kind)
        return all_to_all(x, axis, split_dim=split_dim,
                          concat_dim=concat_dim, mesh=mesh, kind=kind)

    @staticmethod
    def backward(ctx, ct):
        axis, split_dim, concat_dim, mesh, kind = ctx.args
        return all_to_all(ct, axis, split_dim=concat_dim,
                          concat_dim=split_dim, mesh=mesh, kind=kind), \
            None, None, None, None, None


class _PsumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim, mesh, kind):
        ctx.args = (axis, dim, mesh)
        return psum_scatter(x, axis, dim=dim, mesh=mesh, kind=kind)

    @staticmethod
    def backward(ctx, ct):
        axis, dim, mesh = ctx.args
        return all_gather(ct, axis, dim=dim, mesh=mesh), \
            None, None, None, None


class _Block(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim, mesh):
        from repro_torch.distributed.sharding import coord

        ctx.args = (axis, dim, mesh)
        size = x.shape[dim] // _size(mesh, axis)
        return x.narrow(dim, coord(mesh, axis) * size, size).contiguous()

    @staticmethod
    def backward(ctx, ct):
        axis, dim, mesh = ctx.args
        return all_gather(ct.contiguous(), axis, dim=dim, mesh=mesh), \
            None, None, None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, mesh):
        return psum(x, axis, mesh=mesh)

    @staticmethod
    def backward(ctx, ct):
        return ct, None, None


class _Identity(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, mesh):
        ctx.args = (axis, mesh)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, ct):
        axis, mesh = ctx.args
        return psum(ct, axis, mesh=mesh), None, None


def ad_all_gather(x: torch.Tensor, axis: str, *, dim: int, mesh=None,
                  reduce_grad: bool = True,
                  kind: str = "all_gather") -> torch.Tensor:
    """:func:`all_gather` of ``x`` along ``dim`` (counted under ``kind``),
    differentiable.  Its backward reduce-scatters the cotangent (each
    rank's covers its own rows or heads: the sum over the ranks is the
    gradient), or with ``reduce_grad=False`` takes this rank's block of
    it (the consumers ran replicated, so every rank holds the whole
    gradient)."""
    mesh = _mesh(mesh)
    if _size(mesh, axis) == 1:
        return x
    return _AllGather.apply(x, axis, dim % x.ndim, mesh, reduce_grad, kind)


def ad_all_to_all(x: torch.Tensor, axis: str, *, split_dim: int,
                  concat_dim: int, mesh=None,
                  kind: str = "all_to_all") -> torch.Tensor:
    """:func:`all_to_all`, differentiable: the block of the cotangent that
    each rank's block of the result came from goes back to that rank, an
    all-to-all with ``split_dim`` and ``concat_dim`` swapped."""
    mesh = _mesh(mesh)
    if _size(mesh, axis) == 1:
        return x
    return _AllToAll.apply(x, axis, split_dim % x.ndim, concat_dim % x.ndim,
                           mesh, kind)


def ad_psum_scatter(x: torch.Tensor, axis: str, *, dim: int,
                    mesh=None, kind: str = "reduce_scatter") -> torch.Tensor:
    """:func:`psum_scatter` (counted under ``kind``), differentiable: its
    backward all-gathers."""
    mesh = _mesh(mesh)
    if _size(mesh, axis) == 1:
        return x
    return _PsumScatter.apply(x, axis, dim % x.ndim, mesh, kind)


def ad_block(x: torch.Tensor, axis: str, *, dim: int,
             mesh=None) -> torch.Tensor:
    """This rank's block along ``dim`` of ``x``, which every rank of
    ``axis`` holds whole (no collective); its backward all-gathers the
    ranks' cotangent blocks, so every rank holds the whole cotangent of
    ``x``, as the consumers that computed it replicated need."""
    mesh = _mesh(mesh)
    if _size(mesh, axis) == 1:
        return x
    return _Block.apply(x, axis, dim % x.ndim, mesh)


def ad_psum(x: torch.Tensor, axis: str, *, mesh=None,
            partial: bool = False) -> torch.Tensor:
    """:func:`psum`, differentiable: the output of a row-parallel region.
    Every rank continues with the same sum, so each holds the whole
    cotangent, and the backward passes it through.  ``partial``: the
    ranks go on to use different parts of the sum (their channels' or
    heads' share of it, a share of a loss), so each holds a part of the
    cotangent, and the backward sums them over ``axis`` too (the sum
    followed by :func:`ad_identity`)."""
    mesh = _mesh(mesh)
    if _size(mesh, axis) == 1:
        return x
    y = _Psum.apply(x, axis, mesh)
    return _Identity.apply(y, axis, mesh) if partial else y


def ad_identity(x: torch.Tensor, axis: str, *, mesh=None) -> torch.Tensor:
    """``x`` itself, whose backward psums the cotangent over ``axis``: the
    input of a column-parallel region (or a replicated weight used there),
    where each rank's backward sees only its shard's part of the
    gradient."""
    mesh = _mesh(mesh)
    if _size(mesh, axis) == 1:
        return x
    return _Identity.apply(x, axis, mesh)


def spec_dim(spec: tuple, axis: str):
    """The dim of ``spec`` that ``axis`` shards, or None."""
    for i, e in enumerate(spec):
        if e == axis or (isinstance(e, tuple) and axis in e):
            return i
    return None


class _Int8AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim, mesh):
        ctx.args = (axis, dim, mesh)
        xf = x.to(torch.float32)
        amax = pmax(xf.abs().amax(), axis, mesh=mesh)
        scale = torch.where(amax > 0, amax / 127.0, 1.0)
        q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
        g = all_gather(q, axis, dim=dim, mesh=mesh)
        return (g.to(torch.float32) * scale).to(x.dtype)

    @staticmethod
    def backward(ctx, ct):
        axis, dim, mesh = ctx.args
        return psum_scatter(ct, axis, dim=dim, mesh=mesh), None, None, None


def int8_all_gather(x: torch.Tensor, mesh, spec: tuple, *,
                    axis: str = "data") -> torch.Tensor:
    """Gather the ``axis``-sharded dim of this rank's block ``x`` (under
    ``spec``) in int8, the reference's steps: the pmax of the shards'
    max |x| (f32), ``scale = amax / 127`` (1 where amax is 0), round,
    clip to ±127, gather the codes, multiply by the scale and cast back.
    The backward reduce-scatters the cotangent over ``axis`` (straight
    through the quantization): each rank's covers its own batch rows,
    where the reference's arrives already reduced and is sliced."""
    dim = spec_dim(spec, axis)
    if dim is None or _size(mesh, axis) == 1:
        return x
    if isinstance(spec[dim], tuple) and spec[dim][-1] != axis:
        raise ValueError(f"int8_all_gather over {axis!r}: spec {spec} "
                         "folds another axis inside it")
    return _Int8AllGather.apply(x, axis, dim, mesh)
