"""The collectives of the port's mesh; port of repro.distributed.collectives.

Every collective the port issues goes through this module, so its
transport lives in one place.  :func:`backend_for` picks the process
group's backend by layout: when each rank has a card of its own, NCCL
carries CUDA tensors on the card (gloo beside it carries host tensors,
the leader's step arrays); when ranks share a card (NCCL refuses two
ranks of one communicator on one device) or run on the CPU, the group is
gloo, and a CUDA tensor crosses it from host memory: copied to the host,
reduced or gathered there, and copied back.  :func:`transport` names
which of the two a group uses.  Compute stays on the rank's device.

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
* :func:`collective_cost` — the analytic (hops, bytes) model, the
  reference's unchanged.

``counts`` tallies the collectives issued, by kind (a ring counts each
hop), the way a kernel module counts its launches.  The reference's
``int8_all_gather`` (compressed FSDP gathers for training) is not ported
(ROADMAP A13c).
"""

from __future__ import annotations

from collections import Counter

import torch
import torch.distributed as dist

from repro_torch.distributed import compat

NCCL = "nccl"
STAGED = "gloo, host-staged"

# collectives issued since the last reset, by kind
counts: Counter = Counter()


def reset_counts() -> None:
    counts.clear()


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
    else in host memory."""
    if t.is_cuda and transport(group) == NCCL:
        return t.detach().clone(memory_format=torch.contiguous_format)
    return t.detach().to("cpu", copy=True).contiguous()


def psum(y: torch.Tensor, axis: str, *, mesh=None) -> torch.Tensor:
    """The sum of ``y`` over the ranks of ``axis`` (all-reduce)."""
    return psum_async(y, axis, mesh=mesh).wait()


class Pending:
    """An all-reduce in flight: :meth:`wait` returns its result on the
    device of the tensor that went in."""

    def __init__(self, host, work, device):
        self.host, self.work, self.device = host, work, device

    def wait(self) -> torch.Tensor:
        if self.work is not None:
            self.work.wait()
        return self.host.to(self.device)


def psum_async(y: torch.Tensor, axis: str, *, mesh=None) -> Pending:
    """:func:`psum` issued without waiting: compute issued before
    ``wait()`` runs while the reduction is in flight."""
    mesh = _mesh(mesh)
    if _size(mesh, axis) == 1:
        return Pending(y, None, y.device)
    group = mesh.get_group(axis)
    h = _wire(y, group)
    counts["all_reduce"] += 1
    work = dist.all_reduce(h, group=group, async_op=True)
    return Pending(h, work, y.device)


def psum_scatter(y: torch.Tensor, axis: str, *, dim: int = -1,
                 mesh=None) -> torch.Tensor:
    """This rank's block (along ``dim``) of the sum of ``y`` over
    ``axis``: block p to rank p, as ``lax.psum_scatter(tiled=True)``."""
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
    if y.is_cuda and transport(group) == NCCL:
        h = y.detach().movedim(dim, 0).contiguous()
        out = h.new_empty((size,) + h.shape[1:])
        counts["reduce_scatter"] += 1
        dist.reduce_scatter_tensor(out, h, group=group)
        return out.movedim(0, dim).contiguous()
    s = psum(y, axis, mesh=mesh)
    return s.narrow(dim, mesh.get_local_rank(axis) * size, size).contiguous()


def all_gather(y: torch.Tensor, axis: str, *, dim: int = -1,
               mesh=None) -> torch.Tensor:
    """The ranks' ``y`` of ``axis`` concatenated along ``dim`` in axis
    order."""
    mesh = _mesh(mesh)
    n = _size(mesh, axis)
    if n == 1:
        return y
    group = mesh.get_group(axis)
    h = _wire(y, group)
    outs = [torch.empty_like(h) for _ in range(n)]
    counts["all_gather"] += 1
    dist.all_gather(outs, h, group=group)
    return torch.cat(outs, dim=dim).to(y.device)


def broadcast(t: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    """``t`` overwritten in place with global rank ``src``'s (over
    ``group``, default the whole world); returns ``t``."""
    h = _wire(t, group)
    counts["broadcast"] += 1
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
    counts["ring_hop"] += 1
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
