"""Sharded execution of one quantized linear on a device mesh; port of
repro.dispatch.shard.

The paper's produce/consume split interacts with tensor parallelism in a
specific way (§6): the LUT produce cost is amortized over the output
rows m, so sharding m (column parallelism) keeps the amortization *per
shard* — every rank produces the LUT for its activations once and
consumes it over its m rows — instead of replicating the whole GeMM.
Sharding the contraction dim k (row parallelism, the Megatron
down-proj/wo pattern) makes every rank produce a LUT over its k-slice of
the activations, and the partial sums meet in exactly one collective,
after which the epilogue (bias/residual — which must NOT be applied per
shard) runs once.

* :class:`ShardSpec` — the frozen, hashable ``ExecPlan.shard`` field:
  which mesh axis shards m / k / the activation batch, which collective
  resolves the contraction (``psum`` keeps the output whole over the k
  axis, ``reduce_scatter`` leaves it m-sharded), and the mesh shape it
  was derived against (part of the plan-cache key);
* :func:`shard_spec_for` — derives a ShardSpec for one linear from its
  logical weight axes (``distributed.sharding.LINEAR_AXES``), with the
  divisibility and quantization-alignment guards: a dim shards only when
  every packed storage view (idx / u8 / scales) splits on the shard
  boundary;
* :func:`shard_linear` — a linear's weight leaves cut to this rank's
  shard of that layout (the engine places the model with it at build);
* :func:`run_sharded` — the backend's ``run`` on this rank's operands,
  seeing local shapes: the epilogue fused into the kernel per shard
  when no contraction collective separates them, applied exactly once
  after the collective when one does.

Serving runs the training layout (``layers.attn_apply_tp``,
``common.mlp_apply_tp``): a column-parallel output stays on its axis
into the row-parallel linear that consumes it.  The model code asks for
it: ``keep_local`` returns a column-parallel output as this rank's block
of its m axis, and ``x_local`` takes a row-parallel input that already
is this rank's k slice (``dispatch.execute``'s ``x_axis``: the heads
through attention into ``wo``, up and gate into ``down``, a Mamba's or
an mLSTM's channels into its out projection).  The gather over an
output's axis (``distributed.collectives``) then runs only where a
consumer needs the whole row: a column-parallel output asked for whole
(the tied head's logits, a head layout the ranks cannot split), and a
reduce-scattered output, which the next norm reads whole, so
``reduce_scatter`` still moves what ``psum`` does.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from repro_torch import obs
from repro_torch.core.epilogue import Epilogue, apply_epilogue, torch_dtype
from repro_torch.distributed import collectives as coll
from repro_torch.distributed import compat
from repro_torch.distributed import sharding as shd
from repro_torch.kernels import ops as kops

COLLECTIVES = ("psum", "reduce_scatter")
# 'xla' keeps the reference's name for the group's own collective (here
# the process group's all-reduce); 'ring' is the point-to-point ring
COLLECTIVE_IMPLS = ("xla", "ring")


@dataclass(frozen=True)
class ShardSpec:
    """How one linear's GeMM is laid out on the mesh (ExecPlan.shard).

    mesh_axes : ordered ((axis_name, size), ...) snapshot of the mesh the
        spec was derived against — makes the spec self-describing (cache
        keys, warm()) without holding a live mesh.
    m / k / batch : mesh axis name sharding the weight's output rows,
        the contraction dim, and the activations' leading (batch) dim;
        None leaves that dim whole on every rank.  m and k are mutually
        exclusive (one TP axis per linear).
    collective : how k-sharded partial sums meet: ``psum`` (output
        whole over the k axis) or ``reduce_scatter`` (output rows
        scattered over the k axis).  Ignored when k is None.
    pipeline_chunks : number of contraction slices the k-sharded GeMM is
        split into so chunk i's collective overlaps chunk i+1's consume;
        1 is the classic one-collective-per-linear plan.  Only
        meaningful with k sharded.
    collective_impl : ``xla`` (the group's own all-reduce) or ``ring``
        (point-to-point hops, ``distributed.collectives``).  Only
        meaningful with k sharded.
    """

    mesh_axes: tuple[tuple[str, int], ...] = ()
    m: str | None = None
    k: str | None = None
    batch: str | None = None
    collective: str = "psum"
    pipeline_chunks: int = 1
    collective_impl: str = "xla"

    def __post_init__(self):
        if self.collective not in COLLECTIVES:
            raise ValueError(f"collective={self.collective!r} must be one "
                             f"of {COLLECTIVES}")
        if self.collective_impl not in COLLECTIVE_IMPLS:
            raise ValueError(
                f"collective_impl={self.collective_impl!r} must be one of "
                f"{COLLECTIVE_IMPLS}")
        if self.m is not None and self.k is not None:
            raise ValueError("m and k cannot both be sharded by one linear "
                             f"(m={self.m!r}, k={self.k!r})")
        if self.pipeline_chunks < 1:
            raise ValueError(
                f"pipeline_chunks={self.pipeline_chunks} must be >= 1")
        if self.k is None and (self.pipeline_chunks != 1
                               or self.collective_impl != "xla"):
            raise ValueError(
                "pipeline_chunks/collective_impl apply only to k-sharded "
                "(row-parallel) linears — there is no contraction "
                "collective to pipeline otherwise")

    # ------------------------------------------------------------ sizes
    def axis_size(self, axis: str | None) -> int:
        if axis is None:
            return 1
        return dict(self.mesh_axes)[axis]

    @property
    def is_sharded(self) -> bool:
        return any(a is not None and self.axis_size(a) > 1
                   for a in (self.m, self.k, self.batch))

    @property
    def is_pipelined(self) -> bool:
        return self.pipeline_chunks > 1 or self.collective_impl != "xla"

    def local_mkb(self, m: int, k: int, batch: int) -> tuple[int, int, int]:
        """Per-rank (m, k, batch-rows) under this spec."""
        return (m // self.axis_size(self.m), k // self.axis_size(self.k),
                batch // self.axis_size(self.batch))

    def exec_mkb(self, m: int, k: int, batch: int) -> tuple[int, int, int]:
        """Per-kernel-invocation (m, k, batch-rows) — what tile heuristics
        and the autotuner plan and time under this spec: the local shape,
        its contraction divided by ``pipeline_chunks`` (a pipelined plan
        launches the kernel once a k-chunk)."""
        lm, lk, lb = self.local_mkb(m, k, batch)
        return lm, lk // self.pipeline_chunks, lb

    # ------------------------------------------------------------- keys
    def tag(self) -> str:
        """Cache-key fragment: mesh shape + the shard choice.  The
        pipeline suffix (``/pc{n}.{impl}``) is appended only when it
        differs from the one-shot layout (additive keys)."""
        mesh = ".".join(f"{a}{s}" for a, s in self.mesh_axes)
        base = (f"{mesh}/m={self.m or '-'}/k={self.k or '-'}"
                f"/b={self.batch or '-'}/{self.collective}")
        if self.is_pipelined:
            base += f"/pc{self.pipeline_chunks}.{self.collective_impl}"
        return base


def mesh_tag(mesh) -> str:
    """Cache-key fragment for the ambient mesh alone ('-' off-mesh).
    Distinguishes plans measured on N ranks from single-device plans
    even when the linear itself ends up unsharded."""
    if mesh is None:
        return "-"
    return ".".join(f"{a}{s}" for a, s in compat.axes_of(mesh).items())


def plan_shard_tag(shard: "ShardSpec | None", mesh) -> str:
    return shard.tag() if shard is not None else mesh_tag(mesh)


# ------------------------------------------------------------ derivation
def _quant_aligned(spec, k_local: int) -> bool:
    """Can the packed weight storage split at a k_local boundary?  Every
    per-shard view must be whole: scale blocks (scales columns), d-chunks
    (packed_idx columns) and code pairs (packed_u8 columns)."""
    if spec.mode == "bf16":
        return True
    if k_local % spec.scale_block:
        return False
    if k_local % int(spec.d):
        return False
    if spec.storage == "packed_u8" and k_local % 2:
        return False
    return True


def _collective_fallback(kind: str, **labels):
    """Count a downgraded collective layout (reduce_scatter->psum,
    pipeline-chunk clamping)."""
    obs.registry().counter(
        "dispatch_shard_collective_fallback_total",
        help="shard derivations that downgraded the requested collective "
             "layout (reduce_scatter->psum, pipeline-chunk clamping)",
        kind=kind, **labels).inc()


def shard_spec_for(spec, axes, m: int, k: int, batch: int, mesh, *,
                   lead_batch: int | None = None,
                   collective: str = "psum",
                   rules: str = "default",
                   pipeline_chunks: int = 1,
                   collective_impl: str = "xla") -> ShardSpec | None:
    """Derive the ShardSpec for one linear, or None to run it whole.

    ``axes``: the weight's logical (out, in) axis names — the
    ``distributed.sharding.LINEAR_AXES`` entry for this linear's tag.
    Candidate mesh axes come from the activation table of the selected
    ``rules`` set (heads / kvheads / mlp / vocab / ... -> 'model'), the
    batch axis from its 'batch' rule ('pod' x 'data' — empty under
    'serve_tp', which therefore never batch-shards); a candidate is taken
    only when the dim divides and (for k) the packed storage stays
    shard-aligned.

    ``pipeline_chunks``/``collective_impl`` request the pipelined
    contraction: the request is clamped, never rejected — the chunk count
    drops to the largest value that divides the local k slice and keeps
    every packed-storage view whole per chunk, and both knobs normalize
    to the one-shot defaults for anything that is not k-sharded.  Every
    downgrade (and the reduce_scatter->psum fallback when m does not
    divide the k axis) bumps ``dispatch_shard_collective_fallback_total``.

    Adaptive-d specs never shard: ``resolve_d`` keys off the global
    (in, out) dims the weights were quantized with.
    """
    if mesh is None or axes is None or len(axes) != 2:
        return None
    if spec.mode != "bf16" and spec.d == "adaptive":
        return None
    out_ax, in_ax = axes
    act_rules = shd.RULE_SETS[rules][0]
    sizes = compat.axes_of(mesh)
    mesh_axes = tuple(sizes.items())
    used: set[str] = set()

    def pick(logical, dim, *, need_alignment: bool):
        for cand in act_rules.get(logical, ()):
            size = sizes.get(cand, 1)
            if size == 1 or cand in used or dim % size:
                continue
            if need_alignment and not _quant_aligned(spec, dim // size):
                continue
            used.add(cand)
            return cand
        return None

    m_axis = pick(out_ax, m, need_alignment=False)
    k_axis = None
    if m_axis is None:
        k_axis = pick(in_ax, k, need_alignment=True)
    if k_axis is not None and collective == "reduce_scatter" \
            and m % sizes[k_axis]:
        collective = "psum"  # cannot scatter the output rows: fall back
        _collective_fallback("reduce_scatter_to_psum", axis=k_axis)
    pc, impl = 1, "xla"
    if k_axis is not None:
        impl = collective_impl if collective_impl in COLLECTIVE_IMPLS \
            else "xla"
        want = max(int(pipeline_chunks), 1)
        pc = want
        k_local = k // sizes[k_axis]
        while pc > 1 and (k_local % pc
                          or not _quant_aligned(spec, k_local // pc)):
            pc -= 1
        if pc != want:
            _collective_fallback("pipeline_chunks_clamped", axis=k_axis,
                                 requested=want, clamped=pc)
    lead = batch if lead_batch is None else lead_batch
    b_axis = None
    for cand in act_rules.get("batch", ()):
        size = sizes.get(cand, 1)
        if size == 1 or cand in used:
            continue
        if lead % size == 0 and batch % size == 0:
            b_axis = cand
            break
    if m_axis is None and k_axis is None and b_axis is None:
        return None
    return ShardSpec(mesh_axes=mesh_axes, m=m_axis, k=k_axis, batch=b_axis,
                     collective=collective, pipeline_chunks=pc,
                     collective_impl=impl)


# -------------------------------------------------------------- placement
def _param_specs(params: dict, s: ShardSpec) -> dict:
    """Per-leaf specs of a linear's param dict.  All weight views share
    (m, k) orientation — their packed second dims split cleanly because
    shard_spec_for guarded the alignment; the codebook (16,) value table
    is replicated."""
    return {name: ((None,) * leaf.dim() if name == "codebook"
                   else (s.m, s.k))
            for name, leaf in params.items()}


def shard_linear(spec, axes, params: dict, m: int, k: int, mesh, *,
                 rules: str = "serve") -> dict:
    """This rank's leaves of a linear whose whole leaves are ``params``
    (global dims m, k): cut by the m / k layout ``shard_spec_for``
    derives (the batch axis does not depend on the weights), copied so
    the whole leaves can be freed; the leaves themselves when the linear
    runs unsharded."""
    s = shard_spec_for(spec, axes, m, k, 1, mesh, rules=rules)
    if s is None or (s.m is None and s.k is None):
        return params
    specs = _param_specs(params, s)
    return {name: shd.local_slice(leaf, specs[name], mesh).contiguous()
            .clone() for name, leaf in params.items()}


# -------------------------------------------------------------- execution
class _Done:
    def __init__(self, y):
        self.y = y

    def wait(self):
        return self.y


def run_sharded(backend, spec, plan, params: dict, x, *, k: int, m: int,
                mesh, epilogue=None, bias=None, residual=None,
                fuse: bool = False, keep_local: bool = False,
                x_local: bool = False, seq_axis: str | None = None):
    """Run one planned linear on this rank's shard.

    ``params`` are this rank's leaves (:func:`shard_linear`), ``x`` whole
    along k (its batch rows this rank's when the step's rows are split),
    or with ``x_local`` (a row-parallel plan only) already this rank's k
    slice; ``bias`` (m,) and ``residual`` (..., m) whole.  The backend sees
    local shapes — exactly the shapes ``dispatch.plan`` planned tiles
    for.  With a k-sharded (row-parallel) linear the epilogue runs once
    after the contraction collective; otherwise it fuses into the
    kernel's writeback per shard (disjoint m rows) whenever the backend
    can.

    A pipelined plan (``pipeline_chunks > 1``) splits the local
    contraction into k-chunks (``kernels.ops.k_chunk_params``): chunk
    i's collective is issued before chunk i+1's compute, and its result
    is folded in only after that compute was issued (the group's
    all-reduce runs asynchronously meanwhile; ring hops are sequential).

    The output comes back whole along m: a reduce-scattered result is
    gathered over its axis, and so is a column-parallel one unless
    ``keep_local`` asks for this rank's block of it.  ``seq_axis`` (a
    row-parallel plan over that axis only): the partial sums are
    reduce-scattered over the positions (dim -2 of a (B, S, k) ``x``,
    ``collectives.SEQ_OUT``) instead, and ``residual`` is this rank's
    block of them, the residual stream's layout between blocks.
    """
    s = plan.shard
    sizes = compat.axes_of(mesh)
    if tuple(sizes.items()) != tuple(s.mesh_axes):
        raise ValueError(
            f"plan was sharded for mesh {dict(s.mesh_axes)} but the active "
            f"mesh is {sizes}; re-plan under the current mesh")
    k_local = k // s.axis_size(s.k)
    pc = s.pipeline_chunks if s.k else 1
    k_chunk = k_local // pc
    inner_plan = dataclasses.replace(plan, shard=None)
    # the m dim of y / bias / residual: m-sharded linears keep their own
    # axis; reduce_scatter hands the k axis over; psum leaves it whole
    if seq_axis is not None and s.k != seq_axis:
        raise ValueError(f"positions over {seq_axis!r} need a contraction "
                         f"over it, not the plan's k={s.k!r}")
    out_m = s.m if s.k is None else (
        s.k if s.collective == "reduce_scatter" and seq_axis is None
        else None)
    m_local = m // s.axis_size(out_m)
    lead = next(iter(params.values()))
    if s.m is not None and lead.shape[0] != m_local:
        raise ValueError(f"linear leaves of {lead.shape[0]} rows are not "
                         f"this rank's {m_local} of {m} (shard_linear)")
    rank_k = shd.coord(mesh, s.k) if s.k else 0
    rank_m = shd.coord(mesh, out_m) if out_m else 0
    if x_local and (s.k is None or x.shape[-1] != k_local):
        raise ValueError(f"x of {x.shape[-1]} columns is not this rank's "
                         f"{k_local} of a row-parallel k={k}")
    x_l = x.narrow(-1, rank_k * k_local, k_local) \
        if s.k and not x_local else x
    b_l = bias.narrow(0, rank_m * m_local, m_local) \
        if out_m and bias is not None else bias
    r_l = residual.narrow(-1, rank_m * m_local, m_local) \
        if out_m and residual is not None else residual

    # trace attribution: compute vs contraction collective, named by the
    # shard layout (once a rank, once a chunk when pipelined)
    tagname = s.tag()
    mk_compute = f"shard.compute.{tagname}.k{k_chunk}"
    mk_coll = f"shard.collective.{s.collective}.{tagname}"

    def compute_chunk(p_c, x_c, **ep):
        x_c = obs.mark_begin(x_c, mk_compute)
        y = backend.run(spec, inner_plan, p_c, x_c, k=x_c.shape[-1], **ep)
        return obs.mark_end(y, mk_compute, cat="shard",
                            hist="shard_compute_s",
                            hist_labels={"tag": tagname})

    # a row-parallel linear's partial sums cross the collective in f32
    # (a kernel writes them so), and are cast once, after the epilogue
    out_dtype = (torch_dtype(epilogue.out_dtype) if epilogue is not None
                 and epilogue.out_dtype else x.dtype)
    f32 = Epilogue(out_dtype="float32")

    def partial(p_c, x_c):
        if x_c.dtype == torch.float32:
            return compute_chunk(p_c, x_c)
        if backend.epilogue_ok(f32) and inner_plan.epilogue:
            return compute_chunk(p_c, x_c, epilogue=f32)
        return compute_chunk(p_c, x_c).to(torch.float32)

    def issue(y):
        """Start the planned collective over the k-sharded partials: an
        all-reduce in flight, or the finished scatter / ring."""
        y = obs.mark_begin(y, mk_coll)
        if seq_axis is not None:
            if s.collective_impl == "ring":
                return _Done(coll.ring_reduce_scatter(y, s.k, dim=-2,
                                                      mesh=mesh))
            return _Done(coll.psum_scatter(y, s.k, dim=-2, mesh=mesh,
                                           kind=coll.SEQ_OUT))
        if s.collective == "reduce_scatter":
            fn = (coll.ring_reduce_scatter if s.collective_impl == "ring"
                  else coll.psum_scatter)
            return _Done(fn(y, s.k, dim=-1, mesh=mesh))
        if s.collective_impl == "ring":
            return _Done(coll.ring_psum(y, s.k, mesh=mesh))
        return coll.psum_async(y, s.k, mesh=mesh)

    def retire(pending):
        return obs.mark_end(pending.wait(), mk_coll, cat="shard",
                            hist="shard_collective_s",
                            hist_labels={"collective": s.collective,
                                         "axis": s.k,
                                         "impl": s.collective_impl})

    if s.k is None and fuse:
        y = compute_chunk(params, x_l, epilogue=epilogue, bias=b_l,
                          residual=r_l)
    elif s.k is None:
        y = apply_epilogue(compute_chunk(params, x_l), epilogue, bias=b_l,
                           residual=r_l)
    # row-parallel: partial sums over the local k slice; the epilogue
    # must see the resolved sum, never the per-shard partials
    elif pc == 1:
        y = apply_epilogue(retire(issue(partial(params, x_l))),
                           epilogue, bias=b_l, residual=r_l).to(out_dtype)
    else:
        d_pack = 1 if spec.mode == "bf16" else int(spec.d)
        sb_pack = 1 if spec.mode == "bf16" else int(spec.scale_block)
        p_chunks = kops.k_chunk_params(params, k=k_local, chunks=pc,
                                       d=d_pack, scale_block=sb_pack)
        x_chunks = x_l.split(k_chunk, dim=-1)
        out = None      # partials whose collective has been retired
        pending = None  # the chunk whose collective is in flight
        for ci in range(pc):
            p_c = {n: t.contiguous() for n, t in p_chunks[ci].items()}
            y_c = partial(p_c, x_chunks[ci].contiguous())
            if pending is not None:
                # retire the previous chunk only after this chunk's
                # compute was issued
                done = retire(pending)
                out = done if out is None else out + done
            pending = issue(y_c)
        done = retire(pending)
        y = done if out is None else out + done
        y = apply_epilogue(y, epilogue, bias=b_l,
                           residual=r_l).to(out_dtype)
    if out_m is not None and not (keep_local and s.k is None):
        y = coll.all_gather(y, out_m, dim=-1, mesh=mesh)
    return y
