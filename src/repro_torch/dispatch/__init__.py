"""repro_torch.dispatch — GeMM execution behind a stable front end; port of
repro.dispatch (registry, plans, the plan cache and autotuner,
``execute``).

``QuantSpec`` says what the weights are; the registry holds the execution
paths; ``plan()`` maps (spec, m, k, batch, device) to a frozen
:class:`ExecPlan` from an explicit plan, the persistent autotune cache,
the autotuner or the shape heuristic (``dispatch.plan``);
``execute()`` runs one linear through it under the process's default
:class:`ExecPolicy` (``using_policy``).  Under an active mesh
(``distributed.sharding.use``) a linear that names its logical axes runs
sharded (``dispatch.shard.run_sharded``) on this rank's leaves.

Each ``execute`` reports through ``repro_torch.obs`` under the reference's
names: ``dispatch_epilogue_total{fused}`` once per call that carries a
non-identity epilogue (the reference counts once per traced call site;
here that is once per eager call and once per CUDA graph capture), and a
device mark ``gemm.<backend>.m<m>.k<k>.b<b>`` around the backend call,
observed into ``kernel_gemm_s`` when tracing is on, its labels naming
the plan's tiles as well (``obs.perfmodel`` prices the sample at them).
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch import obs
from repro_torch.core.epilogue import Epilogue, apply_epilogue
from repro_torch.core.spec import QuantSpec
from repro_torch.dispatch.registry import (  # noqa: F401
    Backend, available_backends, backend_names, clear_quarantine,
    device_kind, get_backend, is_quarantined, quarantine_backend,
    quarantined, register_backend, select_backend, unregister_backend,
)
from repro_torch.dispatch.plan import (  # noqa: F401
    DEFAULT_POLICY, ExecPlan, ExecPolicy, PlanRequest, collecting,
    device_name, get_default_policy, heuristic_plan, plan, plan_d, plan_key,
    set_default_policy, using_policy,
)
from repro_torch.dispatch import backends as _backends  # noqa: F401 (registers)
from repro_torch.dispatch import shard  # noqa: F401
from repro_torch.distributed import sharding
from repro_torch.dispatch.shard import (  # noqa: F401
    ShardSpec, mesh_tag, plan_shard_tag, shard_spec_for,
)
# the tuner function lives at dispatch.autotune.autotune: the bare name is
# not re-exported, so the ``autotune`` submodule stays addressable
from repro_torch.dispatch.autotune import (  # noqa: F401
    PlanCache, cache, default_cache_path, set_cache_path, warm,
)


def tiles_label(tiles) -> str:
    """A plan's tiles as one label value (``-`` for none), e.g.
    ``tb=4,rows=1024,stage=8,tj=96``; ``obs.perfmodel`` parses it back."""
    if tiles is None:
        return "-"
    return ",".join(f"{f}={v}" for f, v in tiles._asdict().items())


def _infer_k(params: dict, spec: QuantSpec) -> int:
    if spec.mode == "bf16":
        return params["w"].shape[-1]
    if spec.storage == "packed_u8":
        return params["u8"].shape[-1] * 2
    if spec.d != "adaptive":
        return params["idx"].shape[-1] * int(spec.d)
    raise ValueError(
        "cannot infer the input dim of an adaptive-d 'packed_idx' linear "
        "from its params; pass in_dim explicitly")


def execute(params: dict, x, spec: QuantSpec, *, in_dim: int | None = None,
            plan_override: ExecPlan | None = None,
            policy: ExecPolicy | None = None,
            epilogue: Epilogue | None = None, bias=None, residual=None,
            shard_axes: tuple | None = None, out_dim: int | None = None,
            keep_local: bool = False, x_axis: str | None = None,
            seq_axis: str | None = None):
    """Run one linear ``x (..., k) -> y (..., m)`` through the registry.

    Execution choices: ``plan_override`` > ``policy`` > the process's
    default policy.  ``epilogue`` describes ``y = act(y + bias) +
    residual`` (then cast).  When the plan allows it (``plan.epilogue``)
    a backend that can fuses it (``msgemm_cuda``, ``int4_cuda``);
    otherwise the same ops run after the GeMM (``apply_epilogue``).
    ``bias`` is (m,); ``residual`` matches the output (..., m).

    An expert stack (the MoE block's linears: params with a leading
    expert axis E, x (E, ..., k)) plans per expert shape, its key
    carrying E (``plan_key``), and runs int4_dequant or bf16 weights;
    its epilogue takes no bias or residual.

    ``shard_axes`` (the weight's logical (out, in) axis names) makes the
    linear mesh-aware: under an active mesh its plan carries a ShardSpec
    and it runs on this rank's leaves (``params``, cut at build by
    ``dispatch.shard.shard_linear``; ``out_dim`` is then the whole m),
    one contraction collective and the epilogue after it
    (``dispatch.shard.run_sharded``).  ``batch`` counts the step's whole
    rows when they are split over the ranks (``sharding.split_rows``);
    whole rows are not batch-sharded.

    ``keep_local``: a column-parallel output comes back as this rank's
    block of m (whole otherwise).  ``x_axis``: ``x`` holds this rank's
    block of k over that mesh axis (a column-parallel output kept
    local); a plan that shards k over the same axis takes it as it is,
    any other gathers it whole first (one all-gather).  ``seq_axis``:
    the output comes back as this rank's block of its positions (dim -2
    of a (B, S, k) ``x``) over that mesh axis, ``residual`` being that
    block: a plan whose contraction splits over the same axis
    reduce-scatters its partial sums over the positions instead of
    summing them (``dispatch.shard.run_sharded``); any other computes the
    whole output and keeps the block, the residual added on it.
    """
    k = in_dim if in_dim is not None else _infer_k(params, spec)
    lead = params["w"] if spec.mode == "bf16" else params["scales"]
    m = out_dim if out_dim is not None else lead.shape[-2]
    experts = lead.shape[0] if lead.dim() == 3 else 0
    if experts:
        if spec.mode == "msgemm":
            raise ValueError("an expert stack runs int4_dequant or bf16 "
                             "weights, not msgemm (models.moe)")
        if x.ndim < 2 or x.shape[0] != experts:
            raise ValueError(f"x {tuple(x.shape)} does not lead with the "
                             f"stack's {experts} experts")
        batch = math.prod(x.shape[1:-1])
    else:
        batch = math.prod(x.shape[:-1]) if x.ndim > 1 else 1
    mesh = None
    if shard_axes is not None and not experts and x.ndim > 1:
        mesh = sharding.active_mesh()
    if mesh is not None:
        # the batch axis shards the rows only where they are split: the
        # engine's step (sharding.split_rows); whole rows derive none
        rows = sharding.rows_factor()
        p = plan_override or plan(spec, m, k, batch * rows,
                                  device_type=x.device.type, policy=policy,
                                  shard_axes=shard_axes,
                                  lead_batch=x.shape[0] * rows
                                  if rows > 1 else 1)
    else:
        p = plan_override or plan(spec, m, k, batch,
                                  device_type=x.device.type, policy=policy,
                                  experts=experts)
    if seq_axis is not None and not (
            mesh is not None and p.shard is not None
            and p.shard.is_sharded and p.shard.k == seq_axis):
        # no contraction collective over the positions' axis: the whole
        # output, then this rank's block of it, the residual added there
        tail = None
        if epilogue is not None and epilogue.residual:
            tail = Epilogue(residual=True, out_dtype=epilogue.out_dtype)
            epilogue = dataclasses.replace(epilogue, residual=False,
                                           out_dtype=None)
            epilogue = None if epilogue.is_identity else epilogue
        y = execute(params, x, spec, in_dim=in_dim, plan_override=p,
                    epilogue=epilogue, bias=bias, shard_axes=shard_axes,
                    out_dim=out_dim, keep_local=keep_local, x_axis=x_axis)
        lo, n = sharding.seq_block(y.shape[-2], seq_axis)
        return apply_epilogue(y.narrow(-2, lo, n), tail, residual=residual)
    be = get_backend(p.backend)
    d = plan_d(spec, m, k)
    if not be.supports(spec, d):
        raise ValueError(
            f"plan backend {be.name!r} cannot execute mode={spec.mode!r} "
            f"d={d} storage={spec.storage!r} codebook={spec.codebook!r}")
    # an array without its Epilogue flag would be silently ignored
    if bias is not None and (epilogue is None or not epilogue.bias):
        raise ValueError("bias array given but the epilogue does not "
                         "declare bias=True")
    if residual is not None and (epilogue is None or not epilogue.residual):
        raise ValueError("residual array given but the epilogue does not "
                         "declare residual=True")
    fuse = (epilogue is not None and not epilogue.is_identity
            and p.epilogue and be.epilogue_ok(epilogue))
    if epilogue is not None and not epilogue.is_identity:
        obs.registry().counter(
            "dispatch_epilogue_total",
            help="non-identity epilogues by fused/unfused execution",
            fused="true" if fuse else "false").inc()
    sharded = mesh is not None and p.shard is not None \
        and p.shard.is_sharded
    x_local = False
    if x_axis is not None:
        x_local = sharded and p.shard.k == x_axis
        if not x_local:  # this linear reads the whole row
            from repro_torch.distributed import collectives as coll

            x = coll.all_gather(x, x_axis, dim=-1)
    if sharded:
        return shard.run_sharded(be, spec, p, params, x, k=k, m=m,
                                 mesh=mesh, epilogue=epilogue, bias=bias,
                                 residual=residual, fuse=fuse,
                                 keep_local=keep_local, x_local=x_local,
                                 seq_axis=seq_axis)
    mark = f"gemm.{be.name}.m{m}.k{k}.b{batch}" + (
        f".e{experts}" if experts else "")
    x = obs.mark_begin(x, mark)
    if fuse:
        y = be.run(spec, p, params, x, k=k, epilogue=epilogue, bias=bias,
                   residual=residual)
    else:
        y = be.run(spec, p, params, x, k=k)
    if obs.tracer().enabled:
        labels = {"backend": be.name, "m": m, "k": k, "b": batch,
                  "mode": spec.mode, "d": d, "sb": spec.scale_block,
                  "tiles": tiles_label(p.tiles)}
        if experts:
            labels["e"] = experts
        y = obs.mark_end(y, mark, cat="gemm", hist="kernel_gemm_s",
                         hist_labels=labels)
    return y if fuse else apply_epilogue(y, epilogue, bias=bias,
                                         residual=residual)
