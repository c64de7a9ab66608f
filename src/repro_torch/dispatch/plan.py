"""ExecPlan / ExecPolicy — the physical half of a quantized linear; port of
repro.dispatch.plan.

``plan(spec, m, k, batch) -> ExecPlan`` answers "how should THIS shape
run on THIS device": which registered backend, and which Hopper tiles.
Under an active mesh (``distributed.sharding.use``) a linear that names
its logical axes (``shard_axes``) gets a ShardSpec
(``dispatch.shard.shard_spec_for``), and its tiles, cache key and
tuning are those of one rank's kernel shape (``ShardSpec.exec_mkb``),
keyed by the shard tag.  With ``ExecPolicy.shard_pipeline=0`` a
row-parallel linear derives its one-shot layout first, then replays the
collective layout the shard-variant tuner cached for that key.
Plans come from three sources, in precedence order:

1. an explicit ``ExecPolicy.plan`` override (tests, power users);
2. the persistent autotune cache (shape-keyed winners measured by
   ``repro_torch.dispatch.autotune`` and stored as JSON, so a warm
   restart tunes nothing again);
3. the shape heuristic (``kernels.ops`` tile pickers), when the policy
   does not ask to autotune a key the cache lacks.

The reference's ``tm/tj/tb``, ``acc_in_vmem``, ``interpret`` and
``consume_chunk`` are TPU or jnp knobs with no Hopper counterpart; an
``ExecPlan`` carries the kernels' own tiles (``Tiles`` for msGeMM,
``Int4Tiles`` for the int4 GeMM) in their place.

The reference resolves plans while ``jax.jit`` traces, once per step
shape.  The port's eager route calls ``execute() -> plan()`` for every
GeMM of every step, so resolved plans are memoized per (spec, m, k,
batch, device, policy): a memo hit is one dict lookup and counts as no
resolution, so ``dispatch_backend_selected_total`` and
``dispatch_plan_cache_total`` count once per key and process (the
reference's once per trace).  The memo is dropped whenever the plan
cache or the quarantine changes.  The counterpart of the reference's
"never tune inside a trace" is "never tune while a CUDA graph is being
captured": there ``plan()`` only reads the cache or takes the heuristic.
"""

from __future__ import annotations

import contextlib
import functools
import math
from dataclasses import dataclass, field, replace
from typing import NamedTuple

import torch

from repro_torch import obs
from repro_torch.core.spec import QuantSpec
from repro_torch.dispatch import registry
from repro_torch.dispatch.shard import (
    COLLECTIVE_IMPLS, COLLECTIVES, mesh_tag, plan_shard_tag, shard_spec_for,
)
from repro_torch.distributed.sharding import active_mesh, active_rules
from repro_torch.kernels import ops
from repro_torch.kernels.int4_matmul import Int4Tiles
from repro_torch.kernels.msgemm import Tiles

# both kernels accumulate in f32: the only accumulation the port offers
ACC_DTYPES = ("float32",)


@dataclass(frozen=True)
class ExecPlan:
    """A frozen, hashable physical execution choice.

    backend : registered backend name (``repro_torch.dispatch.registry``).
    tiles : the msGeMM kernel's ``Tiles`` or the int4 kernel's
        ``Int4Tiles`` (None: the kernel wrapper's heuristic).
    epilogue : allow fusing a requested Epilogue into the kernel's
        writeback when the backend accepts it; False runs the same ops
        after the GeMM.
    shard : the linear's layout on the active mesh
        (``dispatch.shard.ShardSpec``), derived at plan time and never
        persisted; None off-mesh or for a linear that runs whole.
    source : provenance, 'heuristic' | 'autotuned' | 'explicit';
        metadata only, excluded from equality and hash.
    """

    backend: str
    tiles: Tiles | Int4Tiles | None = None
    epilogue: bool = True
    shard: object = None
    source: str = field(default="heuristic", compare=False)


@dataclass(frozen=True)
class ExecPolicy:
    """Preferences that steer planning without naming exact tiles.

    backend : force a registered backend by name (None: auto-selection
        by capability and priority); a spec it cannot run, or a
        quarantined backend, falls back to auto-selection.
    autotune : time candidate tiles for keys the plan cache lacks and
        persist the winners.  True prunes the sweep with the calibrated
        perf model when a calibration of this partition exists (the full
        sweep otherwise); 'full' times every candidate; 'model' asks for
        the pruned sweep.  False tunes nothing.
    acc_dtype : accumulation type, part of the cache key; only float32.
    plan : an explicit ExecPlan (skips planning entirely).
    shard_collective : how row-parallel linears resolve their partial
        sums under a mesh: 'psum' | 'reduce_scatter'.
    shard_pipeline : contraction chunks of a row-parallel linear (1: one
        collective a linear); 0: the layout the shard-variant tuner
        chose for the key (``dispatch.autotune.tune_shard_variants``,
        run by ``warm``), the one-shot layout where the cache has none.
    shard_impl : the collective's implementation: 'xla' (the group's
        own) | 'ring' (point-to-point hops).
    """

    backend: str | None = None
    autotune: bool | str = False
    acc_dtype: str = "float32"
    plan: ExecPlan | None = None
    shard_collective: str = "psum"
    shard_pipeline: int = 1
    shard_impl: str = "xla"

    def __post_init__(self):
        if self.shard_collective not in COLLECTIVES:
            raise ValueError(f"shard_collective={self.shard_collective!r} "
                             f"must be one of {COLLECTIVES}")
        if self.shard_impl not in COLLECTIVE_IMPLS:
            raise ValueError(f"shard_impl={self.shard_impl!r} must be one "
                             f"of {COLLECTIVE_IMPLS}")
        if int(self.shard_pipeline) < 0:
            raise ValueError(f"shard_pipeline={self.shard_pipeline} must "
                             "be >= 0 (0: the tuned variant)")
        if self.acc_dtype not in ACC_DTYPES:
            raise ValueError(f"acc_dtype={self.acc_dtype!r} must be one of "
                             f"{ACC_DTYPES}: both kernels accumulate in f32")
        if self.autotune not in (False, True, "model", "full"):
            raise ValueError(f"autotune={self.autotune!r} must be one of "
                             f"False, True, 'model', 'full'")

    @property
    def search(self) -> str:
        """The autotuner's sweep for this policy."""
        return self.autotune if self.autotune in ("model", "full") \
            else "auto"


DEFAULT_POLICY = ExecPolicy()
_default_policy: ExecPolicy = DEFAULT_POLICY


def set_default_policy(policy: ExecPolicy | None) -> None:
    """Install the process-wide default ExecPolicy (None resets).  The
    serve CLI's --backend/--autotune land here, so the choice reaches
    every linear without a new argument through the model."""
    global _default_policy
    _default_policy = policy or DEFAULT_POLICY


def get_default_policy() -> ExecPolicy:
    return _default_policy


@contextlib.contextmanager
def using_policy(policy: ExecPolicy | None):
    """Scoped default policy (None: leave the current one)."""
    if policy is None:
        yield
        return
    prev = _default_policy
    set_default_policy(policy)
    try:
        yield
    finally:
        set_default_policy(prev)


# ------------------------------------------------------- plan collection
class PlanRequest(NamedTuple):
    """One collected plan() call; ``warm`` resolves it to exactly the
    plan the later call will ask for.  m, k and batch are the kernel's
    shape: one rank's under a ShardSpec (``shard``, keyed by ``tag``)."""

    spec: QuantSpec
    m: int
    k: int
    batch: int
    backend: str
    device_type: str = "cuda"
    experts: int = 0  # the stack's E; 0 for one linear
    shard: object = None
    tag: str = "-"


_collector: list | None = None


@contextlib.contextmanager
def collecting():
    """Record every plan request made while active; each returns the
    heuristic plan, tunes nothing and counts nothing.  The engine runs
    one idle step of each shape under this to enumerate the (spec, m, k,
    batch) keys its steps will request, then warms them, before it
    captures anything."""
    global _collector
    prev, _collector = _collector, []
    try:
        yield _collector
    finally:
        _collector = prev


def _capturing() -> bool:
    """True while the current CUDA stream is being captured into a graph:
    timing a candidate there would record it into the graph instead."""
    try:
        return torch.cuda.is_current_stream_capturing()
    except RuntimeError:  # a build of torch without CUDA
        return False


# ---------------------------------------------------------------- keys
def plan_d(spec: QuantSpec, m: int, k: int) -> int:
    """The resolved LUT depth for msgemm, the declared d otherwise (0 for
    an adaptive non-msgemm spec)."""
    if spec.mode == "msgemm":
        return spec.resolve_d(k, m)
    return int(spec.d) if isinstance(spec.d, int) else 0


@functools.lru_cache(maxsize=None)
def device_name(device_type: str) -> str:
    """The device field of plan keys and calibrations: ``cuda:<the card's
    name>`` (a plan measured on one card is never served on another), or
    the device type itself (``cpu``; ``cuda`` where no card is present)."""
    if device_type == "cuda" and torch.cuda.is_available():
        return f"cuda:{torch.cuda.get_device_name()}"
    return device_type


def plan_key(backend: str, spec: QuantSpec, d: int, m: int, k: int,
             batch: int, device: str, acc_dtype: str = "float32",
             shard: str = "-", experts: int = 0) -> str:
    """Shape key of the persistent plan cache, in the reference's field
    order.  ``device`` is :func:`device_name`'s; ``shard`` is the mesh /
    shard tag (``dispatch.shard.plan_shard_tag``: '-' off-mesh), and a
    sharded key's m, k and batch are one rank's kernel shape, so a plan
    measured on one device is never replayed sharded, nor the reverse.
    An expert stack (``experts`` E > 0: m, k and batch are one expert's)
    appends ``|e{E}``; a single linear's key is the reference's."""
    return (f"{device}|{backend}|{spec.mode}|d{d}|sb{spec.scale_block}|"
            f"{spec.storage}|cb{spec.codebook}|m{m}|k{k}|b{batch}|"
            f"acc{acc_dtype}|sh{shard}"
            + (f"|e{experts}" if experts else ""))


# ------------------------------------------------------------ heuristics
def heuristic_plan(spec: QuantSpec, d: int, m: int, k: int, batch: int,
                   backend: str, experts: int = 0) -> ExecPlan:
    """The shape heuristic's tiles (``ops.msgemm_tiles``,
    ``ops.int4_tiles``) as an explicit plan."""
    if backend == "msgemm_cuda":
        return ExecPlan(backend=backend, tiles=ops.msgemm_tiles(
            m, math.ceil(k / d), batch, d, spec.scale_block))
    if backend == "int4_cuda":
        return ExecPlan(backend=backend, tiles=ops.int4_tiles(
            m, k, batch, max(experts, 1)))
    return ExecPlan(backend=backend)


# ------------------------------------------------------------------ plan
_memo: dict[tuple, ExecPlan] = {}


def invalidate() -> None:
    """Drop every memoized plan (the plan cache or the quarantine
    changed)."""
    _memo.clear()


def select(spec: QuantSpec, d: int, device_type: str,
           policy: ExecPolicy) -> registry.Backend:
    """The backend a policy resolves to: the forced one when it can run
    the spec and is not quarantined, else auto-selection."""
    if policy.backend is not None:
        forced = registry.get_backend(policy.backend)
        if forced.supports(spec, d) and not registry.is_quarantined(
                forced.name):
            return forced
    return registry.select_backend(spec, d, device_type)


def _shard_of(spec: QuantSpec, m: int, k: int, batch: int, policy,
              shard_axes, lead_batch, variant: tuple | None = None):
    """(ShardSpec or None, tag) of a linear under the active mesh.  With
    ``shard_pipeline`` 0 the one-shot layout, or ``variant`` ((chunks,
    impl), the tuned one) when given."""
    mesh = active_mesh()
    pc, impl = policy.shard_pipeline, policy.shard_impl
    if pc == 0:
        pc, impl = variant or (1, "xla")
    shard = shard_spec_for(spec, shard_axes, m, k, batch, mesh,
                           lead_batch=lead_batch,
                           collective=policy.shard_collective,
                           rules=active_rules(), pipeline_chunks=pc,
                           collective_impl=impl)
    if shard is not None and not shard.is_sharded:
        shard = None
    return shard, plan_shard_tag(shard, mesh)


def plan(spec: QuantSpec, m: int, k: int, batch: int = 1, *,
         device_type: str = "cuda", policy: ExecPolicy | None = None,
         experts: int = 0, shard_axes: tuple | None = None,
         lead_batch: int | None = None) -> ExecPlan:
    """Resolve the execution of one (spec, shape) on ``device_type``
    (m, k: the linear's out and in dims; batch: the flattened rows;
    experts: the E of an expert stack, whose m, k and batch are one
    expert's, 0 for one linear).

    ``shard_axes``: the weight's logical (out, in) axis names (the
    ``distributed.sharding.LINEAR_AXES`` entry of its tag).  Under an
    active mesh they derive the plan's ShardSpec; m, k and batch stay the
    linear's whole dims and the batch its whole rows (``lead_batch``: the
    activations' leading dim, what the batch axis shards; defaults to
    ``batch``), while tiles, cache key and tuning take the local kernel
    shape."""
    policy = policy or _default_policy
    if policy.plan is not None:
        return policy.plan
    amesh = active_mesh()
    mesh = amesh if shard_axes is not None else None
    if _collector is None:
        key = (spec, m, k, batch, device_type, policy, experts)
        if amesh is not None:
            key += (shard_axes, lead_batch, mesh_tag(amesh), active_rules())
        hit = _memo.get(key)
        if hit is not None:
            return hit
    d = plan_d(spec, m, k)
    be = select(spec, d, device_type, policy)
    shard, tag = None, "-"
    if mesh is not None:
        shard, tag = _shard_of(spec, m, k, batch, policy, shard_axes,
                               lead_batch)
    elif amesh is not None:
        tag = mesh_tag(amesh)
    lm, lk, lb = shard.exec_mkb(m, k, batch) if shard else (m, k, batch)
    if _collector is not None:
        # collection is a dry run: no resolution, nothing counted
        _collector.append(PlanRequest(spec, lm, lk, lb, be.name,
                                      device_type, experts, shard, tag))
        return replace(heuristic_plan(spec, d, lm, lk, lb, be.name,
                                      experts), shard=shard)

    reg = obs.registry()
    reg.counter("dispatch_backend_selected_total",
                help="plan resolutions per backend", backend=be.name).inc()
    from repro_torch.dispatch import autotune as at

    device = device_name(device_type)
    if policy.shard_pipeline == 0 and shard is not None \
            and shard.k is not None:
        # the tuned layout of the one-shot key, when the cache has one
        var = at.cache().shard_variant(plan_key(
            be.name, spec, d, lm, lk, lb, device, policy.acc_dtype, tag))
        if var is not None:
            shard, tag = _shard_of(
                spec, m, k, batch, policy, shard_axes, lead_batch,
                (int(var["pipeline_chunks"]), str(var["collective_impl"])))
            lm, lk, lb = shard.exec_mkb(m, k, batch)
    cached = at.cache().get(plan_key(be.name, spec, d, lm, lk, lb, device,
                                     policy.acc_dtype, tag,
                                     experts=experts))
    reg.counter("dispatch_plan_cache_total",
                help="persistent plan-cache lookups",
                result="hit" if cached is not None else "miss").inc()
    if cached is not None:
        p = cached
    elif policy.autotune and be.tunable and not _capturing():
        p = at.autotune(spec, lm, lk, lb, be.name, device_type=device_type,
                        acc_dtype=policy.acc_dtype, search=policy.search,
                        experts=experts, tag=tag, mesh=amesh)
    else:
        p = heuristic_plan(spec, d, lm, lk, lb, be.name, experts)
        if policy.autotune and be.tunable:
            return replace(p, shard=shard)  # a capture kept it from
            # tuning: resolve again later
    p = replace(p, shard=shard)
    _memo[key] = p
    return p
