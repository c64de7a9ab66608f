"""Shape-keyed autotuner with a persistent JSON plan cache; port of
repro.dispatch.autotune.  Sharded plans key and tune on their local
shard shapes (``dispatch.plan``).  With ``ExecPolicy.shard_pipeline=0``
the shard-variant tuner (:func:`tune_shard_variants`) times each
row-parallel linear's collective layouts (:data:`SHARD_VARIANT_GRID`:
pipeline chunks x the group's own all-reduce or a ring) as whole
``dispatch.shard.run_sharded`` calls and keeps the winner in the cache's
``shard_variants`` table, from which ``dispatch.plan`` replays it.

On a mesh every rank is a process of its own and times its own calls,
while all of them must run one plan a key (unlike ones would issue
mismatched collectives).  So a candidate's time is the slowest rank's
(one maximum over the mesh of each rank's best times), every rank picks
the winner from those same numbers (ties: the first candidate), and
only the mesh's leader writes the cache file; this holds for the
kernel-tile winners too.

For a (spec, m, k, batch, backend, device) key the tuner times every
candidate tile choice of the Hopper kernel on synthetic data shaped
exactly like the real call, picks the fastest, and persists the winner,
so a serving process warm-starts from disk and never tunes a key it (or
an earlier process) has measured.

Cache location, first hit wins:

1. ``REPRO_PLAN_CACHE`` (a file path);
2. ``$XDG_CACHE_HOME/msgemm-repro-torch/plans.json``;
3. ``~/.cache/msgemm-repro-torch/plans.json``.

A directory of its own: the reference's TPU cache and the port's never
share a file.  The JSON is a version-3 ``{key: plan fields}`` map plus
per-key ``timings`` rows, CRC-stamped through ``obs.artifacts``; a
corrupt or newer file is quarantined aside and degrades to an empty
cache, never an exception on the serving path.  Tiles persist by field
name (``tb``, ``rows``, ``stage``, ``tj`` for msGeMM; ``tb``, ``tk``,
``nsplit`` for int4) and are rebuilt as their NamedTuple on load.

A tuned plan can change bits: ``tj`` and ``nsplit`` set the order in
which the kernels add their partial sums.  A kernel and its plain version
agree bit for bit at the same tiles, but two plans of one key may differ
in the last ulp, so paths whose tokens are compared resolve under one
policy and cache.

CLI::

    python -m repro_torch.dispatch --smoke --cache plans.json

tunes a tiny shape grid twice and asserts that the second pass, from the
reloaded file, times no candidate.
"""

from __future__ import annotations

import dataclasses
import math
import os
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.spec import QuantSpec
from repro_torch.dispatch import registry
from repro_torch.dispatch.plan import (
    ExecPlan, ExecPolicy, device_name, heuristic_plan, invalidate, plan_d,
    plan_key,
)
from repro_torch.kernels import ops
from repro_torch.kernels.int4_matmul import Int4Tiles
from repro_torch.kernels.msgemm import Tiles

_CACHE_VERSION = 3
_PLAN_FIELDS = ("backend", "epilogue")

# incremented per timed candidate (a reload must time none)
num_timed_candidates = 0

# how many predicted-best candidates the model-guided search measures
MODEL_TOP_K = 3
# candidates measured per key on the CPU, where the plain versions run
CPU_CANDIDATES = 6


def default_cache_path() -> Path:
    env = os.environ.get("REPRO_PLAN_CACHE")
    if env:
        return Path(env)
    base = os.environ.get("XDG_CACHE_HOME") or os.path.join(
        os.path.expanduser("~"), ".cache")
    return Path(base) / "msgemm-repro-torch" / "plans.json"


def tile_fields(tiles) -> dict:
    """A plan's tiles as the flat fields the cache and timing rows hold."""
    return {} if tiles is None else tiles._asdict()


def tiles_from(fields: dict):
    """The tile NamedTuple a cache entry or timing row names, or None."""
    if fields.get("rows") is not None:
        return Tiles(**{f: int(fields[f]) for f in Tiles._fields})
    if fields.get("nsplit") is not None:
        return Int4Tiles(**{f: int(fields[f]) for f in Int4Tiles._fields})
    return None


class PlanCache:
    """In-memory view of the persistent plan cache (lazy load)."""

    def __init__(self, path: str | os.PathLike | None = None):
        self.path = Path(path) if path is not None else default_cache_path()
        self._plans: dict[str, ExecPlan] = {}
        self._timings: dict[str, list] = {}
        self._variants: dict[str, dict] = {}
        self._loaded = False

    def load(self) -> "PlanCache":
        self._loaded = True
        from repro_torch.obs import artifacts

        raw = artifacts.load_json_checked(self.path, "plan_cache")
        if raw is None or raw.get("version") != _CACHE_VERSION:
            return self
        try:
            for key, fields in raw.get("plans", {}).items():
                self._plans[key] = ExecPlan(
                    backend=str(fields["backend"]),
                    tiles=tiles_from(fields),
                    epilogue=bool(fields.get("epilogue", True)),
                    source="autotuned")
            t = raw.get("timings")
            if isinstance(t, dict):
                self._timings.update(t)
            v = raw.get("shard_variants")
            if isinstance(v, dict):
                self._variants.update(v)
        except (KeyError, ValueError, TypeError, AttributeError):
            # parsed and CRC-clean but schema-invalid (e.g. hand-edited):
            # quarantine like any other corruption and start empty
            self._plans.clear()
            self._timings.clear()
            self._variants.clear()
            artifacts.quarantine(self.path, "plan_cache", reason="schema")
        return self

    def save(self) -> None:
        from repro_torch import faults
        from repro_torch.obs import artifacts

        payload = {"version": _CACHE_VERSION, "plans": {
            key: {**{f: getattr(p, f) for f in _PLAN_FIELDS},
                  **tile_fields(p.tiles)}
            for key, p in sorted(self._plans.items())}}
        if self._timings:
            payload["timings"] = {k: self._timings[k]
                                  for k in sorted(self._timings)}
        if self._variants:
            # additive table: a file without it loads as before
            payload["shard_variants"] = {k: self._variants[k]
                                         for k in sorted(self._variants)}
        artifacts.atomic_write_json(self.path, artifacts.stamp_crc(payload))
        ev = faults.fire("corrupt_plan_cache")
        if ev is not None:
            faults.corrupt_file(self.path, ev)

    def get(self, key: str) -> ExecPlan | None:
        if not self._loaded:
            self.load()
        return self._plans.get(key)

    def put(self, key: str, plan: ExecPlan, *, persist: bool = True,
            timings: list | None = None) -> None:
        if not self._loaded:
            self.load()
        self._plans[key] = plan
        if timings is not None:
            self._timings[key] = timings
        invalidate()
        if persist:
            self.save()

    def timings(self, key: str) -> list | None:
        """The candidate timing rows recorded when ``key`` was tuned."""
        if not self._loaded:
            self.load()
        return self._timings.get(key)

    def shard_variant(self, key: str) -> dict | None:
        """The tuned (pipeline_chunks, collective_impl) of a sharded key,
        or None."""
        if not self._loaded:
            self.load()
        return self._variants.get(key)

    def put_shard_variant(self, key: str, variant: dict, *,
                          persist: bool = True) -> None:
        if not self._loaded:
            self.load()
        self._variants[key] = dict(variant)
        invalidate()
        if persist:
            self.save()

    def variant_keys(self) -> list[str]:
        """The base keys of the ``shard_variants`` table, sorted."""
        if not self._loaded:
            self.load()
        return sorted(self._variants)

    def timing_keys(self) -> list[str]:
        if not self._loaded:
            self.load()
        return sorted(self._timings)

    def __len__(self) -> int:
        if not self._loaded:
            self.load()
        return len(self._plans)


_cache: PlanCache | None = None


def cache() -> PlanCache:
    global _cache
    if _cache is None:
        _cache = PlanCache()
    return _cache


def set_cache_path(path: str | os.PathLike | None) -> PlanCache:
    """Point the process at a specific cache file (None: the default)."""
    global _cache
    _cache = PlanCache(path)
    invalidate()
    return _cache


# ------------------------------------------------------------ candidates
def candidate_plans(spec: QuantSpec, d: int, m: int, k: int, batch: int,
                    backend: str, device_type: str = "cuda",
                    experts: int = 0) -> list[ExecPlan]:
    """The tile choices to time for one key, always with the heuristic's:
    ``ops.msgemm_variants`` (rows per block, the best splits of each) and
    ``ops.int4_variants`` (split counts), the variants ``chip_smoke.py
    --sweep`` times.  On the CPU, where the plain versions run, the first
    ``CPU_CANDIDATES`` only (the heuristic's kept).  An expert stack's
    (``experts`` E > 0) are ``ops.int4_variants`` of its batched grid."""
    base = heuristic_plan(spec, d, m, k, batch, backend, experts)
    if backend == "msgemm_cuda":
        tiles = ops.msgemm_variants(m, -(-k // d), batch, d,
                                    spec.scale_block)
    elif backend == "int4_cuda":
        tiles = ops.int4_variants(m, k, batch, max(experts, 1))
    else:
        return [base]
    out = list(dict.fromkeys([dataclasses.replace(base, tiles=t)
                              for t in tiles]))
    if device_type != "cuda":
        out = out[:CPU_CANDIDATES]
    if base not in out:
        out.append(base)
    return out


# ------------------------------------------------------------- synthetic
def _synthetic_call(spec: QuantSpec, d: int, m: int, k: int, batch: int,
                    device: torch.device, experts: int = 0):
    """(copies, x) shaped exactly like the real linear call, made with
    numpy from a fixed seed: codes, scales, and bf16 x (the engine's
    activations) on ``device``.  ``copies``: the params, and on the card
    copies of the weight past the L2 (``ops.copies_past_l2``), which a
    timed call cycles over as an engine step reads each layer's weights
    from HBM.  An expert stack repeats one expert's codes and scales E
    times (the kernel's time does not depend on the values)."""
    from repro_torch.core import packing

    rng = np.random.default_rng(0)
    codes = torch.from_numpy(
        rng.integers(0, 16, size=(m, k), dtype=np.uint8)).to(device)
    params = {"scales": torch.from_numpy(
        (np.abs(rng.standard_normal((m, -(-k // spec.scale_block))))
         + 0.1).astype(np.float32)).to(device)}
    if spec.storage == "packed_idx":
        params["idx"] = packing.pack_indices(codes, d).contiguous()
    else:
        params["u8"] = packing.pack_storage(codes).contiguous()
    lead = (experts,) if experts else ()
    if experts:
        params = {n: t.expand(experts, *t.shape).contiguous()
                  for n, t in params.items()}
    x = torch.from_numpy(rng.standard_normal((*lead, batch, k)).astype(
        np.float32)).to(device, torch.bfloat16)
    name = "idx" if "idx" in params else "u8"
    w = params[name]
    n = ops.copies_past_l2(w.numel() * w.element_size()) \
        if device.type == "cuda" else 1
    return [params] + [dict(params, **{name: w.clone()})
                       for _ in range(n - 1)], x


def _time_plan(backend: registry.Backend, spec: QuantSpec, p: ExecPlan,
               copies, x, k: int, reps: int) -> float:
    global num_timed_candidates
    num_timed_candidates += 1
    best = ops.time_call(
        [lambda c=c: backend.run(spec, p, c, x, k=k) for c in copies],
        x.device, reps)
    reg = obs.registry()
    reg.counter("dispatch_autotune_candidates_total",
                help="tile candidates measured",
                backend=backend.name).inc()
    reg.histogram("dispatch_autotune_candidate_s",
                  help="candidate time a call (device time of calls "
                       "back to back on the card, the best wall time on "
                       "the CPU)",
                  backend=backend.name).observe(best)
    return best


# ------------------------------------------------------- model pruning
def _model_prune(cands: list[ExecPlan], spec: QuantSpec, d: int, m: int,
                 k: int, batch: int, backend: str, base: ExecPlan,
                 calib) -> list[ExecPlan]:
    """Keep the ``MODEL_TOP_K`` candidates the calibrated perf model
    predicts fastest, the heuristic always among them, so model-guided
    tuning can only match or beat the heuristic."""
    from repro_torch.obs import perfmodel

    def pred(p: ExecPlan) -> float:
        feats = perfmodel.features(backend, spec.mode, max(d, 1),
                                   spec.scale_block, m, k, batch,
                                   tiles=p.tiles, interpret=calib.interpret)
        return perfmodel.predict_features(feats, calib,
                                          backend=backend).t_total_s

    keep = sorted(cands, key=pred)[:MODEL_TOP_K]
    if base not in keep:
        keep[-1] = base
    return keep


# ------------------------------------------------------ mesh agreement
def _mesh_max(values: list[float], mesh) -> list[float]:
    """Each of ``values`` maximized over every rank of ``mesh`` (host
    tensors over each axis in turn; not counted as the model's
    collectives)."""
    import torch.distributed as dist

    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed import compat

    t = torch.tensor(values, dtype=torch.float64)
    for axis in compat.axes_of(mesh):
        t = coll.psum_async(t, axis, mesh=mesh, op=dist.ReduceOp.MAX,
                            kind="").wait()
    return t.tolist()


def _writes(mesh) -> bool:
    """Whether this process writes the cache file: off a mesh, or as the
    mesh's leader (the ranks of a host share the file)."""
    from repro_torch.distributed import sharding

    return mesh is None or sharding.is_lead(mesh)


# -------------------------------------------------------------- autotune
def autotune(spec: QuantSpec, m: int, k: int, batch: int, backend: str, *,
             device_type: str = "cuda", acc_dtype: str = "float32",
             reps: int | None = None, persist: bool = True,
             search: str = "auto", experts: int = 0,
             tag: str = "-", mesh=None) -> ExecPlan:
    """Time the candidates of one key on ``device_type``; cache and return
    the winner (the cached plan at once when the key is known).  ``tag``:
    the key's shard field (``dispatch.shard.plan_shard_tag``; m, k and
    batch are then one rank's kernel shape).

    ``search``: 'full' times every candidate; 'model' and 'auto' time the
    ``MODEL_TOP_K`` the calibrated perf model ranks best, the heuristic
    among them, when a calibration of this partition (the card's name,
    or the CPU's plain versions) exists, and fall back to the full sweep
    otherwise (``dispatch_autotune_model_fallback_total``).  ``reps``:
    the calls timed (``ops.time_call``); by default on the card 20 or two
    a weight copy, whichever is more, as ``chip_smoke.py --sweep`` times
    the same variants, and the best of 2 on the CPU.  ``experts``: the E
    of an expert stack (m, k, batch one expert's); the calibrated model
    prices one linear, so its pruning ranks a stack's candidates by one
    expert's grid."""
    from repro_torch.obs import perfmodel

    device = device_name(device_type)
    be = registry.get_backend(backend)
    d = plan_d(spec, m, k)
    key = plan_key(backend, spec, d, m, k, batch, device, acc_dtype,
                   shard=tag, experts=experts)
    hit = cache().get(key)
    if hit is not None:
        return hit
    if not be.tunable:
        return heuristic_plan(spec, d, m, k, batch, backend, experts)
    cands = candidate_plans(spec, d, m, k, batch, backend, device_type,
                            experts)
    interpret = device_type != "cuda"  # the plain versions run
    pruned = 0
    if search in ("model", "auto") and len(cands) > MODEL_TOP_K:
        calib = perfmodel.load_calibration(device=device,
                                           interpret=interpret)
        reg = obs.registry()
        if calib is None:
            reg.counter("dispatch_autotune_model_fallback_total",
                        help="model-guided searches that fell back to "
                             "the full sweep (no matching calibration)",
                        backend=backend).inc()
        else:
            base = heuristic_plan(spec, d, m, k, batch, backend, experts)
            kept = _model_prune(cands, spec, d, m, k, batch, backend,
                                base, calib)
            pruned = len(cands) - len(kept)
            cands = kept
            reg.counter("dispatch_autotune_model_pruned_total",
                        help="candidates skipped by model-guided search",
                        backend=backend).inc(pruned)
    dev = torch.device(device_type)
    copies, x = _synthetic_call(spec, d, m, k, batch, dev, experts)
    if reps is None:
        reps = max(20, 2 * len(copies)) if dev.type == "cuda" else 2
    with obs.tracer().span("autotune", cat="dispatch", key=key,
                           candidates=len(cands), model_pruned=pruned):
        times = [_time_plan(be, spec, p, copies, x, k, reps)
                 for p in cands]
    del copies
    if mesh is not None:
        times = _mesh_max(times, mesh)
    timed = [(t, i, p) for i, (t, p) in enumerate(zip(times, cands))]
    best_s, best_i, winner = min(timed, key=lambda t: t[:2])
    winner = dataclasses.replace(winner, source="autotuned")
    # the candidates' timings ride along: they calibrate the perf model
    # (obs.perfmodel), tagged with the partition they were measured in
    rows = [{"s": t, **tile_fields(p.tiles), "winner": i == best_i,
             "interpret": interpret, "device": device}
            for t, i, p in sorted(timed, key=lambda t: t[:2])]
    cache().put(key, winner, persist=persist and _writes(mesh),
                timings=rows)
    return winner


# ------------------------------------------------ collective variants
# (pipeline_chunks, collective_impl) candidates timed for every
# row-parallel linear when ExecPolicy.shard_pipeline is 0; chunk counts
# that do not split the local contraction on the packed storage's
# boundaries are dropped for that linear
SHARD_VARIANT_GRID = ((1, "xla"), (1, "ring"), (2, "ring"), (4, "ring"),
                      (2, "xla"))


def _variant_prune(variants: list, shard, m: int, batch: int, device: str,
                   interpret: bool, search: str) -> list:
    """The variants to time: with a calibration of this partition that
    has a collective block, the ``MODEL_TOP_K`` that
    ``perfmodel.predict_collective`` ranks fastest, the one-shot (1,
    'xla') always among them; without one, all
    (``dispatch_autotune_model_fallback_total{backend="shard_variants"}``).
    """
    from repro_torch.distributed import collectives as coll
    from repro_torch.obs import perfmodel

    if search not in ("model", "auto") or len(variants) <= MODEL_TOP_K:
        return list(variants)
    calib = perfmodel.load_calibration(device=device, interpret=interpret)
    reg = obs.registry()
    if calib is None or not calib.collective:
        reg.counter("dispatch_autotune_model_fallback_total",
                    help="model-guided searches that fell back to "
                         "the full sweep (no matching calibration)",
                    backend="shard_variants").inc()
        return list(variants)
    n = shard.axis_size(shard.k)
    elems = m * (batch // shard.axis_size(shard.batch))

    def pred(v):
        pc, impl = v
        hops, nbytes = coll.collective_cost(
            impl=impl, collective=shard.collective, axis_size=n,
            elems=elems, pipeline_chunks=pc)
        return perfmodel.predict_collective(
            calls=pc, hops=hops, nbytes=nbytes, collective=calib.collective)

    keep = sorted(variants, key=pred)[:MODEL_TOP_K]
    if (1, "xla") not in keep:
        keep[-1] = (1, "xla")
    reg.counter("dispatch_autotune_model_pruned_total",
                help="candidates skipped by model-guided search",
                backend="shard_variants").inc(len(variants) - len(keep))
    return keep


def variant_grid(spec: QuantSpec, shard, k: int) -> list:
    """The :data:`SHARD_VARIANT_GRID` entries a row-parallel linear of
    whole in-dim ``k`` can run: a chunk count must split the local
    contraction on the packed storage's boundaries
    (``dispatch.shard._quant_aligned``)."""
    from repro_torch.dispatch.shard import _quant_aligned

    k_local = k // shard.axis_size(shard.k)
    return list(dict.fromkeys(
        (pc, impl) for pc, impl in SHARD_VARIANT_GRID
        if pc == 1 or (k_local % pc == 0
                       and _quant_aligned(spec, k_local // pc))))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def tune_shard_variants(spec: QuantSpec, m: int, k: int, batch: int,
                        backend: str, shard, mesh, *,
                        device_type: str = "cuda",
                        acc_dtype: str = "float32", reps: int | None = None,
                        persist: bool = True, search: str = "auto") -> dict:
    """Time the collective layouts of one row-parallel linear on ``mesh``
    (every rank calls it, with the same arguments) and cache the winner.

    ``m``, ``k`` and ``batch`` are the linear's whole dims and rows,
    ``shard`` its one-shot ShardSpec.  Each candidate of
    :func:`variant_grid` (pruned by :func:`_variant_prune`) re-shapes
    it, takes a kernel plan at its chunk shape (the cached winner, else
    the heuristic: tiles and layout tune apart), and a whole
    ``dispatch.shard.run_sharded`` call (its kernels at the chunk shapes
    and its collectives; no epilogue) on synthetic operands of this
    rank's shard is timed: once to warm, then ``reps`` times (default 5
    on the card, 2 on the CPU), each between a barrier of the mesh and
    the device's synchronization, on the host clock (a host-staged
    collective blocks the host inside the call, where device events
    would not time it).  Every rank runs every candidate the same number
    of times in the same order; a candidate's time is the slowest rank's
    best, so all ranks pick the same winner (ties: grid order).  Its
    (pipeline_chunks, collective_impl) goes into the ``shard_variants``
    table under the one-shot key, with every candidate's row (seconds,
    and ``collectives.collective_cost``'s hops and bytes: the data of
    ``perfmodel.fit_collective``); only the mesh's leader writes the
    file.  A key already in the table is returned at once."""
    global num_timed_candidates
    from repro_torch.distributed import collectives as coll
    from repro_torch.dispatch import shard as _shard

    device = device_name(device_type)
    base = dataclasses.replace(shard, pipeline_chunks=1,
                               collective_impl="xla")
    d = plan_d(spec, m, k)
    blm, blk, blb = base.exec_mkb(m, k, batch)
    base_key = plan_key(backend, spec, d, blm, blk, blb, device, acc_dtype,
                        shard=base.tag())
    hit = cache().shard_variant(base_key)
    if hit is not None:
        return hit
    cands = _variant_prune(variant_grid(spec, shard, k), shard, m, batch,
                           device, device_type != "cuda", search)
    be = registry.get_backend(backend)
    dev = torch.device(device_type)
    lb = batch // shard.axis_size(shard.batch)
    k_local = k // shard.axis_size(shard.k)
    copies, x = _synthetic_call(spec, d, m, k_local, lb, dev)
    params = copies[0]
    del copies
    if reps is None:
        reps = 5 if dev.type == "cuda" else 2
    n = shard.axis_size(shard.k)
    times = []
    with obs.tracer().span("autotune.shard_variants", cat="dispatch",
                           key=base_key, candidates=len(cands)):
        for pc, impl in cands:
            cand = dataclasses.replace(shard, pipeline_chunks=pc,
                                       collective_impl=impl)
            clm, clk, clb = cand.exec_mkb(m, k, batch)
            p = cache().get(plan_key(backend, spec, d, clm, clk, clb,
                                     device, acc_dtype, shard=cand.tag())
                            ) or heuristic_plan(spec, d, clm, clk, clb,
                                                backend)
            p = dataclasses.replace(p, shard=cand)

            def call():
                return _shard.run_sharded(be, spec, p, params, x, k=k, m=m,
                                          mesh=mesh, x_local=True)

            num_timed_candidates += 1
            call()  # warm
            _sync(dev)
            best = math.inf
            for _ in range(reps):
                _mesh_max([0.0], mesh)  # a barrier
                t0 = time.perf_counter()
                call()
                _sync(dev)
                best = min(best, time.perf_counter() - t0)
            times.append(best)
            obs.registry().counter(
                "dispatch_autotune_candidates_total",
                help="tile candidates measured",
                backend="shard_variants").inc()
    times = _mesh_max(times, mesh)
    rows = []
    for (pc, impl), t in zip(cands, times):
        hops, nbytes = coll.collective_cost(
            impl=impl, collective=shard.collective, axis_size=n,
            elems=m * lb, pipeline_chunks=pc)
        rows.append({"s": t, "pipeline_chunks": pc, "collective_impl": impl,
                     "hops": hops, "bytes": nbytes, "device": device,
                     "winner": False})
    best = min(range(len(rows)), key=lambda i: (rows[i]["s"], i))
    rows[best]["winner"] = True
    variant = {"pipeline_chunks": rows[best]["pipeline_chunks"],
               "collective_impl": rows[best]["collective_impl"],
               "rows": sorted(rows, key=lambda r: r["s"])}
    cache().put_shard_variant(base_key, variant,
                              persist=persist and _writes(mesh))
    return variant


def warm(requests, *, policy: ExecPolicy | None = None,
         persist: bool = True) -> dict[str, ExecPlan]:
    """Resolve a batch of collected plan requests up front (engine build).
    ``requests`` holds ``dispatch.plan.PlanRequest`` entries from
    ``dispatch.collecting()``.  With ``policy.autotune`` each tunable key
    is measured (its winner persisted); otherwise keys resolve to their
    cached winner, else to the heuristic, which is not written to the
    cache, so a later tuning run can still improve it.  A sharded
    request keys and tunes on its local kernel shape and its shard tag,
    and its plan carries the request's ShardSpec.

    Under an active mesh (every rank calls it on the same requests) the
    tuned winners are the mesh's (:func:`autotune`'s ``mesh``), and with
    ``policy.shard_pipeline == 0`` every row-parallel request's
    collective layout is tuned first (:func:`tune_shard_variants`, from
    its one-shot layout): the winner re-shapes the request, so its
    kernel plan is keyed and tuned at the winner's chunk shape, as
    ``dispatch.plan`` asks for it.  The variants are timed even with
    ``policy.autotune`` off (the kernel plans are then the cached or
    heuristic ones, so the comparison isolates the layout).  Returns
    {plan key: plan}."""
    from repro_torch.distributed.sharding import active_mesh

    policy = policy or ExecPolicy()
    mesh = active_mesh()
    out: dict[str, ExecPlan] = {}
    for req in dict.fromkeys(requests):
        shard, tag = req.shard, req.tag
        m, k, batch = req.m, req.k, req.batch
        if policy.shard_pipeline == 0 and mesh is not None \
                and shard is not None and shard.k is not None:
            gm = m * shard.axis_size(shard.m)
            gk = k * shard.axis_size(shard.k) * shard.pipeline_chunks
            gb = batch * shard.axis_size(shard.batch)
            var = tune_shard_variants(
                req.spec, gm, gk, gb, req.backend, shard, mesh,
                device_type=req.device_type, acc_dtype=policy.acc_dtype,
                persist=persist, search=policy.search)
            shard = dataclasses.replace(
                shard, pipeline_chunks=int(var["pipeline_chunks"]),
                collective_impl=str(var["collective_impl"]))
            tag = shard.tag()
            m, k, batch = shard.exec_mkb(gm, gk, gb)
        d = plan_d(req.spec, m, k)
        key = plan_key(req.backend, req.spec, d, m, k, batch,
                       device_name(req.device_type), policy.acc_dtype,
                       shard=tag, experts=req.experts)
        if policy.autotune and registry.get_backend(req.backend).tunable:
            p = autotune(req.spec, m, k, batch, req.backend,
                         device_type=req.device_type,
                         acc_dtype=policy.acc_dtype, persist=persist,
                         search=policy.search, experts=req.experts,
                         tag=tag, mesh=mesh)
        else:
            p = cache().get(key) or heuristic_plan(
                req.spec, d, m, k, batch, req.backend, req.experts)
        out[key] = dataclasses.replace(p, shard=shard)
    return out


# ------------------------------------------------------------------- CLI
SMOKE_SHAPES = [("msgemm", "msgemm_cuda", 2, 16, 24, 8),
                ("int4_dequant", "int4_cuda", 2, 16, 32, 8)]


def _smoke(cache_path: str | None, device_type: str) -> int:
    """Tiny tune: write the cache, reload it, assert every key hits."""
    global num_timed_candidates

    def tune_all():
        plans = {}
        for mode, backend, d, m, k, batch in SMOKE_SHAPES:
            spec = QuantSpec(mode=mode, d=d, scale_block=4 * d,
                             storage="packed_u8" if mode == "int4_dequant"
                             else "packed_idx")
            plans[backend] = autotune(spec, m, k, batch, backend,
                                      device_type=device_type, reps=1)
        return plans

    set_cache_path(cache_path)
    num_timed_candidates = 0
    plans = tune_all()
    for backend, p in plans.items():
        print(f"[autotune] {backend:12s} -> {p.tiles} ({p.source})")
    print(f"[autotune] cache: {cache().path} ({len(cache())} plans, "
          f"{num_timed_candidates} candidates timed)")
    # a fresh in-memory cache on the same file: everything from disk
    set_cache_path(cache_path)
    num_timed_candidates = 0
    again = tune_all()
    if again != plans or num_timed_candidates:
        print(f"[autotune] reload re-timed {num_timed_candidates} "
              f"candidates or changed plans: {again} != {plans}")
        return 1
    print(f"[autotune] reload: all {len(SMOKE_SHAPES)} keys served from "
          "disk, 0 candidates re-timed")
    return 0


def main(argv=None) -> int:
    import argparse

    from repro_torch.device import resolve

    ap = argparse.ArgumentParser(prog="python -m repro_torch.dispatch",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="tiny tune + cache write->reload assertion")
    ap.add_argument("--cache", default=None,
                    help="plan-cache JSON path (default: REPRO_PLAN_CACHE "
                         "or ~/.cache/msgemm-repro-torch/plans.json)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; there is no fallback")
    ap.add_argument("--mode", default="msgemm",
                    choices=["msgemm", "int4_dequant"])
    ap.add_argument("--d", type=int, default=3)
    ap.add_argument("--m", type=int, default=2048)
    ap.add_argument("--k", type=int, default=2048)
    ap.add_argument("--batch", type=int, default=4)
    args = ap.parse_args(argv)
    device_type = resolve(args.device).type
    if args.smoke:
        return _smoke(args.cache, device_type)
    set_cache_path(args.cache)
    int4 = args.mode == "int4_dequant"
    spec = QuantSpec(mode=args.mode, d=args.d, scale_block=12 * args.d,
                     storage="packed_u8" if int4 else "packed_idx")
    p = autotune(spec, args.m, args.k, args.batch,
                 "int4_cuda" if int4 else "msgemm_cuda",
                 device_type=device_type)
    print(f"[autotune] winner: {p}")
    print(f"[autotune] cache: {cache().path} ({len(cache())} plans)")
    return 0
