"""Analytical kernel-time model, calibration, and regression sentinel;
port of repro.obs.perfmodel, with its collective-time term.

``obs.costs`` prices a GeMM against an idealized roofline; this module
predicts the time of the port's own kernels from five per-device
constants:

    t = launch_s           * kernel launches   (the split reduction too)
      + step_s             * serial work units (the busiest SM's: LUT
                                                chunks for msGeMM, 256-code
                                                steps for int4; the plain
                                                versions: their loops'
                                                torch ops)
      + produce_s_per_flop * produce flops     (msGeMM: one 16^d x tb
                                                table per chunk a block
                                                covers; int4: the dots)
      + consume_s_per_op   * (gather-adds + epilogue ops)
      + hbm_s_per_byte     * device-memory bytes

The work terms are counted from the Hopper kernels' own grids
(``kernels.msgemm.grid``, ``kernels.int4_matmul.rows_per_block`` and
``split_steps``) at the tiles a plan names, not carried over from the
TPU grid.  The constants are fitted by weighted least squares from
timings the stack persists — the autotuner's per-candidate ``timings``
in the plan cache, ``profile_gemm`` rows, and ``kernel_gemm_s``
histograms from a traced serve run — and stored as a versioned,
CRC-stamped ``calibration.json``.  The fit minimizes relative error, so
a 10 µs decode GeMM weighs as much as a millisecond prefill one.

Calibrations are partitioned on (device, interpret).  ``device`` is the
plan key's: ``cuda:<the card's name>``, or ``cpu``.  ``interpret`` keeps
the reference's name and means "the plain PyTorch version ran" (true on
the CPU, false for a kernel), so a CPU fit never judges the card.

The collective-time term (:func:`predict_collective`) prices a
row-parallel linear's collective layout (pipeline chunks, the group's
own all-reduce or a ring) as a delta from its one-shot plan, from three
constants fitted by :func:`fit_collective` to the shard-variant tuner's
timing rows (the plan cache's ``shard_variants`` tables); it is stored
as the calibration's optional ``collective`` block.  Those rows are
partitioned by ``device`` alone: the card's name says whether a kernel
or the plain version ran, so the reference's ``interpret`` tag is not
carried there.

Consumers: ``dispatch.autotune`` ranks candidates by :func:`predict` and
times only the predicted best few (the variant grid by
:func:`predict_collective`); ``python -m repro_torch.obs
--check-regressions`` and ``serve --check-regressions`` compare measured
times with the model (the regression sentinel): a measurement is an
outlier when ``measured > tolerance * predicted`` (``DEFAULT_TOLERANCE``
3x); faster-than-predicted rows are reported, never failed.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import time
from dataclasses import dataclass, field
from pathlib import Path

CALIBRATION_VERSION = 1
DEFAULT_TOLERANCE = 3.0

# model constants, in feature-vector order (the fit solves for these)
CONSTANT_NAMES = ("launch_s", "step_s", "produce_s_per_flop",
                  "consume_s_per_op", "hbm_s_per_byte")

# collective-time term: the extra time of a row-parallel linear's
# collective layout over its one-shot plan,
#   dt = coll_call_s * d(kernel calls) + coll_hop_s * d(hops)
#      + coll_byte_s * d(bytes)
# fitted per device from the plan cache's shard_variants timing rows.
# Unlike CONSTANT_NAMES these may fit negative: a negative hop or byte
# coefficient is overlap measured (more hops hiding under compute).  The
# block is optional in calibration.json (the version stays 1).
COLLECTIVE_CONSTANT_NAMES = ("coll_call_s", "coll_hop_s", "coll_byte_s")

# rough per-element op counts of the epilogue activations
_ACT_OPS = {"none": 0.0, "relu": 1.0, "gelu": 8.0, "silu": 6.0}

# bytes an element of x and of the output: the engine's bf16 activations
# (the autotuner times bf16 x too)
X_BYTES = OUT_BYTES = 2.0
# msGeMM's int32 LUT indices, the f32 scales and split partials
WORD = 4.0

TILE_FIELDS = ("tb", "rows", "stage", "tj", "tk", "nsplit")


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def current_partition(device_type: str = "cuda") -> tuple[str, bool]:
    """(device, interpret) of fresh measurements on ``device_type``: the
    plan key's device name, and whether the plain versions ran."""
    from repro_torch.dispatch.plan import device_name

    return device_name(device_type), device_type != "cuda"


# =====================================================================
# samples — one measured kernel call, self-describing
# =====================================================================
@dataclass(frozen=True)
class Sample:
    """One measured time plus everything the model needs to predict it.
    The tile fields are a ``Tiles`` (tb, rows, stage, tj) or an
    ``Int4Tiles`` (tb, tk, nsplit) spelled out; all None: the
    heuristic's tiles."""

    backend: str
    mode: str                  # 'msgemm' | 'int4_dequant' | 'bf16'
    d: int
    scale_block: int
    m: int
    k: int
    b: int
    measured_s: float
    device: str
    interpret: bool
    tb: int | None = None
    rows: int | None = None
    stage: int | None = None
    tj: int | None = None
    tk: int | None = None
    nsplit: int | None = None
    epilogue_ops: float = 0.0
    source: str = "?"

    @property
    def tiles(self):
        from repro_torch.dispatch.autotune import tiles_from

        return tiles_from({f: getattr(self, f) for f in TILE_FIELDS})

    def desc(self) -> str:
        t = self.tiles
        return (f"{self.backend} {self.mode} d={self.d} m={self.m} "
                f"k={self.k} b={self.b} tiles="
                f"{'heuristic' if t is None else tuple(t)} [{self.source}]")


def _tile_kw(fields: dict) -> dict:
    return {f: int(fields[f]) for f in TILE_FIELDS
            if fields.get(f) is not None}


# =====================================================================
# feature extraction — the work terms of the Hopper kernels
# =====================================================================
def features(backend: str, mode: str, d: int, scale_block: int,
             m: int, k: int, b: int, *, tiles=None,
             epilogue_ops: float = 0.0, interpret: bool = False) -> dict:
    """The work terms of one call, one per model constant, counted from
    the kernel's grid at ``tiles`` (None: the heuristic's).

    The serial work is what the busiest SM does, in the tile pickers' own
    cost models: ``ops.msgemm_span`` (LUT chunks, plus a block's fixed
    cost, over the blocks in flight) and ``ops.int4_span`` (256-code
    steps likewise), so a grid too small to fill the card costs its
    latency.  (A count of all blocks, tried first, fitted the card's
    timings with relative errors up to 2.9x on the small int4 grids;
    PERF.md section 6.)  With ``interpret`` (the plain version ran, on
    the CPU) a unit is one torch op of the plain version's loops instead:
    msGeMM's two a chunk, 2d + 2 a scale block and two a split; int4's
    one a code position of a lane (8 a 256-code step) and one a split.

    msGeMM (``msgemm_cuda``): each (row tile, column tile) builds one
    16^d x tb table per chunk over its splits; one gather-add per (row,
    chunk, column); bytes: the int32 indices once per column tile, x once
    per block's split range, the scales once per column tile, the output,
    and the f32 partials of a split (written and read back by the
    reduction, a second launch).

    int4 (``int4_cuda``): the dots 2·m·k per staged column; bytes: the
    codes at half a byte and the scales once per column tile, x once per
    block, the output, and the partials of a split.  Dense weights: the
    reference's terms.
    """
    from repro_torch.kernels import int4_matmul as i4
    from repro_torch.kernels import msgemm as ms
    from repro_torch.kernels import ops
    from repro_torch.obs import costs

    d = max(int(d), 1)
    sb = max(int(scale_block), d)
    launches = 1.0
    consume = 0.0
    if backend == "msgemm_cuda" and mode == "msgemm":
        kc = _ceil_div(k, d)
        t = tiles or ops.msgemm_tiles(m, kc, b, d, sb)
        gx, nsplit, gz = ms.grid(m, kc, b, t)
        nsb = _ceil_div(kc, sb // d)
        steps = (2 * kc + (2 * d + 2) * nsb + 2 * nsplit if interpret
                 else ops.msgemm_span(m, kc, b, d, t))
        produce = 2.0 * costs.produce_table_ops(d) * kc * gz * t.tb * gx
        consume = float(m) * kc * b
        hbm = (WORD * m * kc * gz + X_BYTES * k * t.tb * gx * gz
               + WORD * m * nsb * gz + OUT_BYTES * m * b)
    elif backend == "int4_cuda" and mode == "int4_dequant":
        t = tiles or ops.int4_tiles(m, k, b)
        rt = _ceil_div(m, i4.rows_per_block(t.tb))
        ct = _ceil_div(b, t.tb)
        per, nsplit = i4.split_steps(k, t.nsplit)
        steps = (i4.WORD * per * nsplit + nsplit if interpret
                 else ops.int4_span(m, k, b, t))
        produce = 2.0 * m * k * ct * t.tb
        hbm = (0.5 * m * k * ct + WORD * m * _ceil_div(k, sb) * ct
               + X_BYTES * k * t.tb * rt * ct + OUT_BYTES * m * b)
    else:                                 # dense matmul
        nsplit = steps = 1
        produce = 2.0 * float(m) * k * b
        hbm = 2.0 * m * k + 2.0 * k * b + 2.0 * m * b
    if nsplit > 1:
        launches += 1.0
        hbm += 2.0 * WORD * nsplit * m * b
    return {
        "launch_s": launches,
        "step_s": float(steps),
        "produce_s_per_flop": produce,
        "consume_s_per_op": consume + float(epilogue_ops),
        "hbm_s_per_byte": hbm,
    }


def sample_features(s: Sample) -> dict:
    return features(s.backend, s.mode, s.d, s.scale_block, s.m, s.k, s.b,
                    tiles=s.tiles, epilogue_ops=s.epilogue_ops,
                    interpret=s.interpret)


def epilogue_op_count(epilogue, m: int, b: int) -> float:
    """Per-call elementwise ops of a core.epilogue.Epilogue."""
    if epilogue is None or getattr(epilogue, "is_identity", True):
        return 0.0
    per = _ACT_OPS.get(getattr(epilogue, "act", "none"), 4.0)
    per += 1.0 if getattr(epilogue, "bias", False) else 0.0
    per += 1.0 if getattr(epilogue, "residual", False) else 0.0
    return per * m * b


# =====================================================================
# calibration artifact
# =====================================================================
@dataclass
class Calibration:
    """Fitted constants per backend plus a pooled ``"*"`` set, with fit
    diagnostics, for one (device, interpret) partition; versioned JSON
    on disk (``calibration.json``), the reference's layout."""

    device: str
    interpret: bool
    constants: dict[str, dict[str, float]]
    fit: dict = field(default_factory=dict)
    sources: list = field(default_factory=list)
    version: int = CALIBRATION_VERSION
    created_unix: float = 0.0
    # fitted COLLECTIVE_CONSTANT_NAMES with their fit diagnostics; empty
    # when no shard-variant timings existed
    collective: dict = field(default_factory=dict)

    def matches(self, device: str, interpret: bool) -> bool:
        return self.device == device and self.interpret == bool(interpret)

    def constants_for(self, backend: str | None) -> dict[str, float]:
        return self.constants.get(backend) or self.constants["*"]

    def as_dict(self) -> dict:
        out = {"version": self.version, "device": self.device,
               "interpret": self.interpret,
               "constants": {bk: dict(c)
                             for bk, c in self.constants.items()},
               "fit": dict(self.fit), "sources": list(self.sources),
               "created_unix": self.created_unix}
        if self.collective:
            out["collective"] = dict(self.collective)
        return out

    def save(self, path: str | os.PathLike) -> Path:
        from repro_torch import faults
        from repro_torch.obs import artifacts

        p = Path(path)
        artifacts.atomic_write_json(p, artifacts.stamp_crc(self.as_dict()))
        ev = faults.fire("corrupt_calibration")
        if ev is not None:
            faults.corrupt_file(p, ev)
        return p


def default_calibration_path() -> Path:
    env = os.environ.get("REPRO_CALIBRATION")
    if env:
        return Path(env)
    base = os.environ.get("XDG_CACHE_HOME") or os.path.join(
        os.path.expanduser("~"), ".cache")
    return Path(base) / "msgemm-repro-torch" / "calibration.json"


def validate_calibration(doc: dict) -> list[str]:
    """Schema check of a calibration document (empty list == valid)."""
    errs: list[str] = []
    if not isinstance(doc, dict):
        return ["calibration is not an object"]
    if doc.get("version") != CALIBRATION_VERSION:
        errs.append(f"version={doc.get('version')!r} != "
                    f"{CALIBRATION_VERSION}")
    if not isinstance(doc.get("device"), str):
        errs.append("device missing or not a string")
    if not isinstance(doc.get("interpret"), bool):
        errs.append("interpret missing or not a bool")
    consts = doc.get("constants")
    if not isinstance(consts, dict) or not isinstance(
            consts.get("*"), dict):
        errs.append("constants missing or no pooled '*' entry")
    else:
        for bk, block in consts.items():
            if not isinstance(block, dict):
                errs.append(f"constants[{bk!r}] not an object")
                continue
            for name in CONSTANT_NAMES:
                v = block.get(name)
                if not isinstance(v, (int, float)):
                    errs.append(f"constants[{bk!r}].{name} missing or "
                                f"non-numeric")
                elif v < 0 or not math.isfinite(v):
                    errs.append(f"constants[{bk!r}].{name}={v} not "
                                f"finite/>=0")
    fit_ = doc.get("fit")
    if not isinstance(fit_, dict) or "n_samples" not in (fit_ or {}):
        errs.append("fit block missing n_samples")
    # the collective block is optional and checked only when present; its
    # constants may be negative (a delta from the one-shot plan), so only
    # finiteness is required
    coll = doc.get("collective")
    if coll is not None:
        if not isinstance(coll, dict):
            errs.append("collective block not an object")
        else:
            for name in COLLECTIVE_CONSTANT_NAMES:
                v = coll.get(name)
                if not isinstance(v, (int, float)):
                    errs.append(f"collective.{name} missing or "
                                f"non-numeric")
                elif not math.isfinite(v):
                    errs.append(f"collective.{name}={v} not finite")
            if "n_samples" not in coll:
                errs.append("collective block missing n_samples")
    return errs


def validate_calibration_file(path) -> list[str]:
    try:
        doc = json.loads(Path(path).read_text())
    except (OSError, ValueError) as e:
        return [f"unreadable calibration {path}: {e}"]
    return validate_calibration(doc)


def load_calibration(path: str | os.PathLike | None = None, *,
                     device: str | None = None,
                     interpret: bool | None = None,
                     max_age_s: float | None = None) -> Calibration | None:
    """The calibration at ``path`` if present, CRC-clean, schema-valid,
    of the asked partition (a None field matches any) and no older than
    ``max_age_s``; None otherwise, the case every consumer falls back
    on.  A corrupt file is quarantined aside."""
    from repro_torch.obs import artifacts

    p = Path(path) if path is not None else default_calibration_path()
    doc = artifacts.load_json_checked(p, "calibration")
    if doc is None or validate_calibration(doc):
        return None
    cal = Calibration(
        device=doc["device"], interpret=doc["interpret"],
        constants={bk: {k: float(v) for k, v in block.items()}
                   for bk, block in doc["constants"].items()},
        fit=doc.get("fit", {}), sources=doc.get("sources", []),
        version=doc["version"],
        created_unix=float(doc.get("created_unix", 0.0)),
        collective=doc.get("collective") or {})
    if (device is not None and cal.device != device) or \
            (interpret is not None and cal.interpret != bool(interpret)):
        return None
    if max_age_s is not None and cal.created_unix and \
            time.time() - cal.created_unix > max_age_s:
        return None
    return cal


# =====================================================================
# prediction
# =====================================================================
@dataclass(frozen=True)
class PredictedCost:
    """Predicted time of one kernel call, by component."""

    t_total_s: float
    t_launch_s: float
    t_step_s: float
    t_produce_s: float
    t_consume_s: float
    t_hbm_s: float
    calibrated: bool
    device: str

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def _fallback_constants(device: str) -> dict[str, float]:
    """Uncalibrated constants from the ``obs.costs`` row of the device's
    type: a roofline-style bound with no launch or step overhead."""
    from repro_torch.obs import costs

    dev = costs.device(device.split(":")[0])
    return {"launch_s": 0.0, "step_s": 0.0,
            "produce_s_per_flop": 1.0 / dev.matmul_flops,
            "consume_s_per_op": 1.0 / dev.vector_flops,
            "hbm_s_per_byte": 1.0 / dev.mem_bw}


def predict_features(feats: dict, calib: Calibration | None,
                     device: str = "cpu",
                     backend: str | None = None) -> PredictedCost:
    if calib is not None:
        consts = calib.constants_for(backend)
        calibrated, device = True, calib.device
    else:
        consts, calibrated = _fallback_constants(device), False
    terms = {name: consts.get(name, 0.0) * feats.get(name, 0.0)
             for name in CONSTANT_NAMES}
    return PredictedCost(
        t_total_s=sum(terms.values()),
        t_launch_s=terms["launch_s"], t_step_s=terms["step_s"],
        t_produce_s=terms["produce_s_per_flop"],
        t_consume_s=terms["consume_s_per_op"],
        t_hbm_s=terms["hbm_s_per_byte"],
        calibrated=calibrated, device=device)


def predict(plan, spec, m: int, k: int, batch: int, *,
            calib: Calibration | None = None, epilogue=None,
            device_type: str = "cuda") -> PredictedCost:
    """Predicted time of (spec, plan) on one (batch, k) x (k, m) linear.
    ``plan`` is a dispatch ExecPlan (tiles None: the heuristic's);
    ``calib`` None falls back to the roofline constants of
    ``device_type``'s ``obs.costs`` row (``calibrated=False``)."""
    from repro_torch.dispatch.plan import plan_d

    d = plan_d(spec, m, k)
    interpret = calib.interpret if calib is not None \
        else device_type != "cuda"
    feats = features(plan.backend, spec.mode, max(d, 1), spec.scale_block,
                     m, k, batch, tiles=plan.tiles,
                     epilogue_ops=epilogue_op_count(epilogue, m, batch),
                     interpret=interpret)
    device = calib.device if calib is not None else device_type
    return predict_features(feats, calib, device, backend=plan.backend)


def predict_sample(s: Sample, calib: Calibration | None) -> PredictedCost:
    return predict_features(sample_features(s), calib, s.device,
                            backend=s.backend)


# =====================================================================
# collective-time term (row-parallel linears' collective layouts)
# =====================================================================
def collective_features(*, impl: str, collective: str, axis_size: int,
                        m: int, b: int, pipeline_chunks: int = 1,
                        dtype_bytes: int = 4) -> dict:
    """(calls, hops, bytes) of resolving one row-parallel linear whose
    partial output on a rank is (b, m) f32 under the given collective
    layout: ``distributed.collectives.collective_cost``'s hops and bytes,
    summed over the pipeline chunks."""
    from repro_torch.distributed import collectives as coll

    hops, nbytes = coll.collective_cost(
        impl=impl, collective=collective, axis_size=axis_size,
        elems=m * b, dtype_bytes=dtype_bytes,
        pipeline_chunks=pipeline_chunks)
    return {"calls": max(int(pipeline_chunks), 1), "hops": hops,
            "bytes": nbytes}


def predict_collective(*, calls: float, hops: float, nbytes: float,
                       collective: dict) -> float:
    """Predicted time delta (seconds, may be negative) of a collective
    layout over the one-shot plan of the same linear, from a fitted
    ``Calibration.collective`` block.  The tuner ranks variants by it;
    the one-shot baseline they share cancels."""
    return (collective.get("coll_call_s", 0.0) * (calls - 1)
            + collective.get("coll_hop_s", 0.0) * hops
            + collective.get("coll_byte_s", 0.0) * nbytes)


def collective_rows_from_plan_cache(path: str | os.PathLike | None = None
                                    ) -> list[dict]:
    """The timing rows of the plan cache's ``shard_variants`` tables, each
    with its base key (the rows of one key share their compute, so only
    deltas within a key mean anything)."""
    from repro_torch.dispatch import autotune as at

    cache = at.PlanCache(path).load()
    out = []
    for key in cache.variant_keys():
        for row in cache.shard_variant(key).get("rows", []):
            out.append(dict(row, key=key))
    return out


def _row_device(rows: list[dict]) -> str | None:
    """The device most rows were measured on (ties: the first name)."""
    counts: dict[str, int] = {}
    for r in rows:
        if r.get("device") is not None:
            counts[r["device"]] = counts.get(r["device"], 0) + 1
    return max(sorted(counts), key=counts.get) if counts else None


def fit_collective(rows: list[dict], *,
                   device: str | None = None) -> dict | None:
    """Least-squares fit of COLLECTIVE_CONSTANT_NAMES to the shard-variant
    timing rows of ``device`` (None: the device most rows name).  Each
    key's one-shot row (1 chunk, 'xla') is its baseline; every other row
    of the key gives one equation

        s - s_base = call_s (pc - 1) + hop_s (hops - hops_base)
                     + byte_s (bytes - bytes_base)

    solved by plain (signed) least squares: a negative coefficient is
    overlap measured.  None when fewer equations than constants exist
    (the tuner then times every variant)."""
    import numpy as np

    if device is None:
        device = _row_device(rows)
    by_key: dict[str, list[dict]] = {}
    for r in rows:
        if r.get("device") == device:
            by_key.setdefault(r.get("key", "?"), []).append(r)
    A, y = [], []
    for key, group in sorted(by_key.items()):
        base = next((r for r in group
                     if int(r.get("pipeline_chunks", 1)) == 1
                     and r.get("collective_impl") == "xla"), None)
        if base is None:
            continue
        for r in group:
            if r is base:
                continue
            A.append([int(r.get("pipeline_chunks", 1)) - 1,
                      float(r.get("hops", 0)) - float(base.get("hops", 0)),
                      float(r.get("bytes", 0.0))
                      - float(base.get("bytes", 0.0))])
            y.append(float(r["s"]) - float(base["s"]))
    if len(y) < len(COLLECTIVE_CONSTANT_NAMES):
        return None
    A_arr, y_arr = np.asarray(A, float), np.asarray(y, float)
    theta, *_ = np.linalg.lstsq(A_arr, y_arr, rcond=None)
    if not np.isfinite(theta).all():
        return None
    resid = A_arr @ theta - y_arr
    out = {n: float(v) for n, v in zip(COLLECTIVE_CONSTANT_NAMES, theta)}
    out["n_samples"] = len(y)
    out["rms_err_s"] = float(np.sqrt(np.mean(resid ** 2)))
    return out


# =====================================================================
# calibration fit — weighted non-negative least squares
# =====================================================================
def _fit_constants(use: list[Sample]) -> dict[str, float]:
    """NNLS-lite fit of the 5 constants to one sample group: rows scaled
    by 1/measured (relative error); non-negativity by dropping the most
    negative constant and solving again (a rate is never negative; a
    dropped constant is one the samples cannot resolve)."""
    import numpy as np

    t = np.array([s.measured_s for s in use])
    A = np.array([[sample_features(s)[name] for name in CONSTANT_NAMES]
                  for s in use])
    Aw = A / t[:, None]
    ones = np.ones(len(use))
    active = list(range(len(CONSTANT_NAMES)))
    theta = np.zeros(len(CONSTANT_NAMES))
    while active:
        sol, *_ = np.linalg.lstsq(Aw[:, active], ones, rcond=None)
        if (sol >= 0).all():
            theta[:] = 0.0
            theta[active] = sol
            break
        active.pop(int(np.argmin(sol)))
    else:
        raise ValueError("calibration fit degenerate: no non-negative "
                         "constants explain the samples")
    return {n: float(v) for n, v in zip(CONSTANT_NAMES, theta)}


MIN_SAMPLES_PER_BACKEND = 3


def _partition_of(samples: list[Sample]) -> tuple[str, bool]:
    """The (device, interpret) partition most samples belong to."""
    counts: dict[tuple[str, bool], int] = {}
    for s in samples:
        counts[(s.device, s.interpret)] = \
            counts.get((s.device, s.interpret), 0) + 1
    if not counts:
        raise ValueError("calibration needs samples; got none")
    return max(sorted(counts), key=counts.get)


def fit(samples: list[Sample], *, device: str | None = None,
        interpret: bool | None = None,
        sources: list | None = None) -> Calibration:
    """Fit the constants from the samples of one (device, interpret)
    partition (None fields: the partition most samples belong to), per
    backend with >= ``MIN_SAMPLES_PER_BACKEND`` samples plus a pooled
    ``"*"`` set; the fit diagnostics use :func:`predict_sample`'s
    per-backend rule."""
    import numpy as np

    if device is None or interpret is None:
        dev, itp = _partition_of(samples)
        device = device if device is not None else dev
        interpret = interpret if interpret is not None else itp
    use = [s for s in samples
           if s.device == device and s.interpret == bool(interpret)
           and s.measured_s > 0.0]
    if len(use) < MIN_SAMPLES_PER_BACKEND:
        raise ValueError(
            f"calibration needs >= {MIN_SAMPLES_PER_BACKEND} samples in "
            f"partition (device={device!r}, interpret={interpret}); got "
            f"{len(use)} of {len(samples)} total — run the autotuner "
            "first")
    constants = {"*": _fit_constants(use)}
    by_backend: dict[str, list[Sample]] = {}
    for s in use:
        by_backend.setdefault(s.backend, []).append(s)
    for bk, group in sorted(by_backend.items()):
        if len(group) >= MIN_SAMPLES_PER_BACKEND:
            try:
                constants[bk] = _fit_constants(group)
            except ValueError:
                pass  # degenerate group: the pooled fit serves it
    cal = Calibration(device=device, interpret=bool(interpret),
                      constants=constants, sources=list(sources or []),
                      created_unix=time.time())
    rel = np.array([predict_sample(s, cal).t_total_s / s.measured_s - 1.0
                    for s in use])
    worst = int(np.argmax(np.abs(rel)))
    cal.fit = {"n_samples": len(use),
               "n_backends": len(constants) - 1,
               "per_backend_n": {bk: len(g)
                                 for bk, g in sorted(by_backend.items())},
               "rms_rel_err": float(np.sqrt(np.mean(rel ** 2))),
               "median_abs_rel_err": float(np.median(np.abs(rel))),
               "max_abs_rel_err": float(np.max(np.abs(rel))),
               "worst_sample": use[worst].desc()}
    return cal


# =====================================================================
# measurement sources
# =====================================================================
def parse_plan_key(key: str) -> dict | None:
    """Invert dispatch.plan.plan_key (None for unparseable keys).  The
    device field may hold ``|``-free text such as a card's name."""
    parts = key.split("|")
    if len(parts) != 12:
        return None
    try:
        return {"device": parts[0], "backend": parts[1], "mode": parts[2],
                "d": int(parts[3][1:]), "scale_block": int(parts[4][2:]),
                "storage": parts[5], "codebook": parts[6][2:],
                "m": int(parts[7][1:]), "k": int(parts[8][1:]),
                "b": int(parts[9][1:]), "acc_dtype": parts[10][3:],
                "shard": parts[11][2:]}
    except (ValueError, IndexError):
        return None


def samples_from_plan_cache(path: str | os.PathLike | None = None
                            ) -> tuple[list[Sample], int]:
    """(samples, n_untagged) from the autotuner's per-candidate
    ``timings`` rows; rows without the partition tags are skipped and
    counted."""
    from repro_torch.dispatch import autotune as at

    cache = at.PlanCache(path).load()
    out: list[Sample] = []
    untagged = 0
    for key in cache.timing_keys():
        info = parse_plan_key(key)
        if info is None:
            continue
        for row in cache.timings(key) or []:
            if "interpret" not in row:
                untagged += 1
                continue
            out.append(Sample(
                backend=info["backend"], mode=info["mode"], d=info["d"],
                scale_block=info["scale_block"], m=info["m"], k=info["k"],
                b=info["b"], measured_s=float(row["s"]),
                device=row.get("device", info["device"]),
                interpret=bool(row["interpret"]), **_tile_kw(row),
                source=f"plan-cache:{key}"))
    return out, untagged


_BENCH_BACKENDS = {"msgemm": "msgemm_cuda", "int4": "int4_cuda"}


def samples_from_bench(path: str | os.PathLike) -> list[Sample]:
    """Samples from a JSON list of ``kernels.ops.profile_gemm`` rows (or
    ``{"rows": [...]}``), each at the heuristic's tiles."""
    doc = json.loads(Path(path).read_text())
    rows = doc.get("rows", []) if isinstance(doc, dict) else doc
    out: list[Sample] = []
    for r in rows:
        out.append(Sample(
            backend=_BENCH_BACKENDS[r["kind"]], mode=r["quant"],
            d=int(r["d"]), scale_block=int(r["scale_block"]), m=int(r["m"]),
            k=int(r["k"]), b=int(r["b"]), measured_s=float(r["measured_s"]),
            device=str(r["device"]), interpret=bool(r["interpret"]),
            source=f"bench:{r['kind']}.m{r['m']}.k{r['k']}.b{r['b']}"))
    return out


def parse_tiles_label(label: str) -> dict:
    """The tile fields of ``dispatch.tiles_label`` (``{}`` for ``-``)."""
    if not label or label == "-":
        return {}
    return _tile_kw(dict(kv.split("=") for kv in label.split(",")))


def samples_from_snapshot(doc: dict, *, device: str | None = None,
                          interpret: bool | None = None) -> list[Sample]:
    """Samples from the ``kernel_gemm_s`` histograms of a metrics snapshot
    (a serve run with tracing on): the p50 of each series, at the tiles
    its ``tiles`` label names (the heuristic's when absent).  The
    partition comes from the arguments, else from the snapshot's
    ``context`` (``plan_device``, ``interpret``, which the serve CLI
    writes)."""
    ctx = doc.get("context") or {}
    device = device if device is not None else ctx.get("plan_device")
    interpret = interpret if interpret is not None else ctx.get("interpret")
    if device is None or interpret is None:
        raise ValueError("the snapshot names no partition (context "
                         "plan_device/interpret): pass device= and "
                         "interpret=")
    out: list[Sample] = []
    for row in doc.get("histograms", []):
        if row.get("name") != "kernel_gemm_s" or not row.get("count"):
            continue
        lb = row.get("labels", {})
        if not {"backend", "m", "k", "b", "mode", "d", "sb"} <= set(lb):
            continue
        if "e" in lb:  # an expert stack: the model prices one linear
            continue
        p50 = row.get("p50")
        if not p50:
            continue
        out.append(Sample(
            backend=str(lb["backend"]), mode=str(lb["mode"]),
            d=int(lb["d"]), scale_block=int(lb["sb"]), m=int(lb["m"]),
            k=int(lb["k"]), b=int(lb["b"]), measured_s=float(p50),
            device=str(device), interpret=bool(interpret),
            **parse_tiles_label(str(lb.get("tiles", "-"))),
            source=(f"serve:kernel_gemm_s:{lb['backend']}"
                    f".m{lb['m']}.k{lb['k']}.b{lb['b']}")))
    return out


def samples_from_registry(reg=None, *, device_type: str = "cuda"
                          ) -> list[Sample]:
    """Live-registry variant of :func:`samples_from_snapshot`, in the
    partition of ``device_type`` (the ``serve --check-regressions``
    path)."""
    from repro_torch import obs

    device, interpret = current_partition(device_type)
    return samples_from_snapshot((reg or obs.registry()).snapshot(),
                                 device=device, interpret=interpret)


# =====================================================================
# regression sentinel
# =====================================================================
def check_regressions(samples: list[Sample], calib: Calibration, *,
                      tolerance: float = DEFAULT_TOLERANCE,
                      min_measured_s: float = 0.0) -> dict:
    """Compare every sample of the calibration's partition with the model.
    Returns a ranked report (worst ratio first); ``ok`` is False when any
    exceeds ``tolerance`` times its prediction.  Samples of other
    partitions are counted as skipped, never judged."""
    rows = []
    n_outliers = 0
    skipped = 0
    for s in samples:
        if not calib.matches(s.device, s.interpret):
            skipped += 1
            continue
        pred = predict_sample(s, calib).t_total_s
        floor = max(calib.constants_for(s.backend)["launch_s"], 1e-9)
        ratio = s.measured_s / max(pred, floor)
        outlier = ratio > tolerance and s.measured_s >= min_measured_s
        n_outliers += outlier
        rows.append({"desc": s.desc(), "source": s.source,
                     "measured_s": s.measured_s, "predicted_s": pred,
                     "ratio": ratio, "outlier": outlier,
                     "fast": ratio < 1.0 / tolerance})
    rows.sort(key=lambda r: -r["ratio"])
    return {"tolerance": tolerance, "device": calib.device,
            "interpret": calib.interpret, "n_samples": len(rows),
            "n_skipped_other_partition": skipped,
            "n_outliers": n_outliers,
            "n_fast": sum(r["fast"] for r in rows),
            "ok": n_outliers == 0, "rows": rows}


def render_report(report: dict, *, top: int = 20) -> str:
    """Human-readable ranked outlier report (markdown table)."""
    lines = [
        "# measured-vs-predicted regression report",
        f"partition: device={report['device']} "
        f"interpret={report['interpret']}  "
        f"tolerance: {report['tolerance']:g}x  "
        f"samples: {report['n_samples']} "
        f"(+{report['n_skipped_other_partition']} other-partition)  "
        f"outliers: {report['n_outliers']}  "
        f"verdict: {'OK' if report['ok'] else 'REGRESSION'}",
        "",
        "| rank | ratio | measured | predicted | flag | sample |",
        "|---|---|---|---|---|---|",
    ]
    for i, r in enumerate(report["rows"][:top]):
        flag = ("**OUTLIER**" if r["outlier"]
                else ("fast" if r["fast"] else "ok"))
        lines.append(
            f"| {i + 1} | {r['ratio']:.2f}x | {r['measured_s']:.3e}s | "
            f"{r['predicted_s']:.3e}s | {flag} | {r['desc']} |")
    if len(report["rows"]) > top:
        lines.append(f"| ... | | | | | {len(report['rows']) - top} more |")
    return "\n".join(lines)
