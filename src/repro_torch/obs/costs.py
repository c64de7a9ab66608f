"""Analytic per-GeMM cost model: flops / bytes / attainable time; port of
repro.obs.costs with the card's own device row.

This module prices *one kernel invocation* on a device so kernel
profiling hooks (``kernels/ops.profile_gemm``) can annotate a measured
time with an achieved-vs-attainable fraction.  Conventions match the
reference (1 MAC = 2 FLOPs; LUT-consume table adds = 1 op each).

The hardware table is keyed by torch device type.  ``cuda`` is the H100
SXM of NVIDIA's data sheet (dense rates, 700 W power limit): 3.35e12 B/s
of HBM3, 989e12 bf16 FLOP/s on the tensor cores, 67e12 f32 FLOP/s
outside them.  ``chip_smoke.py`` takes its kernels' bounds from this row,
and the perf model (``obs.perfmodel``) its uncalibrated roofline, so the
two share one source.  The ``cpu`` row is the reference's rough host
figure, useful only to order shapes against each other.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass


@dataclass(frozen=True)
class Device:
    name: str
    matmul_flops: float   # peak dense-matmul FLOP/s (bf16 tensor cores)
    vector_flops: float   # peak f32 op rate outside them (LUT consume adds)
    mem_bw: float         # B/s main-memory bandwidth

    def as_dict(self) -> dict:
        return asdict(self)


DEVICES = {
    # NVIDIA H100 SXM, data sheet, dense, at 700 W
    "cuda": Device("h100-sxm", 989e12, 67e12, 3.35e12),
    # honest-but-rough host numbers: one AVX2 socket-ish
    "cpu": Device("cpu-host", 1e11, 5e10, 3e10),
}


def device(kind: str = "cuda") -> Device:
    """The row of torch device type ``kind`` (the cpu row for others)."""
    return DEVICES.get(kind, DEVICES["cpu"])


def produce_table_ops(d: int) -> float:
    """Eq.-9 op count to build ONE d-digit LUT column (16^d entries)
    from one d-wide activation chunk.

    The table is built hierarchically: every i-digit prefix table is
    shared by all 16^(d-i) extensions, so level i costs 16^i adds and
    the whole build costs sum_{i=1..d} 16^i ~= 16^d * 16/15 — NOT
    16^d * d.  (The previous formula priced every entry as d
    independent multiply-adds, overcounting produce work — and the
    matching transient LUT traffic — by a factor that grows linearly
    in d; the overcount is what made d > 2 look produce-bound.)
    """
    return float(sum(16 ** i for i in range(1, d + 1)))


def lut_bytes(k: int, b: int, d: int = 3) -> float:
    """Transient LUT write+read traffic for one (k, b) produce phase,
    priced at HBM rates: 16^d entries per d-wide chunk, k/d chunks, b
    columns, f32.  The fused Pallas deployment keeps these tiles in
    VMEM (paper §4), and the Hopper kernel in shared memory, so
    :func:`gemm_cost` reports this separately instead of folding it into
    ``bytes``."""
    return 2 * 16 ** d * (k / d) * b * 4.0


def gemm_cost(m: int, k: int, b: int, *, quant: str = "msgemm",
              d: int = 3, dtype_bytes: float = 2.0) -> dict:
    """Cost of one (b, k) x (k, m) GeMM invocation.

    Returns produce/consume op counts (paper Eq. 9 accounting — the
    shared-prefix table build, see :func:`produce_table_ops`), bytes
    moved through main memory, and the arithmetic totals the roofline
    fraction divides by.  ``quant`` other than msgemm prices the dense
    path (produce = the whole matmul, consume = 0).  ``lut_bytes`` is
    the transient LUT spill traffic for deployments whose LUT does NOT
    stay in VMEM; it is reported but excluded from ``bytes`` (the fused
    kernels never move it through HBM).
    """
    if quant == "msgemm":
        # Eq. 9: shared tuple-table build per d-wide chunk (adds +
        # 16 b(i)*x products per digit, the latter negligible)
        produce = 2.0 * produce_table_ops(d) * (k / d) * b
        consume = float(m) * (k / d) * b       # table adds (VPU)
        weight_bytes = (32 / d) / 8 * m * k    # packed digit indices
        lutb = lut_bytes(k, b, d)
    else:
        produce = 2.0 * m * k * b
        consume = 0.0
        weight_bytes = dtype_bytes * m * k
        lutb = 0.0
    act_bytes = dtype_bytes * b * k
    out_bytes = dtype_bytes * b * m
    return {
        "m": m, "k": k, "b": b, "quant": quant, "d": d,
        "produce_flops": produce,
        "consume_ops": consume,
        "flops": produce + consume,
        "bytes": weight_bytes + act_bytes + out_bytes,
        "weight_bytes": weight_bytes,
        "lut_bytes": lutb,
    }


def attainable_s(cost: dict, dev: Device | None = None) -> float:
    """Roofline lower bound for one invocation: max of the compute term
    (produce at matmul rate + consume at vector rate) and the memory
    term."""
    dev = dev or device()
    compute = (cost["produce_flops"] / dev.matmul_flops
               + cost["consume_ops"] / dev.vector_flops)
    memory = cost["bytes"] / dev.mem_bw
    return max(compute, memory)


def achieved_fraction(measured_s: float, cost: dict,
                      dev: Device | None = None) -> float:
    """attainable / measured — 1.0 means running at the roofline, small
    means leaving performance on the table.  0.0 when measured time is
    degenerate."""
    if measured_s <= 0.0:
        return 0.0
    return attainable_s(cost, dev) / measured_s


def annotate(measured_s: float, m: int, k: int, b: int, *,
             quant: str = "msgemm", d: int = 3,
             dev: Device | None = None) -> dict:
    """One-call convenience for benchmark rows: cost + attainable +
    fraction + the hardware model that priced it."""
    dev = dev or device()
    cost = gemm_cost(m, k, b, quant=quant, d=d)
    att = attainable_s(cost, dev)
    return {
        **cost,
        "measured_s": measured_s,
        "attainable_s": att,
        "roofline_fraction": att / measured_s if measured_s > 0 else 0.0,
        "hardware": dev.name,
    }
