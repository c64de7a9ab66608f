"""Analytic cost model of msGeMM — paper §4 & §5, Eqs. 7–15; a copy of
repro.core.complexity (pure numpy), so the port imports nothing of the
JAX package.

Plus an *instrumented* executable model (`counted_msgemm`) that runs the
algorithm with explicit loops on small inputs and counts every FMA / add /
memory access, so tests can verify the closed-form formulas against actual
operation counts.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

NLEVELS = 16


# --------------------------------------------------------------------------
# Closed forms (paper equations)
# --------------------------------------------------------------------------

def c_lut(k: int, d: int) -> int:
    """Eq. 7: C(L) = 2^{4d} * k  (FMAs, per batch column)."""
    return NLEVELS**d * k


def m_lut(k: int) -> int:
    """Eq. 8: memory accesses to build L = reads of x."""
    return k


def c_consume(m: int, k: int, d: int) -> int:
    """Eq. 9: C(y) = (k/d - 1) * m  (adds, per batch column)."""
    return (k // d - 1) * m


def m_consume(m: int, k: int) -> int:
    """Eq. 10: reads of M."""
    return m * k


def c_msgemm(m: int, k: int, b: int = 1, d: int = 3) -> int:
    """Eq. 13: total msGeMM ops for an m×k×b GeMM."""
    return (c_lut(k, d) + c_consume(m, k, d)) * b


def c_gemm(m: int, k: int, b: int = 1) -> int:
    """Eq. 14: naive GeMM FMAs (rounded up to m·k·b, see §4 footnote 3)."""
    return m * k * b


def m_msgemm(m: int, k: int, b: int = 1) -> int:
    """Eq. 12 (× batch, §4.2): identical to naive GeMM memory traffic."""
    return k * b + m * k


def m_gemm(m: int, k: int, b: int = 1) -> int:
    return k * b + m * k


def speedup(m: int, k: int, b: int = 1, d: int = 3) -> float:
    """Eq. 15: C(GeMM) / C(msGeMM)."""
    return c_gemm(m, k, b) / c_msgemm(m, k, b, d)


def best_d(m: int, k: int, d_range=range(1, 7)) -> tuple[int, float]:
    """Sweep d (Fig. 3) and return (argmax_d, max speedup)."""
    s = {d: speedup(m, k, 1, d) for d in d_range if d <= 8}
    d_star = max(s, key=s.get)
    return d_star, s[d_star]


def lut_bytes(k: int, d: int, b: int, itemsize: int = 4) -> int:
    """Transient LUT footprint — the VMEM budget driver for the kernel."""
    return NLEVELS**d * (-(-k // d)) * b * itemsize


# --------------------------------------------------------------------------
# Instrumented execution (ground truth for the formulas)
# --------------------------------------------------------------------------

@dataclass
class OpCounts:
    fma: int = 0        # fused multiply-adds (produce phase)
    add: int = 0        # table adds (consume phase)
    mem: int = 0        # memory accesses (x reads + M reads)

    @property
    def total_compute(self) -> int:
        return self.fma + self.add


def counted_msgemm(codes: np.ndarray, x: np.ndarray, d: int):
    """Run msGeMM with explicit loops, counting ops per the paper's rules.

    Counting conventions follow §4 exactly: each LUT entry costs d FMAs
    (rounded up from d-1 adds + d muls); each y element costs k/d - 1 adds;
    indexing via code concatenation is free; L reads are cache hits (§4:
    "we assume that L ... is kept in cache").
    """
    m, k = codes.shape
    assert k % d == 0, "counted model follows the paper's d | k assumption"
    b = 1 if x.ndim == 1 else x.shape[1]
    xm = x.reshape(k, b).astype(np.float64)
    vals = np.where(np.arange(NLEVELS) <= 7, np.arange(NLEVELS), np.arange(NLEVELS) - 16)

    counts = OpCounts()
    kc = k // d
    n = NLEVELS**d
    lut = np.zeros((n, kc, b))
    # ---- produce (Eq. 2/3) ----
    counts.mem += k * b  # reads of x (Eq. 8, × batch)
    basis = np.zeros((n, d))
    for i in range(n):
        for r in range(d):
            basis[i, r] = vals[(i >> (4 * (d - 1 - r))) & 0xF]
    for i in range(n):
        for j in range(kc):
            for col in range(b):
                acc = 0.0
                for r in range(d):
                    acc += basis[i, r] * xm[j * d + r, col]
                    counts.fma += 1  # d FMAs per entry (§4 rounding)
                lut[i, j, col] = acc
    # ---- consume (Eq. 5) ----
    counts.mem += m * k  # reads of M (Eq. 10)
    y = np.zeros((m, b))
    for i in range(m):
        for col in range(b):
            idx0 = 0
            for r in range(d):
                idx0 = idx0 * NLEVELS + int(codes[i, r])
            acc = lut[idx0, 0, col]  # first lookup: no add yet
            for j in range(1, kc):
                idx = 0
                for r in range(d):
                    idx = idx * NLEVELS + int(codes[i, j * d + r])
                acc += lut[idx, j, col]
                counts.add += 1  # (k/d - 1) adds per element (Eq. 9)
            y[i, col] = acc
    return (y[:, 0] if x.ndim == 1 else y), counts


def counted_gemm(w: np.ndarray, x: np.ndarray):
    """Naive GeMM with §4's counting (m·k·b FMAs, k·b + m·k accesses)."""
    m, k = w.shape
    b = 1 if x.ndim == 1 else x.shape[1]
    counts = OpCounts(fma=m * k * b, add=0, mem=k * b + m * k)
    y = w.astype(np.float64) @ x.reshape(k, b).astype(np.float64)
    return (y[:, 0] if x.ndim == 1 else y), counts
