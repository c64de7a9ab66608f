#!/usr/bin/env python3
"""How ``kernels.ops.time_call``'s timed windows meet the host, on the
card: the autotuner's full sweep of four keys with the timer replaced by
an instrumented copy of it.

    python3 tools/time_call_probe.py [--calls-per-window N]

For each candidate, three timings of its calls (the sleep doubled each
time), each in windows of ``N`` calls (default ``ops.CALLS_PER_WINDOW``;
0 queues all of a candidate's calls in one window): whether every
window's sleep outlasted the host's queueing ("C", covered, else "u"),
the host's mean and worst microseconds a call, and the device
microseconds a call.  A window whose sleep ran out may hold idle gaps,
which only add.  Writes ``chiprun_out/time_call_probe.json``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

KEYS = [("int4_dequant", "int4_cuda", 256, 2048, 7),
        ("int4_dequant", "int4_cuda", 2048, 16384, 4),
        ("msgemm", "msgemm_cuda", 2048, 2048, 4),
        ("msgemm", "msgemm_cuda", 256, 2048, 4)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--calls-per-window", type=int, default=None)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("time_call_probe: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core.spec import QuantSpec
    from repro_torch.dispatch import autotune as at
    from repro_torch.kernels import nvcc, ops

    nvcc.build_all(["msgemm", "int4_matmul"])
    per_window = args.calls_per_window
    if per_window is None:
        per_window = ops.CALLS_PER_WINDOW
    rows: list[dict] = []

    def probe(fns, device, reps):
        for f in fns[:2]:
            f()
        width = per_window or reps
        timings = []
        for attempt in range(3):
            covered, host, worst, dev_ms = True, 0.0, 0.0, 0.0
            for lo in range(0, reps, width):
                hi = min(reps, lo + width)
                torch.cuda.synchronize(device)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                torch.cuda._sleep((hi - lo) * ops.SLEEP_CYCLES_PER_CALL
                                  * 2**attempt)
                start.record()
                for i in range(lo, hi):
                    t0 = time.perf_counter()
                    fns[i % len(fns)]()
                    dt = time.perf_counter() - t0
                    host += dt
                    worst = max(worst, dt)
                end.record()
                covered &= not start.query()
                end.synchronize()
                dev_ms += start.elapsed_time(end)
            timings.append(dict(covered=covered,
                                host_us=host / reps * 1e6,
                                host_worst_us=worst * 1e6,
                                device_us=dev_ms * 1e3 / reps))
        rows[-1]["candidates"].append(dict(reps=reps, timings=timings))
        return min(t["device_us"] for t in timings) / 1e6

    ops.time_call = probe
    for mode, backend, m, k, b in KEYS:
        spec = QuantSpec(mode=mode, d=3, scale_block=36,
                         storage="packed_u8" if mode == "int4_dequant"
                         else "packed_idx")
        rows.append(dict(key=f"{backend} m{m} k{k} b{b}", candidates=[]))
        at.autotune(spec, m, k, b, backend, persist=False, search="full")
        print(f"== {rows[-1]['key']}", flush=True)
        for c in rows[-1]["candidates"]:
            print(f"{c['reps']:4d} calls | " + " | ".join(
                f"{'C' if t['covered'] else 'u'} host {t['host_us']:.1f} "
                f"(worst {t['host_worst_us']:.0f}) device "
                f"{t['device_us']:.2f}" for t in c["timings"]), flush=True)
    first = [c["timings"][0]["covered"] for r in rows
             for c in r["candidates"]]
    print(f"[time_call_probe] {len(first) - sum(first)} of {len(first)} "
          f"candidates' first timings uncovered, {per_window or 'all'} "
          "calls a window", flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "time_call_probe.json").write_text(json.dumps(dict(
        calls_per_window=per_window, keys=rows), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
