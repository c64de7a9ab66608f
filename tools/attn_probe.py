#!/usr/bin/env python3
"""Where the attention kernels' time goes, on the card: for the
paged-attention cases of ``chip_smoke.py`` (and the flash kernel at
gemma-2b's 8k prefill in bf16), the time a call takes between CUDA events
on back-to-back launches (as ``chip_smoke.py`` times it) beside the
device durations of its kernels from ``torch.profiler`` (each kernel from
its start to its end, launch gaps excluded) and the host time a call
takes to enqueue.  Then the paged-attention kernel rebuilt with phases
switched off (a patched copy of ``csrc/paged_attention.cu`` in
``kernels/build/``), each mask timed the same way: 1 = no q·k, 2 = no
p·v, 4 = no K/V code loads, 8 = no softmax, 16 = no output stores, 32
= no q loads, 64 = no positions read (one chunk of the first slots).
Besides, decode at kv8 with 1, 2, 4 and 8 query heads on one kv head
(rows per block), full kernel and every phase off.  The
results of a switched-off kernel are wrong on purpose; only the times are
read.  The pool is not cycled past the L2 here, unlike in
``chip_smoke.py``.

    python3 tools/attn_probe.py     # needs one GPU and nvcc

Writes ``chiprun_out/attn_probe.json``.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

CASES = ("decode-kv8", "prefill-kv8", "gemma2-9b-decode-kv8", "long-kv8",
         "gemma2-9b-long-kv8")
MASKS = (0, 1, 2, 4, 8, 16, 31, 63, 127)
# (text in csrc/paged_attention.cu, its replacement in the probe's copy)
PATCHES = [
    ("#include \"epilogue.cuh\"\n",
     "#include \"epilogue.cuh\"\n#ifndef PROBE\n#define PROBE 0\n#endif\n"),
    ("    if (j < n) {\n      const float sc = ksc[j];",
     "    if (j < n && !(PROBE & 1)) {\n      const float sc = ksc[j];"),
    ("  if (quad < nq) {\n    for (int j = sg; j < n; j += SG) {",
     "  if (quad < nq && !(PROBE & 2)) {\n"
     "    for (int j = sg; j < n; j += SG) {"),
    ("  for (int kv = 0; kv < 2; ++kv) {\n    if (p.vec) {",
     "  for (int kv = 0; kv < 2 && !(PROBE & 4); ++kv) {\n    if (p.vec) {"),
    ("  for (int r = warp; r < RB; r += kWarps) {\n    float* sr",
     "  for (int r = warp; r < RB && !(PROBE & 8); r += kWarps) {\n"
     "    float* sr"),
    ("  for (int e = tid; e < RB * p.dh; e += kThreads) {\n    const int r",
     "  for (int e = tid; e < RB * p.dh && !(PROBE & 16); e += kThreads) {\n"
     "    const int r"),
    ("    if (e < RB * dpad && rr < p.rows && d < p.dh) {\n      const int cq",
     "    if (e < RB * dpad && rr < p.rows && d < p.dh && !(PROBE & 32)) {\n"
     "      const int cq"),
    ("  live_chunks(p, b, lo_hi);\n  if (tid < 16) {",
     "  if (!(PROBE & 64)) live_chunks(p, b, lo_hi);\n"
     "  else if (tid == 0) { lo_hi[0] = 0; lo_hi[1] = 1;"
     " lo_hi[2] = min(p.chunk, p.nseq * p.bs); }\n  if (tid < 16) {"),
]


def build_probes():
    """{mask: the patched kernel's C entry point}, built in parallel."""
    from repro_torch.kernels import nvcc
    from repro_torch.kernels import paged_attention as pa

    src = (nvcc.CSRC / "paged_attention.cu").read_text()
    for old, new in PATCHES:
        if old not in src:
            raise RuntimeError(f"probe patch does not apply: {old[:50]!r}")
        src = src.replace(old, new)
    nvcc.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = nvcc.BUILD_DIR / "paged_attention_probe.cu"
    cu.write_text(src)
    procs = {}
    for mask in MASKS:
        so = nvcc.BUILD_DIR / f"libpaged_attention_probe{mask}.so"
        procs[mask] = (so, subprocess.Popen(
            [nvcc._nvcc(), *nvcc.NVCC_FLAGS, f"-DPROBE={mask}", "-I",
             str(nvcc.CSRC), "-o", str(so), str(cu)]))
    fns = {}
    for mask, (so, proc) in procs.items():
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed on the probe, mask {mask}")
        fn = ctypes.CDLL(str(so)).paged_attention_launch
        fn.argtypes = pa._ARGTYPES
        fn.restype = ctypes.c_int
        fns[mask] = fn
    return fns


def kernel_durations(fn, reps: int) -> dict[str, float]:
    """Mean device µs per call of each kernel ``fn`` launches."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key[:60]: e.self_device_time_total / reps
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0}


def host_us(fn, reps: int) -> float:
    """Host µs to enqueue one call (the card kept busy meanwhile)."""
    import torch

    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(int(reps * 100e-6 * 2e9))
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt * 1e6 / reps


def main() -> int:
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import nvcc
    from repro_torch.kernels import paged_attention as pa

    if not torch.cuda.is_available():
        print("attn_probe: no CUDA device", file=sys.stderr)
        return 2
    nvcc.build_all(["paged_attention", "flash_attention"])
    rows = []
    specs = dict(cs.attn_specs())
    for i, name in enumerate(CASES):
        a = cs.attn_inputs(seed=500 + i, **specs[name])
        call = lambda: pa.paged_attention_cuda(  # noqa: E731
            a["q"], *a["leaves"], a["tables"], a["positions"], **a["kw"])
        r = dict(name=name, events_us=cs.device_ms([call], reps=200) * 1e3,
                 kernels_us=kernel_durations(call, 50),
                 host_us=host_us(call, 200))
        rows.append(r)
        print(f"[probe] {name:22s} events {r['events_us']:.2f}us "
              f"host {r['host_us']:.2f}us kernels "
              + ", ".join(f"{k.split('(')[0][:40]} {v:.2f}us"
                          for k, v in r["kernels_us"].items()), flush=True)
    g = torch.Generator(device="cuda").manual_seed(7)
    q, k, v = (torch.randn((1, h, 8192, 256), generator=g, device="cuda")
               .to(torch.bfloat16) for h in (8, 1, 1))
    call = lambda: fa.flash_attention_cuda(q, k, v, causal=True)  # noqa
    r = dict(name="flash gemma-2b-prefill-8k bf16",
             events_us=cs.device_ms([call], reps=10) * 1e3,
             kernels_us=kernel_durations(call, 5), host_us=host_us(call, 10))
    rows.append(r)
    print(f"[probe] {r['name']} events {r['events_us']:.1f}us kernels "
          + ", ".join(f"{v:.1f}us" for v in r["kernels_us"].values()))
    # the switched-off kernels, through the wrapper's cached entry point
    key = ("paged_attention", "paged_attention_launch")
    fns = build_probes()
    real = nvcc.load(*key, pa._ARGTYPES)
    for i, name in enumerate(CASES):
        a = cs.attn_inputs(seed=500 + i, **specs[name])
        call = lambda: pa.paged_attention_cuda(  # noqa: E731
            a["q"], *a["leaves"], a["tables"], a["positions"], **a["kw"])
        line = []
        for mask, fn in fns.items():
            nvcc._fns[key] = fn
            k_us = sum(kernel_durations(call, 50).values())
            rows.append(dict(name=name, mask=mask, kernels_us=k_us))
            line.append(f"{mask}:{k_us:.2f}")
        nvcc._fns[key] = real
        print(f"[probe] {name:22s} kernel us by mask " + " ".join(line),
              flush=True)
    for H in (1, 2, 4, 8):
        a = cs.attn_inputs(4, 1, H, 1, 256, 8, 32, bits=8, seed=600 + H)
        call = lambda: pa.paged_attention_cuda(  # noqa: E731
            a["q"], *a["leaves"], a["tables"], a["positions"], **a["kw"])
        line = []
        for mask in (0, 127):
            nvcc._fns[key] = fns[mask]
            k_us = sum(kernel_durations(call, 50).values())
            rows.append(dict(name=f"decode-kv8-H{H}", mask=mask,
                             kernels_us=k_us))
            line.append(f"{mask}:{k_us:.2f}")
        nvcc._fns[key] = real
        print(f"[probe] decode-kv8 H={H} kernel us by mask " + " ".join(line),
              flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "attn_probe.json").write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
