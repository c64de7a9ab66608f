#!/usr/bin/env python3
"""Where the msGeMM kernel's time goes, on the card: the kernel of
``src/repro_torch/kernels/csrc/msgemm.cu`` rebuilt with parts of its
chunk loop switched off, timed at gemma-2b's GeMM shapes.

    python3 tools/msgemm_probe.py     # needs one GPU and nvcc

Switches (a bit mask): 1 = no table build after the first chunk's, 4 = no
gathers, 8 = no index staging (every row gathers entry tid & (16^d - 1)).
The results are wrong on purpose; only the times are read.  Each line
prints the time with every combination of switches; the difference to
the full kernel is what the switched-off part costs where it does not
overlap with the rest.  Writes ``chiprun_out/msgemm_probe.json``.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

# (text in csrc/msgemm.cu, its replacement in the probe's copy)
PATCHES = [
    ("  int act, out_type, x_type, res_type;\n};",
     "  int act, out_type, x_type, res_type, probe;\n};"),
    ("    if (q + 1 < nq) make_entries(q + 1);",
     "    if (q + 1 < nq && !(p.probe & 1)) make_entries(q + 1);"),
    ("    // ---- consume chunk q: all RPT gathers issued, then added\n    {",
     "    // ---- consume chunk q: all RPT gathers issued, then added\n"
     "    if (!(p.probe & 4)) {"),
    ("    if (st < nstages) {\n      int* tile",
     "    if (st < nstages && !(p.probe & 8)) {\n      int* tile"),
    ("        const int n = tile[off[i]];",
     "        const int n = (p.probe & 8) ? (tid & (N - 1)) : tile[off[i]];"),
    ("    int x_type, int res_type, void* stream) {",
     "    int x_type, int res_type, int probe, void* stream) {"),
    ("os_m, os_b, act, out_type, x_type, res_type};",
     "os_m, os_b, act, out_type, x_type, res_type, probe};"),
]
SHAPES = [("gate", 16384, 2048, 4), ("gate", 16384, 2048, 1),
          ("wq", 2048, 2048, 4), ("down", 2048, 16384, 4)]
PROBES = (0, 1, 4, 8, 1 | 4, 4 | 8, 1 | 4 | 8)


def build() -> ctypes.CDLL:
    from repro_torch.kernels import nvcc

    src = (nvcc.CSRC / "msgemm.cu").read_text()
    for old, new in PATCHES:
        if old not in src:
            raise RuntimeError(f"csrc/msgemm.cu changed: {old!r} not found")
        src = src.replace(old, new)
    nvcc.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = nvcc.BUILD_DIR / "msgemm_probe.cu"
    cu.write_text(src)
    lib = nvcc.BUILD_DIR / "libmsgemm_probe.so"
    subprocess.run([nvcc._nvcc(), *nvcc.NVCC_FLAGS, "-I", str(nvcc.CSRC),
                    "-o", str(lib), str(cu)], check=True)
    return ctypes.CDLL(str(lib))


def main() -> int:
    import torch

    from repro_torch.core import packing
    from repro_torch.kernels import msgemm as ms
    from repro_torch.kernels import ops

    if not torch.cuda.is_available():
        print("msgemm_probe: no CUDA device", file=sys.stderr)
        return 2
    fn = build().msgemm_launch
    fn.argtypes = ms._ARGTYPES[:-1] + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    vals = packing.b_values(torch.float32, "cuda")
    g = torch.Generator(device="cuda").manual_seed(0)
    results = []
    for name, m, k, b in SHAPES:
        d, sb = 3, 36
        kc, nsb = -(-k // d), -(-k // sb)
        idx = torch.randint(0, 16**d, (m, kc), generator=g, device="cuda",
                            dtype=torch.int32)
        x = torch.randn((b, k), generator=g, device="cuda") \
            .to(torch.bfloat16).t()
        sc = torch.rand((m, nsb), generator=g, device="cuda")
        t = ops.msgemm_tiles(m, kc, b, d, sb)
        gx, nsplit, gz = ms.grid(m, kc, b, t)
        out = torch.empty((b, m), device="cuda", dtype=torch.bfloat16).t()
        ws = (torch.empty((nsplit, b, m), device="cuda") if nsplit > 1
              else None)
        stream = torch.cuda.current_stream().cuda_stream

        def launch(probe):
            err = fn(idx.data_ptr(), x.data_ptr(), sc.data_ptr(),
                     vals.data_ptr(), None, None, out.data_ptr(),
                     None if ws is None else ws.data_ptr(), None,
                     m, k, kc, b, d, sb // d, nsb, t.tj, nsplit, t.tb,
                     t.rows // ms.THREADS, t.stage.bit_length() - 1,
                     x.stride(0), x.stride(1), 0, 0, out.stride(0),
                     out.stride(1), 0, 1, 1, 0, probe, stream)
            if err:
                raise RuntimeError(f"probe launch failed: CUDA error {err}")

        line = []
        for probe in PROBES:
            launch(probe)
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(int(30 * 300e-6 * 2e9))
            start.record()
            for _ in range(30):
                launch(probe)
            end.record()
            torch.cuda.synchronize()
            t_ms = start.elapsed_time(end) / 30
            line.append(f"{probe}:{t_ms:.4f}")
            results.append(dict(name=name, m=m, k=k, b=b, tiles=t._asdict(),
                                probe=probe, ms=t_ms))
        print(f"[probe] {name} b={b} {t} grid={gx}x{nsplit}x{gz}: "
              + " ".join(line), flush=True)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "msgemm_probe.json").write_text(json.dumps(results, indent=1))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
