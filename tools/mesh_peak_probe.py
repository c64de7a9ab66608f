#!/usr/bin/env python3
"""Where a mesh rank's device memory goes when it serves under the
'default' rules (FSDP storage) and under 'serve', on the card: two ranks
sharing ``cuda:0`` over host-staged gloo on a data=2 mesh, the 2-layer
gemma-2b of ``chip_smoke.py``'s ``[mesh-fsdp ...]`` (msgemm d=2 /
scale_block=32), serving its 6-request stream eagerly, built two ways:

* ``whole kept``: the whole model drawn on the card, the engine's copy cut
  from it (``runtime.serve.shard_params``), the whole model kept alive
  beside the engine through the run;
* ``copy``: this rank's copy drawn a block at a time
  (``runtime.serve.init_shard``), no whole model.

For each way and rule set: ``torch.cuda.memory_allocated`` after the
build, after the cut (the whole way only), and the run's peak
(``max_memory_allocated`` after a reset at the run's start); the whole
model's and the copy's bytes; the largest leaves of the whole model;
tokens of both ways equal.

    python3 tools/mesh_peak_probe.py     # needs one GPU and nvcc

Writes ``chiprun_out/mesh_peak_probe.json``.
"""

from __future__ import annotations

import gc
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

GIB = 2**30


def _ways(rank, device, seed):
    """One rank: both ways under both rule sets (the module doc)."""
    import torch

    import chip_smoke as C
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.runtime import serve as SV

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh((2,), ("data",))
    out = {}

    def alloc():
        torch.cuda.synchronize(device)
        return torch.cuda.memory_allocated(device)

    for rules in ("default", "serve"):
        torch.cuda.reset_peak_memory_stats(device)
        model, cfg = C.mesh_tune_model(device, seed)
        built = alloc()
        local = SV.shard_params(model, cfg, mesh, rules)
        cut = alloc()
        eng = C.make_engine(local, cfg, mesh=mesh, cuda_graph=False,
                            mesh_rules=rules)
        run = C._engine_run(eng, cfg, device)
        largest = sorted(((t.numel() * t.element_size(), n)
                          for n, t in model.named_buffers()), reverse=True)
        out[f"whole kept/{rules}"] = dict(
            built=built, cut=cut, peak=run["peak_bytes"],
            whole=C._resident(model), copy=C._resident(local),
            largest=largest[:3], tokens=run["tokens"])
        del eng, local, model
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        copy, cfg = C.mesh_tune_model(device, seed, mesh, rules)
        built = alloc()
        build_peak = torch.cuda.max_memory_allocated(device)
        eng = C.make_engine(copy, cfg, mesh=mesh, cuda_graph=False,
                            mesh_rules=rules)
        run = C._engine_run(eng, cfg, device)
        out[f"copy/{rules}"] = dict(
            built=built, build_peak=build_peak, peak=run["peak_bytes"],
            copy=C._resident(copy), tokens=run["tokens"])
        del eng, copy
        gc.collect()
        torch.cuda.empty_cache()
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("mesh_peak_probe: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import nvcc
    from repro_torch.launch.mesh import run_ranks

    nvcc.build_all(["msgemm"])  # once, before the ranks load it
    ranks = run_ranks(_ways, 2, 0, devices=["cuda:0", "cuda:0"],
                      timeout=900)
    for r, res in enumerate(ranks):
        for way, v in res.items():
            extra = (f", after the cut {v['cut'] / GIB:.3f}, whole model "
                     f"{v['whole'] / GIB:.3f}, copy {v['copy'] / GIB:.3f}; "
                     "largest leaves " + ", ".join(
                         f"{n} {b / GIB:.3f}" for b, n in v["largest"])
                     if "cut" in v else
                     f", build peak {v['build_peak'] / GIB:.3f}, copy "
                     f"{v['copy'] / GIB:.3f}")
            print(f"[mesh-peak] rank {r} {way}: allocated after the build "
                  f"{v['built'] / GIB:.3f} GiB{extra}; run peak "
                  f"{v['peak'] / GIB:.3f} GiB", flush=True)
        for rules in ("default", "serve"):
            same = res[f"whole kept/{rules}"]["tokens"] == \
                res[f"copy/{rules}"]["tokens"]
            print(f"[mesh-peak] rank {r} {rules}: tokens of both ways "
                  f"{'equal' if same else 'DIFFER'}", flush=True)
            if not same:
                return 1
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "mesh_peak_probe.json").write_text(json.dumps(
        [{k: {f: v for f, v in d.items() if f != "tokens"}
          for k, d in res.items()} for res in ranks], indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
