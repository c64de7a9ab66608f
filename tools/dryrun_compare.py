"""Run dry-run cells of one or more source trees side by side and table
them: each cell a process of ``python -m repro_torch.launch.dryrun``
(fake tensors, no device), several at once, every tree's cells in one
pool, so two trees are compared on one host in one run.

    python3 tools/dryrun_compare.py --tree parent=_checkout/parent \\
        --tree new=. --shapes train_4k prefill_32k --jobs 8 \\
        --timeout 1500 --out chiprun_out/dryrun_compare

Each tree's cell results land in ``OUT/<name>/`` (the dry run's own JSON
files) and the table in ``OUT/table.md``: for each cell and tree its
status, the rank's argument and peak GiB, the collectives by kind (count
and MiB of results a step) and the host seconds the process took.
``--skip name:arch:shape`` leaves a cell out (its row says so).
"""

from __future__ import annotations

import argparse
import concurrent.futures as cf
import json
import os
import subprocess
import sys
import time
from pathlib import Path


def cells(archs, shapes, meshes):
    return [(a, s, m) for a in archs for s in shapes for m in meshes]


def run_one(tree: Path, out: Path, arch: str, shape: str, mesh: str,
            timeout: float, smoke: bool = False) -> dict:
    """One cell of ``tree`` in a process of its own: the dry run's JSON
    (its first cell) with the process's wall seconds, or the reason it
    did not finish."""
    out.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(tree / "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
           "--shape", shape, "--mesh", mesh, "--out", str(out.resolve())]
    if smoke:
        cmd.append("--smoke")
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, cwd=tree, env=env, capture_output=True,
                              text=True, timeout=timeout)
    except subprocess.TimeoutExpired:
        return {"status": "timeout", "wall_s": time.perf_counter() - t0}
    wall = time.perf_counter() - t0
    quant = "bf16" if shape.startswith("train") else "msgemm"
    path = out / f"{arch}__{shape}__{mesh}__{quant}.json"
    if not path.exists():
        return {"status": f"exit {proc.returncode}", "wall_s": wall,
                "error": proc.stderr[-2000:]}
    res = json.loads(path.read_text())
    res["wall_s"] = wall
    return res


def summary(res: dict | None) -> str:
    if res is None:
        return "skipped here"
    if res.get("status") != "ok":
        return f"{res.get('status')} ({res.get('wall_s', 0):.0f} s)"
    mem, gib = res["memory"], 2**30
    kinds = ", ".join(f"{k} {v['count']} ({v['bytes'] / 2**20:.1f})"
                      for k, v in sorted(res["collectives"].items()))
    return (f"{mem['argument_bytes_per_device'] / gib:.3f} / "
            f"{mem['peak_bytes_per_device'] / gib:.3f}; {kinds}; "
            f"{res['wall_s']:.0f} s")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", required=True,
                    help="name=path of a source tree (repeatable)")
    ap.add_argument("--arch", nargs="*", default=None)
    ap.add_argument("--shapes", nargs="+", default=["train_4k"])
    ap.add_argument("--meshes", nargs="+", default=["single", "multi"])
    ap.add_argument("--smoke", action="store_true",
                    help="the archs' reduced configs (a quick check)")
    ap.add_argument("--jobs", type=int, default=8)
    ap.add_argument("--timeout", type=float, default=1500.0)
    ap.add_argument("--skip", action="append", default=[],
                    help="name:arch:shape to leave out")
    ap.add_argument("--out", default="chiprun_out/dryrun_compare")
    args = ap.parse_args(argv)
    trees = {n: Path(t).resolve() for n, t in
             (t.split("=", 1) for t in args.tree)}
    sys.path.insert(0, str(next(iter(trees.values())) / "src"))
    from repro_torch import configs

    archs = args.arch or list(configs.ARCHS)
    skip = {tuple(s.split(":")) for s in args.skip}
    out = Path(args.out)
    todo = [(name, *c) for c in cells(archs, args.shapes, args.meshes)
            for name in trees if (name, c[0], c[1]) not in skip]
    results: dict = {}
    t0 = time.perf_counter()
    with cf.ThreadPoolExecutor(args.jobs) as pool:
        futs = {pool.submit(run_one, trees[n], out / n, a, s, m,
                            args.timeout, args.smoke): (n, a, s, m)
                for n, a, s, m in todo}
        for f in cf.as_completed(futs):
            key = futs[f]
            results[key] = f.result()
            print(f"[dryrun-compare] {'/'.join(key)}: "
                  f"{summary(results[key])}", flush=True)
    names = list(trees)
    lines = ["| Cell | " + " | ".join(names) + " |",
             "|---|" + "---|" * len(names)]
    for a, s, m in cells(archs, args.shapes, args.meshes):
        lines.append(f"| {a} `{s}` {m} | " + " | ".join(
            summary(results.get((n, a, s, m))) for n in names) + " |")
    table = "\n".join(lines)
    out.mkdir(parents=True, exist_ok=True)
    (out / "table.md").write_text(table + "\n")
    print(table)
    print(f"[dryrun-compare] {len(todo)} cells in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    bad = [k for k, v in results.items()
           if v.get("status") not in ("ok", "skipped")]
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
