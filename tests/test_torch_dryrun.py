"""The port's training dry run (``repro_torch.launch.dryrun``): a cell
built for one rank of a mesh on a fake process group, its state and
batch fake tensors, runs one real train step.

* a fake-mode cell of gemma-2b SMOKE on (data=2, model=2) against a real
  four-rank gloo run of the same step (``tests/torch_train_ranks.py``):
  for each rank, its collectives by kind (count and bytes) are equal,
  and its argument bytes equal the real rank's state plus batch bytes;
  the peak from ``MemTracker`` covers the arguments;
* the train cells of the non-dense archs come back ``skipped`` with a
  reason naming the ROADMAP entry (A13c); the serve cells are
  ``tests/test_torch_dryrun_serve.py``'s;
* the CLI writes one JSON file a cell under ``--out`` and nothing else
  (``benchmarks/results/`` untouched); a cell that raises is ``failed``
  and the CLI exits 1.
"""

import json
import os
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
from torch_plan_isolation import (  # noqa: E402,F401  (autouse)
    isolated_plan_cache, isolated_plan_cache_module)
torch.set_num_threads(1)

import torch_train_ranks as R  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs import shapes as shp  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import run_ranks  # noqa: E402

SHAPE, AXES = (2, 2), ("data", "model")
BATCH = (4, 16)
TKW = {"microbatches": 2}
RESULTS = Path(__file__).resolve().parents[1] / "benchmarks" / "results"


@pytest.fixture(scope="module")
def real():
    return run_ranks(R.dryrun_rank, R.WORLD, SHAPE, AXES, BATCH, TKW,
                     timeout=120)


@pytest.mark.parametrize("rank", [0, 3])
def test_fake_cell_equals_a_real_step(real, rank):
    cfg = configs.get_smoke("gemma_2b")
    specs = {k: shp.Spec(BATCH, torch.int32) for k in ("tokens", "labels")}
    got = dryrun.measure(cfg, R.train_config(TKW), specs, SHAPE, AXES,
                         rank=rank)
    assert got["collectives"] == real[rank]["collectives"]
    assert got["memory"]["argument_bytes_per_device"] == \
        real[rank]["argument_bytes"]
    assert got["memory"]["peak_bytes_per_device"] >= \
        got["memory"]["argument_bytes_per_device"] > 0
    assert got["local_batch"] == BATCH[0] // 2


@pytest.mark.parametrize("arch,shape,match", [
    ("qwen2_moe", "train_4k", "A13c"),
    ("jamba_v01", "train_4k", "A13c"),
    ("whisper_medium", "train_4k", "A13c"),
    ("gemma_2b", "long_500k", "quadratic"),
])
def test_unported_cells_are_skipped(arch, shape, match):
    res = dryrun.run_cell(arch, shape, multi_pod=False, smoke=True,
                          verbose=False)
    assert res["status"] == "skipped" and match in res["reason"]


def _listing(path: Path):
    return sorted(p.relative_to(path) for p in path.rglob("*")) \
        if path.exists() else []


def test_cli_writes_only_under_out(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    before = _listing(RESULTS)
    out = tmp_path / "cells"
    res = dryrun.main(["--arch", "gemma_2b", "--shape", "train_4k",
                       "--mesh", "single", "--smoke", "--out", str(out)])
    assert [r["status"] for r in res] == ["ok"]
    assert os.listdir(tmp_path) == ["cells"]
    files = os.listdir(out)
    assert files == ["gemma_2b__train_4k__single__bf16.json"]
    cell = json.loads((out / files[0]).read_text())
    assert cell["devices"] == 256 and cell["mesh"] == "16x16"
    assert cell["collectives"]["all_gather"]["count"] > 0
    assert _listing(RESULTS) == before


def test_cli_failed_cell_exits_1(tmp_path, monkeypatch):
    def boom(*a, **k):
        raise RuntimeError("boom")

    monkeypatch.setattr(dryrun, "measure", boom)
    with pytest.raises(SystemExit) as exc:
        dryrun.main(["--arch", "gemma_2b", "--shape", "train_4k", "--smoke",
                     "--out", str(tmp_path)])
    assert exc.value.code == 1
    cell = json.loads(next(tmp_path.glob("*.json")).read_text())
    assert cell["status"] == "failed" and "boom" in cell["error"]
