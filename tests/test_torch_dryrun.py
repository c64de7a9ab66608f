"""The port's training dry run (``repro_torch.launch.dryrun``): a cell
built for one rank of a mesh on a fake process group, its state and
batch fake tensors, runs one real train step.

* a fake-mode cell of gemma-2b SMOKE on (data=2, model=2) against a real
  four-rank gloo run of the same step (``tests/torch_train_ranks.py``):
  for each rank, its collectives by kind (count and bytes) are equal,
  and its argument bytes equal the real rank's state plus batch bytes;
  the peak from ``MemTracker`` covers the arguments;
* the same for qwen2-moe SMOKE (expert-parallel, its aux terms' psum,
  the tokens moved to its expert stacks, which stay cut over 'data');
* the same for gemma-2b SMOKE with 6 query heads over 3 kv heads, which
  group unevenly over a rank's 3 heads, so the query positions split
  over 'model' (the blocks' K/V gathers among the kinds); in both the
  residual's 16 positions split over 'model' between blocks, each
  block's input gathered (``seq_in_gather``) and its row-parallel
  output reduce-scattered (``seq_out_scatter``), counted alike;
* on fake tensors the sLSTM's recurrence and the mLSTM's chunks
  allocate what their loops do (``xlstm._SLSTMFake``,
  ``xlstm._MLSTMChunkFake``): xlstm SMOKE's train cell peaks within 2%
  of the loops' and holds the same arguments and collectives;
* the train cells of a MoE, a hybrid recurrent, an xLSTM and an
  encoder-decoder arch come back ``ok``; a cell that does not apply (gemma-2b's
  ``long_500k``) ``skipped`` with the reason; the serve cells are
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
from repro_torch.distributed import collectives as coll  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import run_ranks  # noqa: E402

SHAPE, AXES = (2, 2), ("data", "model")
BATCH = (4, 16)
TKW = {"microbatches": 2}
RESULTS = Path(__file__).resolve().parents[1] / "benchmarks" / "results"


# 6 query heads over 3 kv heads: model=2 gives a rank heads reading kv
# heads 0, 0, 1, so the query positions split instead
SEQ = ("gemma_2b-h6kv3", "gemma_2b", {"num_heads": 6, "num_kv_heads": 3})


@pytest.fixture(scope="module")
def real():
    return run_ranks(R.dryrun_rank, R.WORLD, SHAPE, AXES, BATCH, TKW,
                     ("gemma_2b", "qwen2_moe", SEQ), timeout=120)


def _fake_cell(arch, rank, over=None):
    cfg = configs.get_smoke(arch).replace(**(over or {}))
    specs = {k: shp.Spec(BATCH, torch.int32) for k in ("tokens", "labels")}
    return dryrun.measure(cfg, R.train_config(TKW), specs, SHAPE, AXES,
                          rank=rank)


@pytest.mark.parametrize("rank", [0, 3])
def test_fake_cell_equals_a_real_step(real, rank):
    _check_dense_cell(real, rank, "gemma_2b")


@pytest.mark.parametrize("rank", [0, 3])
def test_fake_split_query_cell_equals_a_real_step(real, rank):
    """The heads-cannot-split case of the test above: the query positions
    split, each attention layer's K/V gathers and the residual's
    collectives counted by kind alike in the fake cell and the real
    step; the attention's output is not gathered."""
    from repro_torch.models import layers as L

    got = _check_dense_cell(real, rank, SEQ[0], SEQ[1], SEQ[2])
    assert got["collectives"][L.SEQ_KV]["count"] > 0
    assert "seq_out_gather" not in got["collectives"]


def _check_dense_cell(real, rank, key, arch=None, over=None):
    got = _fake_cell(arch or key, rank, over)
    want = real[rank][key]
    assert got["collectives"] == want["collectives"]
    assert got["memory"]["argument_bytes_per_device"] == \
        want["argument_bytes"]
    assert got["memory"]["peak_bytes_per_device"] >= \
        got["memory"]["argument_bytes_per_device"] > 0
    assert got["local_batch"] == BATCH[0] // 2
    for kind in (coll.SEQ_IN, coll.SEQ_OUT):  # the residual split
        assert got["collectives"][kind]["count"] > 0, kind
    return got


@pytest.mark.parametrize("rank", [0, 3])
def test_fake_moe_cell_equals_a_real_step(real, rank):
    """qwen2-moe SMOKE ('ep': 3 experts a rank, its aux terms' psum over
    'data'; the stacks' out dim over 'data', so the tokens move to them):
    the fake-mode cell's collectives and argument bytes are the real
    rank's, the tokens' collectives among them."""
    got = _fake_cell("qwen2_moe", rank)
    want = real[rank]["qwen2_moe"]
    assert got["collectives"] == want["collectives"]
    for kind in ("expert_tokens", "expert_hidden", "expert_return"):
        assert got["collectives"][kind]["count"] > 0, kind
    assert got["memory"]["argument_bytes_per_device"] == \
        want["argument_bytes"]
    assert got["memory"]["peak_bytes_per_device"] >= \
        got["memory"]["argument_bytes_per_device"] > 0


def test_xlstm_fake_twins_hold_the_loops_memory(monkeypatch):
    """xlstm SMOKE's train cell on (data=2, model=2) at 4 x 512 tokens
    (four chunks of each recurrence's remat): with the sLSTM's
    recurrence and the mLSTM's chunks through their fake twins
    (``xlstm._SLSTMFake``, ``xlstm._MLSTMChunkFake``) against the loops
    themselves run on the fake tensors, the peak is within 2% and the
    argument bytes and collectives are the same."""
    from repro_torch.models import xlstm

    cfg = configs.get_smoke("xlstm_1b3")
    specs = {k: shp.Spec((4, 512), torch.int32) for k in ("tokens",
                                                          "labels")}

    def cell():
        return dryrun.measure(cfg, R.train_config({}), specs, SHAPE, AXES,
                              rank=0)

    twin = cell()
    monkeypatch.setattr(xlstm, "is_fake", lambda t: False)
    loop = cell()
    assert twin["collectives"] == loop["collectives"]
    got, want = twin["memory"], loop["memory"]
    assert got["argument_bytes_per_device"] == \
        want["argument_bytes_per_device"]
    assert abs(got["peak_bytes_per_device"]
               - want["peak_bytes_per_device"]) \
        <= 0.02 * want["peak_bytes_per_device"]


@pytest.mark.parametrize("arch", ["qwen2_moe", "jamba_v01", "xlstm_1b3",
                                  "whisper_medium"])
def test_non_dense_train_cells_run(arch):
    """The train cells of a MoE, a hybrid recurrent and an
    encoder-decoder arch run (once reported skipped): ``ok``, with
    arguments, a peak and collectives."""
    res = dryrun.run_cell(arch, "train_4k", multi_pod=False, smoke=True,
                          verbose=False)
    assert res["status"] == "ok", res
    assert res["memory"]["peak_bytes_per_device"] >= \
        res["memory"]["argument_bytes_per_device"] > 0
    assert res["collectives"]["all_gather"]["count"] > 0


@pytest.mark.parametrize("arch,shape,match", [
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
