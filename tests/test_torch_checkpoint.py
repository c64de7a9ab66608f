"""``repro_torch.checkpoint``: a torch model's ``state_dict`` round-trips
bit for bit (bf16 leaves included, stored as f32 as in the reference), a
corrupt step is quarantined and the older one restored, keep-last-k GC,
async save, and the on-disk layout the reference's manager writes and
checks (``step_N/manifest.json`` + ``leaf_NNNNN.npy``, CRC-stamped)."""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch import faults, obs  # noqa: E402
from repro_torch.checkpoint import (  # noqa: E402
    CheckpointCorrupt, CheckpointManager,
)
from repro_torch.core.spec import QuantSpec  # noqa: E402
from repro_torch.device import generator  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402

CFG = ModelConfig(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                  d_ff=128, vocab_size=211, max_seq_len=128)
MS = QuantSpec(mode="msgemm", d=3, scale_block=36)


@pytest.fixture(autouse=True)
def _disarmed():
    faults.disarm()
    yield
    faults.disarm()


def _model(seed=0):
    return T.init_params(CFG, generator=generator(seed, "cpu"),
                         device="cpu", quant=MS)


def _same(a: dict, b: dict) -> bool:
    return list(a) == list(b) and all(
        a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]) for k in a)


def test_state_dict_round_trips_bit_exactly(tmp_path):
    model = _model()
    state = model.state_dict()
    state["extra_bf16"] = torch.randn(5, 7, generator=generator(1, "cpu")
                                      ).to(torch.bfloat16)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(7, state, extra={"note": "x"})
    assert mgr.all_steps() == [7] and mgr.latest_step() == 7
    target = {k: torch.zeros_like(v) for k, v in state.items()}
    restored = mgr.restore(7, target)
    assert _same(restored, state)
    assert {v.dtype for v in restored.values()} >= {
        torch.int32, torch.float32, torch.bfloat16}
    # the layout: one .npy a leaf, names and CRCs in the manifest
    d = tmp_path / "step_000000007"
    man = json.loads((d / "manifest.json").read_text())
    assert man["step"] == 7 and man["extra"] == {"note": "x"}
    assert [m["name"] for m in man["leaves"]] == list(state)
    bf = next(m for m in man["leaves"] if m["name"] == "extra_bf16")
    assert bf["dtype"] == "bfloat16"
    assert np.load(d / bf["file"]).dtype == np.float32
    assert all("crc" in m for m in man["leaves"]) and "crc" in man
    # the restored state loads into a fresh model and serves the same
    other = _model(seed=5)
    other.load_state_dict({k: v for k, v in restored.items()
                           if k != "extra_bf16"})
    toks = torch.tensor([[3, 1, 4, 1, 5]], dtype=torch.int32)
    with torch.no_grad():
        assert torch.equal(T.forward(other, CFG.replace(quant=MS), toks),
                           T.forward(model, CFG.replace(quant=MS), toks))


def test_nested_tree_and_device_placement(tmp_path):
    tree = {"a": {"w": np.arange(6, dtype=np.int16).reshape(2, 3),
                  "t": torch.arange(4.0)},
            "b": torch.ones(2, dtype=torch.bfloat16)}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, tree)
    got = mgr.restore(1, tree, device="cpu")
    assert isinstance(got["a"]["w"], np.ndarray)
    assert got["a"]["w"].dtype == np.int16
    assert np.array_equal(got["a"]["w"], tree["a"]["w"])
    assert torch.equal(got["a"]["t"], tree["a"]["t"])
    assert got["b"].dtype == torch.bfloat16 and got["b"].device.type == "cpu"
    with pytest.raises(ValueError):
        mgr.restore(1, {"a": tree["a"]})  # leaves do not match
    with pytest.raises(ValueError):
        mgr.restore(1, {"a": {"w": np.zeros((3, 2), np.int16),
                              "t": tree["a"]["t"]}, "b": tree["b"]})


def test_corrupt_step_falls_back_to_older(tmp_path):
    state = _model().state_dict()
    mgr = CheckpointManager(str(tmp_path), keep=3)
    mgr.save(1, state)
    faults.arm("corrupt_checkpoint")
    mgr.save(2, state)
    faults.disarm()
    before = obs.registry().value(
        "counter", "artifact_quarantined_total", artifact="checkpoint",
        reason="corrupt") or 0
    step, restored = mgr.restore_latest(state)
    assert step == 1 and _same(restored, state)
    assert mgr.all_steps() == [1]
    assert (tmp_path / "step_000000002.quarantined").is_dir()
    assert obs.registry().value(
        "counter", "artifact_quarantined_total", artifact="checkpoint",
        reason="corrupt") == before + 1


def test_bit_rotted_leaf_is_caught(tmp_path):
    tree = {"w": torch.arange(12.0)}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, tree)
    mgr.save(2, {"w": torch.arange(12.0) * 2})
    leaf = tmp_path / "step_000000002" / "leaf_00000.npy"
    data = bytearray(leaf.read_bytes())
    data[-1] ^= 0xFF
    leaf.write_bytes(bytes(data))
    with pytest.raises(CheckpointCorrupt):
        mgr.restore(2, tree)
    step, got = mgr.restore_latest(tree)
    assert step == 1 and torch.equal(got["w"], tree["w"])
    assert mgr.restore_latest({"w": torch.zeros(12)})[0] == 1
    for s in mgr.all_steps():
        mgr.quarantine(s)
    assert mgr.restore_latest(tree) == (None, None)


def test_keep_last_k_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for step in (1, 2, 3, 5):
        mgr.save(step, {"w": torch.full((3,), float(step))})
    assert mgr.all_steps() == [3, 5]
    assert not [n for n in os.listdir(tmp_path) if n.endswith(".tmp")]
    assert torch.equal(mgr.restore(5, {"w": torch.zeros(3)})["w"],
                       torch.full((3,), 5.0))


def test_async_save(tmp_path):
    state = _model().state_dict()
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=True)
    mgr.save(1, state)
    mgr.save(2, state)  # joins the first write before starting
    mgr.wait()
    assert mgr.all_steps() == [1, 2]
    step, restored = mgr.restore_latest(state)
    assert step == 2 and _same(restored, state)
