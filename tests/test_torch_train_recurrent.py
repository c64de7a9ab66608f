"""Port parity, the train step of the recurrent families: one
``train_step`` of the SMOKE config from the reference's converted state,
against ``repro.runtime.train.train_step`` on the same numpy batch — the
trainable leaves' names and shapes, loss and every metric, every
gradient, the new params, ``m`` and ``v`` (tolerances in
``torch_train_parity``).

jamba-v0.1 (Mamba, ``mamba_moe`` blocks, attention: its MoE aux terms
and router loss) and xlstm-1.3b (mLSTM, sLSTM) at ``xlstm_chunk`` 4,
below the 16-token batch, so the sLSTM's scan remats chunk by chunk and
the parallel mLSTM remats each of its chunks (the reference's two-level
scan and per-chunk checkpoint).
The reference's sLSTM padding (ROADMAP C) moves only its carried state,
so these outputs and gradients agree.
"""

import pytest

torch = pytest.importorskip("torch")
from torch_plan_isolation import (  # noqa: E402,F401  (autouse)
    isolated_plan_cache, isolated_plan_cache_module)
# one intra-op thread each: the suite runs in parallel workers
torch.set_num_threads(1)

from torch_train_parity import check_one_step  # noqa: E402


@pytest.mark.parametrize("arch,overrides", [
    ("jamba_v01", {}),
    ("xlstm_1b3", {"xlstm_chunk": 4}),
])
def test_train_step_matches_reference(arch, overrides):
    rep = check_one_step(arch, **overrides)
    assert rep["leaves"] > 0 and rep["widened"] < 0.01 * rep["elements"]
