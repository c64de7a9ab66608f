"""Port parity, the train step of the attention families but gemma-2b's
(which ``tests/test_torch_train.py`` holds further; the recurrent ones
are in ``tests/test_torch_train_recurrent.py``): one ``train_step`` of the
SMOKE config from the reference's converted state, against
``repro.runtime.train.train_step`` on the same numpy batch — the
trainable leaves' names and shapes, loss and every metric (the MoE
``load_balance`` and ``dropped_frac`` among them), every gradient, the
new params, ``m`` and ``v`` (tolerances in ``torch_train_parity``).

gemma2-9b (local/global attention, soft-caps), qwen2-moe (router, expert
stacks, shared experts, the router aux loss), whisper-medium (the
encoder, cross attention, learned positions) and phi-3-vision (patches
ahead of the text, IGNORE labels over them).  No router picks another
expert at this seed: the MoE metrics and gradients match within the
tolerance.
"""

import pytest

torch = pytest.importorskip("torch")
from torch_plan_isolation import (  # noqa: E402,F401  (autouse)
    isolated_plan_cache, isolated_plan_cache_module)
# one intra-op thread each: the suite runs in parallel workers
torch.set_num_threads(1)

from torch_train_parity import check_one_step  # noqa: E402


@pytest.mark.parametrize("arch", ["gemma2_9b", "qwen2_moe",
                                  "whisper_medium", "phi3_vision"])
def test_train_step_matches_reference(arch):
    rep = check_one_step(arch)
    assert rep["leaves"] > 0 and rep["widened"] < 0.01 * rep["elements"]
