"""MoE training on a mesh (``moe.moe_apply_tp``) against the port's
single-device step and the reference's ``repro.runtime.train.
train_step``, from the reference's init state, two steps of 4 x 16
tokens with ``microbatches=2`` and remat:

* qwen2-moe on (data=2, model=2): 6 experts over model=2, the 'ep'
  layout (3 experts a rank), its shared experts tensor-parallel;
* qwen2-moe on (data=1, model=4): 6 % 4 != 0, so the 'tp' layout (a
  block of every expert's hidden dim, ``down`` row-parallel), with
  ``capacity_factor`` 1 so slots are dropped;
* llama4-maverick on (data=2, model=2): qk-norm, a shared expert, top-1
  routing, 'ep' (4 experts a rank) beside dense attention blocks;
* qwen2-moe with a 30-wide expert hidden dim on (data=1, model=4): no
  layout divides, so every rank runs every expert (no reference run:
  the layouts above cover its code).

Each step's loss, metrics (``load_balance`` and ``dropped_frac`` the
whole batch's, not summed per rank), grad_norm (on every rank), every
gradient, m, v and params within the ``tests/torch_train_parity.py``
tolerances of the single-device step from the same (gathered) state;
step 1 within them of the reference's; the routers' gradients the single
device's, so the replicated routing is not summed over 'model' twice;
every rank issues the same collectives.  The residual splits its 16
positions over 'model' between blocks (each rank's block enters every
block), while each MoE FFN gathers its normed input and routes the whole
sequence: every step's routed slots (kept, all) equal the single
device's exactly.  On (data=2, model=2) the expert
stacks' out dim lies over 'data' ('ep'): the stacks stay cut there, no
all-gather of the step gives a whole stack leaf, and the tokens move to
them (their slots gathered, the hidden gathered for ``down``, the
outputs returned in an all-to-all).  One spawn of four gloo ranks runs
every case (``tests/torch_train_ranks.py``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_plan_isolation import (  # noqa: E402,F401  (autouse)
    isolated_plan_cache, isolated_plan_cache_module)
# one intra-op thread each: the suite runs in parallel workers
torch.set_num_threads(1)

import torch_train_mesh_check as C  # noqa: E402
import torch_train_parity as P  # noqa: E402
import torch_train_ranks as R  # noqa: E402
from repro_torch.launch.mesh import run_ranks  # noqa: E402

STEPS = 2
MB = {"microbatches": 2}
D2M2 = ((2, 2), ("data", "model"))
CASES = {
    "qwen2_moe-ep": C.case("qwen2_moe", *D2M2, MB, {"remat": True}),
    "qwen2_moe-tp": C.case("qwen2_moe", (1, 4), ("data", "model"), MB,
                           {"remat": True, "capacity_factor": 1.0}),
    "llama4-ep": C.case("llama4_maverick", *D2M2, MB, {"remat": True}),
    # neither 6 experts nor a 30-wide hidden dim divides model=4: every
    # rank runs every expert (its stacks gathered whole)
    "qwen2_moe-whole": C.case("qwen2_moe", (1, 4), ("data", "model"), MB,
                              {"remat": True, "moe_d_ff": 30}),
}
REF = [k for k in CASES if k != "qwen2_moe-whole"]


@pytest.fixture(scope="module")
def ranks():
    weights, batches = C.inputs(CASES, STEPS)
    return run_ranks(R.cases_rank, R.WORLD, CASES, weights, batches,
                     timeout=300)


@pytest.mark.parametrize("key", CASES)
def test_mesh_step_matches_single_device(ranks, key):
    C.matches_single_device(ranks, key, CASES[key], STEPS)


@pytest.mark.parametrize("key", REF)
def test_mesh_step_matches_reference(ranks, key):
    C.matches_reference(ranks, key, CASES[key], STEPS)


@pytest.mark.parametrize("key", CASES)
def test_ranks_issue_the_same_collectives(ranks, key):
    C.same_collectives(ranks, key)


@pytest.mark.parametrize("key", CASES)
def test_route_counts_equal_one_device(ranks, key):
    C.same_routes(ranks, key, CASES[key], STEPS)


@pytest.mark.parametrize("key", CASES)
def test_residual_enters_each_block_split(ranks, key):
    C.residual_blocks(ranks, key, CASES[key])


@pytest.mark.parametrize("key", CASES)
def test_aux_terms_are_global(ranks, key):
    """``load_balance`` and ``dropped_frac`` on the mesh are the single
    device's on the whole batch, on every rank: a sum of per-rank terms
    (each rank's rows' own means) would differ."""
    c = CASES[key]
    rec = ranks[0][key]["steps"][0]
    want = C.single_step(c, 0, rec["before"], STEPS)["metrics"]
    for res in ranks:
        if res[key] is None:
            continue
        got = res[key]["steps"][0]["metrics"]
        for k in ("load_balance", "dropped_frac"):
            np.testing.assert_allclose(got[k], want[k], **P.TOL, err_msg=k)
    assert want["load_balance"] > 0
    if c["over"].get("capacity_factor") == 1.0:
        assert want["dropped_frac"] > 0


@pytest.mark.parametrize("key", CASES)
def test_router_gradients_are_counted_once(ranks, key):
    """The routers' gradients (replicated over 'model': every rank holds
    the whole of each) equal the single device's: twice them would mean
    a second sum over 'model'."""
    c = CASES[key]
    rec = ranks[0][key]["steps"][0]
    want = C.single_step(c, 0, rec["before"], STEPS)["grads"]
    names = [n for n in want if n.endswith("router.w")]
    assert names and all(np.abs(want[n]).max() > 0 for n in names)
    C.close(rec["grads"], want, P.TOL, "router grad", names)


@pytest.mark.parametrize("key", ["qwen2_moe-ep", "llama4-ep"])
def test_stacks_stay_cut_and_tokens_move(ranks, key):
    for res in ranks:
        r = res[key]
        assert len(r["stacks"]) == 3 * _moe_layers(key)  # up, gate, down
        assert r["stacks_gathered"] == []
        for kind in ("expert_tokens", "expert_hidden", "expert_return"):
            assert r["counts"].get(kind, 0) > 0, kind


def _moe_layers(key) -> int:
    from repro_torch import configs

    cfg = configs.get_smoke(CASES[key]["arch"])
    return sum(cfg.kind(i) == "moe" for i in range(cfg.num_layers))
