"""Recurrent training on a mesh against the port's single-device step and
the reference's ``repro.runtime.train.train_step``, from the reference's
init state, two steps of 4 x 16 tokens with ``microbatches=2`` and
remat, on (data=2, model=2) and (pod=2, data=1, model=2):

* jamba-v0.1: Mamba blocks on this rank's channels
  (``mamba.mamba_apply_tp``), ``mamba_moe`` blocks (Mamba, then the
  experts, 'ep'), an attention block;
* xlstm-1.3b: mLSTM blocks on this rank's heads
  (``xlstm.mlstm_block_apply_tp``) and the sLSTM whole on every rank;
  and with 2 heads on (data=1, model=4), where the channels split but
  the heads do not, the mLSTM gathered whole on every rank (no
  reference run for this one).

Each step's loss, metrics, grad_norm (on every rank), every gradient,
m, v and params within the ``tests/torch_train_parity.py`` tolerances of
the single-device step from the same (gathered) state; step 1 within
them of the reference's; the sLSTM's and the routers' gradients the
single device's (their consumers run replicated over 'model', so a sum
over it would count them twice); every rank issues the same
collectives; the residual enters every block (Mamba, MoE, attention,
mLSTM, sLSTM) as this rank's block of the 16 positions, each sequence
mixer gathering its normed input whole.  The two-halves leaves
(``in_proj``, ``xl_up``) are cut
from both halves and round-trip through ``gather_state`` /
``shard_state`` and a checkpoint restored onto one device and onto
(data=1, model=4), bit for bit.  One spawn of four gloo ranks runs it
all (``tests/torch_train_ranks.py``).
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
MB, REMAT = {"microbatches": 2}, {"remat": True}
MESHES = {"d2m2": ((2, 2), ("data", "model")),
          "p2d1m2": ((2, 1, 2), ("pod", "data", "model"))}
CASES = {f"{a}-{m}": C.case(a, *MESHES[m], MB, REMAT)
         for a in ("jamba_v01", "xlstm_1b3") for m in MESHES}
# xlstm with 2 heads on model=4: its channels split, its heads do not,
# so every rank gathers the mLSTM whole
CASES["xlstm_1b3-heads2-d1m4"] = C.case(
    "xlstm_1b3", (1, 4), ("data", "model"), MB,
    dict(REMAT, num_heads=2, num_kv_heads=2))
REF = [k for k in CASES if "heads2" not in k]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    weights, batches = C.inputs(CASES, STEPS)
    return run_ranks(R.cases_rank, R.WORLD, CASES, weights, batches,
                     str(tmp_path_factory.mktemp("halves")), timeout=300)


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
def test_residual_enters_each_block_split(ranks, key):
    C.residual_blocks(ranks, key, CASES[key])


@pytest.mark.parametrize("key", [k for k in CASES if k.startswith("jamba")])
def test_route_counts_equal_one_device(ranks, key):
    C.same_routes(ranks, key, CASES[key], STEPS)


@pytest.mark.parametrize("key", CASES)
def test_replicated_gradients_are_counted_once(ranks, key):
    """The leaves whose consumers run replicated over 'model' (the sLSTM's
    W, R and bias; a router) hold the single device's gradients: twice
    them would mean a second sum over 'model'."""
    c = CASES[key]
    rec = ranks[0][key]["steps"][0]
    want = C.single_step(c, 0, rec["before"], STEPS)["grads"]
    names = [n for n in want if ".sl_" in n or n.endswith("router.w")]
    assert names and all(np.abs(want[n]).max() > 0 for n in names)
    C.close(rec["grads"], want, P.TOL, "replicated grad", names)


@pytest.mark.parametrize("arch", ["jamba_v01", "xlstm_1b3"])
@pytest.mark.parametrize("check", ["block", "reshard", "onto_1x1",
                                   "onto_1x4"])
def test_two_halves_round_trip(ranks, arch, check):
    """``block``: every rank's ``in_proj`` / ``xl_up`` block is its
    channels of both halves; ``reshard``: gathered whole and cut again,
    the same blocks; ``onto_1x1`` / ``onto_1x4``: the (data=2, model=2)
    checkpoint restored onto one device, and onto (data=1, model=4) and
    gathered, gives the gathered leaves; each bit for bit."""
    got = [res["halves"][arch].get(check) for res in ranks]
    got = [g for g in got if g is not None]
    assert got and all(g == [] for g in got), got
