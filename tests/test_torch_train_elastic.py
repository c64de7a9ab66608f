"""Elastic restore of a mesh training run (``runtime.driver.run`` with a
state on a mesh; ``checkpoint.CheckpointManager`` with shardings), as
``examples/multi_device_train.py`` runs the reference's: gemma-2b SMOKE
on the lcg stream, 4 steps, a checkpoint every 2.

* trained on (data=2, model=2), saved at step 2, then restored onto
  (data=4, model=1), onto (data=1, model=2) and onto one device (1x1),
  and continued: steps 3 and 4 within the parity tolerances
  (``tests/torch_train_parity.py``) of the uninterrupted single-device
  run, as is the uninterrupted (2, 2) run;
* a restore onto the same mesh is bit-exact: the restored leaves equal
  the saved ones, and the resumed steps' losses the uninterrupted (2, 2)
  run's;
* a single-device checkpoint restores onto (2, 2);
* with ``int8_pod`` on (pod=2, data=1, model=2), a restore onto the same
  mesh gives every rank its own blocks back bit for bit, the residual
  (each pod's own quantization error) included, and the resumed steps'
  losses equal the uninterrupted run's;
* a checkpoint whose leaves or shapes do not match the target raises,
  as does an ``int8_pod`` checkpoint of 2 pods restored onto a mesh
  without 'pod';
* a preemption seen by one rank stops every rank.

One spawn of four gloo ranks (``tests/torch_train_ranks.py``).
"""

import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_plan_isolation import (  # noqa: E402,F401  (autouse)
    isolated_plan_cache, isolated_plan_cache_module)
torch.set_num_threads(1)

import torch_train_parity as P  # noqa: E402
import torch_train_ranks as R  # noqa: E402
from repro_torch.launch.mesh import run_ranks  # noqa: E402


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("elastic")
    cfg, tcfg, data = R.elastic_setup()
    single = R.losses(R.drive(R.fresh_state(cfg, tcfg), cfg, tcfg, data,
                              str(root / "single_full"), R.STEPS))
    R.drive(R.fresh_state(cfg, tcfg), cfg, tcfg, data, str(root / "single"),
            2)
    ranks = run_ranks(R.elastic_rank, R.WORLD, str(root), timeout=300)
    mesh = dict(ranks[0], ranks=ranks)
    shutil.copytree(root / "a" / "step_000000002",
                    root / "to11" / "step_000000002")
    to11 = R.losses(R.drive(R.fresh_state(cfg, tcfg), cfg, tcfg, data,
                            str(root / "to11"), R.STEPS))
    return single, mesh, to11


def _close(got, want, steps):
    assert sorted(got) == list(steps), sorted(got)
    for s in steps:
        np.testing.assert_allclose(got[s], want[s], **P.TOL, err_msg=s)


def test_mesh_run_matches_single_device(runs):
    single, mesh, _ = runs
    _close(mesh["mesh22"], single, range(1, R.STEPS + 1))


@pytest.mark.parametrize("key", ["mesh41", "mesh12", "to11", "single_to_22"])
def test_restore_onto_another_mesh_continues(runs, key):
    single, mesh, to11 = runs
    got = to11 if key == "to11" else mesh[key]
    _close(got, single, range(3, R.STEPS + 1))


def test_restore_onto_the_same_mesh_is_exact(runs):
    _, mesh, _ = runs
    assert mesh["same_mesh_exact"]
    want = {s: v for s, v in mesh["mesh22"].items() if s > 2}
    assert mesh["resumed22"] == want


def test_int8_pod_restore_onto_the_same_mesh_is_exact(runs):
    _, mesh, _ = runs
    assert [r["pod_same_exact"] for r in mesh["ranks"]] == [True] * R.WORLD
    assert [r["pod_residual_nonzero"] for r in mesh["ranks"]] \
        == [True] * R.WORLD
    want = {s: v for s, v in mesh["pod"].items() if s > 2}
    assert mesh["pod_resumed"] == want


def test_preemption_on_one_rank_stops_every_rank(runs):
    """Only rank 1's stop flag is up: rank 0 stops too, at step 0, after
    writing its checkpoint (no rank waits on a collective another will
    never issue)."""
    _, mesh, _ = runs
    assert mesh["preempted"] == (True, 0, 0)


@pytest.mark.parametrize("key,match", [("leaves", "do not match"),
                                       ("shape", "does not cut"),
                                       ("pods", "does not cut")])
def test_mismatched_checkpoint_raises(runs, key, match):
    _, mesh, _ = runs
    assert mesh["errors"][key] is not None and match in mesh["errors"][key]
