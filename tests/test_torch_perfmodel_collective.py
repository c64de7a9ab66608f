"""The perf model's collective-time term (``repro_torch.obs.perfmodel``)
against the reference's (``repro.obs.perfmodel``) on the same rows:
``collective_features``, ``predict_collective``, ``fit_collective``
(the port's rows carry no ``interpret`` tag: a partition is the device
alone), the calibration's optional ``collective`` block (validation,
save and load; a file without it loads as before), the shard-variant
tuner's pruning (``dispatch.autotune._variant_prune``) against the
ranking by the reference's ``predict_collective``, and ``python -m
repro_torch.obs --calibrate`` fitting the block from a plan cache's
``shard_variants`` tables.  Everything here is exact.
"""

import itertools
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_plan_isolation import (  # noqa: E402,F401  (autouse)
    isolated_plan_cache, isolated_plan_cache_module)

from repro.distributed import collectives as jcoll  # noqa: E402
from repro.obs import perfmodel as jpm  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.dispatch import autotune as at  # noqa: E402
from repro_torch.dispatch.shard import ShardSpec  # noqa: E402
from repro_torch.obs import __main__ as obs_cli  # noqa: E402
from repro_torch.obs import perfmodel as pm  # noqa: E402

IMPLS = ("xla", "ring")
COLLECTIVES = ("psum", "reduce_scatter")
BLOCK = {"coll_call_s": 2.5e-5, "coll_hop_s": -4e-6, "coll_byte_s": 3e-10}


@pytest.mark.parametrize("impl,collective", list(itertools.product(
    IMPLS, COLLECTIVES)))
def test_collective_features_and_prediction_match_reference(impl,
                                                            collective):
    n = 0
    for axis, m, b, pc in itertools.product((1, 2, 4, 8), (24, 64, 2048),
                                            (1, 3, 16), (1, 2, 3, 4)):
        kw = dict(impl=impl, collective=collective, axis_size=axis, m=m,
                  b=b, pipeline_chunks=pc)
        got, want = pm.collective_features(**kw), \
            jpm.collective_features(**kw)
        assert got == want, kw
        args = dict(calls=got["calls"], hops=got["hops"],
                    nbytes=got["bytes"], collective=BLOCK)
        assert pm.predict_collective(**args) == \
            jpm.predict_collective(**args)
        n += 1
    assert n == 144
    assert pm.predict_collective(calls=3, hops=1, nbytes=1.0,
                                 collective={}) == 0.0


def _rows(seed: int, keys: int = 4, device: str = "cpu") -> list[dict]:
    """Shard-variant timing rows of ``keys`` keys, every grid entry once:
    times from a known collective term plus noise."""
    rng = np.random.default_rng(seed)
    rows = []
    for key in range(keys):
        m, b = 64 * (key + 1), 2 + key
        base = 1e-3 * (key + 1)
        for pc, impl in at.SHARD_VARIANT_GRID:
            f = pm.collective_features(impl=impl, collective="psum",
                                       axis_size=2, m=m, b=b,
                                       pipeline_chunks=pc)
            s = base + pm.predict_collective(calls=f["calls"],
                                             hops=f["hops"],
                                             nbytes=f["bytes"],
                                             collective=BLOCK)
            rows.append({"s": s + rng.normal(0, 1e-6), "pipeline_chunks": pc,
                         "collective_impl": impl, "hops": f["hops"],
                         "bytes": f["bytes"], "device": device,
                         "winner": False, "key": f"k{key}"})
    return rows


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fit_collective_matches_reference(seed):
    """The same rows (the reference's tagged with ``interpret``) give the
    reference's constants; rows of another device are left out; too few
    rows fit nothing on either side."""
    rows = _rows(seed) + _rows(seed + 10, keys=2, device="cuda:Other")
    ref_rows = [dict(r, interpret=True) for r in rows]
    got = pm.fit_collective(rows, device="cpu")
    want = jpm.fit_collective(ref_rows, device="cpu", interpret=True)
    assert got == want
    assert got["n_samples"] == 4 * (len(at.SHARD_VARIANT_GRID) - 1)
    for name in pm.COLLECTIVE_CONSTANT_NAMES:
        assert got[name] == pytest.approx(BLOCK[name], rel=0.2, abs=1e-9)
    # the device most rows name, when none is asked for
    assert pm.fit_collective(rows) == got
    few = rows[:3]
    assert pm.fit_collective(few, device="cpu") is None
    assert jpm.fit_collective([dict(r, interpret=True) for r in few],
                              device="cpu", interpret=True) is None


def _doc(**extra) -> dict:
    consts = {n: 1e-9 for n in pm.CONSTANT_NAMES}
    return {"version": pm.CALIBRATION_VERSION, "device": "cpu",
            "interpret": True, "constants": {"*": consts},
            "fit": {"n_samples": 3}, **extra}


BAD_BLOCKS = {
    "absent": None,
    "valid": dict(BLOCK, n_samples=12, rms_err_s=1e-6),
    "not_an_object": [1, 2],
    "nan": dict(BLOCK, coll_hop_s=float("nan"), n_samples=3),
    "non_numeric": dict(BLOCK, coll_byte_s="x", n_samples=3),
    "missing": {"coll_call_s": 1.0, "n_samples": 3},
    "no_n_samples": dict(BLOCK),
}


@pytest.mark.parametrize("case", sorted(BAD_BLOCKS))
def test_calibration_validation_matches_reference(case):
    block = BAD_BLOCKS[case]
    doc = _doc() if block is None else _doc(collective=block)
    got, want = pm.validate_calibration(doc), jpm.validate_calibration(doc)
    assert got == want
    assert (got == []) == (case in ("absent", "valid"))


def test_collective_block_saves_and_loads(tmp_path):
    """The block rides the file when fitted; a file without it loads with
    an empty block, as before."""
    cal = pm.Calibration(device="cpu", interpret=True,
                         constants={"*": {n: 1e-9
                                          for n in pm.CONSTANT_NAMES}},
                         fit={"n_samples": 3})
    plain = cal.save(tmp_path / "plain.json")
    assert "collective" not in json.loads(plain.read_text())
    assert pm.load_calibration(plain).collective == {}
    cal.collective = dict(BLOCK, n_samples=12, rms_err_s=1e-6)
    full = cal.save(tmp_path / "full.json")
    assert pm.validate_calibration_file(full) == []
    assert pm.load_calibration(full, device="cpu").collective == \
        cal.collective


SHARD = ShardSpec(mesh_axes=(("data", 2), ("model", 4)), k="model",
                  batch="data")


@pytest.mark.parametrize("m,batch", [(64, 4), (2048, 8), (512, 64)])
def test_variant_prune_keeps_the_reference_ranking(m, batch):
    """With a collective block the tuner times the ``MODEL_TOP_K``
    variants the reference's ``predict_collective`` ranks fastest, the
    one-shot always among them; without one it times every variant and
    counts the fallback."""
    variants = list(at.SHARD_VARIANT_GRID)
    kept = at._variant_prune(variants, SHARD, m, batch, "cpu", True,
                             "auto")
    assert kept == variants  # no calibration: every variant
    reg = obs.registry()
    assert reg.counter("dispatch_autotune_model_fallback_total",
                       backend="shard_variants").value >= 1
    pm.Calibration(device="cpu", interpret=True,
                   constants={"*": {n: 1e-9 for n in pm.CONSTANT_NAMES}},
                   fit={"n_samples": 3},
                   collective=dict(BLOCK, n_samples=12)).save(
        pm.default_calibration_path())

    def ref_pred(v):
        hops, nbytes = jcoll.collective_cost(
            impl=v[1], collective="psum", axis_size=4,
            elems=m * (batch // 2), pipeline_chunks=v[0])
        return jpm.predict_collective(calls=v[0], hops=hops, nbytes=nbytes,
                                      collective=BLOCK)

    want = sorted(variants, key=ref_pred)[:at.MODEL_TOP_K]
    if (1, "xla") not in want:
        want[-1] = (1, "xla")
    kept = at._variant_prune(variants, SHARD, m, batch, "cpu", True, "auto")
    assert kept == want and (1, "xla") in kept
    assert at._variant_prune(variants, SHARD, m, batch, "cpu", True,
                             "full") == variants


def test_calibrate_cli_fits_the_collective_block(tmp_path, capsys):
    """``--calibrate`` on a plan cache with kernel timings and
    ``shard_variants`` tables writes the block and prints how many
    variant rows it used; without tables the block is left out."""
    rows = _rows(3)
    kernel = [{"s": 1e-4 * (i + 1), "device": "cpu", "interpret": True,
               "winner": i == 0} for i in range(4)]
    key = ("cpu|msgemm_cuda|msgemm|d2|sb8|packed_idx|cbnone|m64|k64|b4|"
           "accfloat32|sh-")
    cache = at.PlanCache(tmp_path / "plans.json")
    cache.load()
    cache._timings[key] = kernel
    cache.save()
    bare = tmp_path / "bare.json"
    assert obs_cli.main(["--calibrate", "--plan-cache", str(cache.path),
                         "--calibration", str(bare)]) == 0
    assert "collective term not fitted (0 variant rows)" in \
        capsys.readouterr().out
    assert pm.load_calibration(bare).collective == {}
    for k in {r["key"] for r in rows}:
        cache.put_shard_variant(k, {"pipeline_chunks": 1,
                                    "collective_impl": "xla",
                                    "rows": [{n: v for n, v in r.items()
                                              if n != "key"}
                                             for r in rows
                                             if r["key"] == k]})
    out = tmp_path / "cal.json"
    assert obs_cli.main(["--calibrate", "--plan-cache", str(cache.path),
                         "--calibration", str(out)]) == 0
    text = capsys.readouterr().out
    n = 4 * (len(at.SHARD_VARIANT_GRID) - 1)
    assert f"collective term from {n} variant rows" in text
    cal = pm.load_calibration(out)
    assert cal.collective["n_samples"] == n
    assert cal.collective == pm.fit_collective(
        pm.collective_rows_from_plan_cache(cache.path), device="cpu")
    assert pm.validate_calibration_file(out) == []
