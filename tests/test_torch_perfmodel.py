"""Port parity, perf model: ``repro_torch.obs.perfmodel`` mirrors
tests/test_perfmodel.py (fit recovery on synthetic constants, calibration
round trip, partition and staleness, model-guided search against the full
search, the sentinel clean and with an injected x100 row, the obs CLI) on
the Hopper kernels' features, and holds the port against
``repro.obs.perfmodel`` where both compute the same thing: the fit on
identical feature rows, each package's validator on the other's
calibration, and the reference reading a snapshot the port's engine
wrote with tracing on.  The features themselves are the port's own
(counted from the Hopper grids), so they are checked for what they count.
"""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread each: the suite runs in parallel workers
torch.set_num_threads(1)

import jax  # noqa: E402

from repro import obs as jobs  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.config import ModelConfig as JConfig  # noqa: E402
from repro.obs import perfmodel as jpm  # noqa: E402
from repro.core.spec import QuantSpec as JSpec  # noqa: E402
from repro.quant import quantize_model as j_quantize  # noqa: E402
from repro_torch import convert, dispatch, obs  # noqa: E402
from repro_torch.core.spec import QuantSpec  # noqa: E402
from repro_torch.dispatch import autotune as at  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.int4_matmul import Int4Tiles  # noqa: E402
from repro_torch.kernels.msgemm import Tiles  # noqa: E402
from repro_torch.obs import perfmodel as pm  # noqa: E402
from repro_torch.serving import Engine, Request  # noqa: E402

MS = QuantSpec(mode="msgemm", d=3, scale_block=12)
I4 = QuantSpec(mode="int4_dequant", d=3, scale_block=32, storage="packed_u8")

# ground-truth constants of the synthetic clock: every "measured" time is
# the model at these, so a fit recovers them and the model's ranking is
# the timing ranking
SYNTH = {"launch_s": 1e-4, "step_s": 1e-5, "produce_s_per_flop": 2e-9,
         "consume_s_per_op": 1e-9, "hbm_s_per_byte": 5e-10}
SYNTH_CAL = pm.Calibration(device="cpu", interpret=True,
                           constants={"*": SYNTH},
                           fit={"n_samples": 99}, created_unix=1.0)


@pytest.fixture(autouse=True)
def _isolated(tmp_path, monkeypatch):
    """A fresh plan cache, no ambient calibration, empty registries."""
    monkeypatch.setenv("REPRO_PLAN_CACHE", str(tmp_path / "plans.json"))
    monkeypatch.setenv("REPRO_CALIBRATION", str(tmp_path / "calib.json"))
    dispatch.set_cache_path(None)
    for o in (obs, jobs):
        o.disable_tracing()
        o.registry().reset()
    yield
    obs.disable_tracing()
    dispatch.set_cache_path(None)
    dispatch.set_default_policy(None)


def _synth_time(feats) -> float:
    return sum(SYNTH[n] * feats[n] for n in pm.CONSTANT_NAMES)


def _sample(backend, spec, m, k, b, *, tiles=None, scale=1.0,
            device="cpu", interpret=True):
    feats = pm.features(backend, spec.mode, spec.d, spec.scale_block, m, k,
                        b, tiles=tiles, interpret=interpret)
    return pm.Sample(backend=backend, mode=spec.mode, d=spec.d,
                     scale_block=spec.scale_block, m=m, k=k, b=b,
                     measured_s=_synth_time(feats) * scale, device=device,
                     interpret=interpret, **at.tile_fields(tiles),
                     source=f"synth:{backend}.m{m}k{k}b{b}.{tiles}")


def _grid(interpret=True):
    out = []
    for m, k, b in [(16, 24, 8), (64, 24, 8), (16, 48, 8), (128, 96, 16),
                    (256, 24, 4), (1024, 600, 1)]:
        kc = -(-k // 3)
        for t in ops.msgemm_variants(m, kc, b, 3, 12)[:3]:
            out.append(_sample("msgemm_cuda", MS, m, k, b, tiles=t,
                               interpret=interpret))
        for t in ops.int4_variants(m, k * 8, b)[:3]:
            out.append(_sample("int4_cuda", I4, m, k * 8, b, tiles=t,
                               interpret=interpret))
    return out


def _patch_synthetic_clock(monkeypatch):
    """autotune's candidate timer replaced by the exact SYNTH model:
    deterministic, so winner comparisons cannot flake."""
    calls = []

    def fake_time(be, spec, p, copies, x, k, reps):
        m, b = copies[0]["scales"].shape[0], x.shape[0]
        d = dispatch.plan_d(spec, m, k)
        calls.append(p)
        return _synth_time(pm.features(be.name, spec.mode, d,
                                       spec.scale_block, m, k, b,
                                       tiles=p.tiles, interpret=True))

    monkeypatch.setattr(at, "_time_plan", fake_time)
    return calls


# ------------------------------------------------------------- features
def test_features_count_the_hopper_grids():
    """msGeMM: serial chunks from the split picker's makespan, one table
    per chunk per (row tile, column tile), a reduction launch and f32
    partials when split; int4: serial steps from its picker's cost."""
    kc = -(-2048 // 3)
    one = Tiles(tb=4, rows=1024, stage=8, tj=kc + 1)  # no split
    split = Tiles(tb=4, rows=1024, stage=8, tj=84)
    f1 = pm.features("msgemm_cuda", "msgemm", 3, 36, 2048, 2048, 4,
                     tiles=one)
    f2 = pm.features("msgemm_cuda", "msgemm", 3, 36, 2048, 2048, 4,
                     tiles=split)
    assert (f1["launch_s"], f2["launch_s"]) == (1.0, 2.0)
    assert f1["step_s"] == ops.msgemm_span(2048, kc, 4, 3, one)
    assert f2["step_s"] == ops.msgemm_span(2048, kc, 4, 3, split)
    assert f2["step_s"] < f1["step_s"]  # the split shortens the chain
    # 2 row tiles x 1 column tile x 683 chunks, one 4-column table each
    assert f1["produce_s_per_flop"] == 2.0 * (16 + 256 + 4096) * kc * 4 * 2
    assert f1["consume_s_per_op"] == 2048 * kc * 4
    nsplit = -(-kc // 84)
    assert f2["hbm_s_per_byte"] - f1["hbm_s_per_byte"] == \
        2 * 4.0 * nsplit * 2048 * 4
    t4 = Int4Tiles(tb=4, tk=2048, nsplit=4)
    f4 = pm.features("int4_cuda", "int4_dequant", 3, 36, 2048, 16384, 4,
                     tiles=t4)
    assert f4["step_s"] == ops.int4_span(2048, 16384, 4, t4)
    assert f4["launch_s"] == 2.0
    # None tiles price the heuristic's
    assert pm.features("int4_cuda", "int4_dequant", 3, 36, 2048, 16384, 4) \
        == pm.features("int4_cuda", "int4_dequant", 3, 36, 2048, 16384, 4,
                       tiles=ops.int4_tiles(2048, 16384, 4))
    # the plain versions' loops on the CPU: two ops a chunk and so on
    fp = pm.features("msgemm_cuda", "msgemm", 3, 36, 2048, 2048, 4,
                     tiles=one, interpret=True)
    assert fp["step_s"] == 2 * kc + 8 * 57 + 2


def test_predict_uncalibrated_falls_back_to_the_card_row():
    plan = dispatch.ExecPlan(backend="msgemm_cuda")
    c = pm.predict(plan, MS, 64, 24, 8)
    assert c.t_total_s > 0 and not c.calibrated and c.device == "cuda"
    feats = pm.features("msgemm_cuda", "msgemm", 3, 12, 64, 24, 8)
    assert c.t_hbm_s == pytest.approx(feats["hbm_s_per_byte"] / 3.35e12)
    c2 = pm.predict(plan, MS, 64, 24, 8, calib=SYNTH_CAL)
    assert c2.calibrated and c2.t_total_s > 0


# ---------------------------------------------------------- calibration
def test_calibration_fit_recovers_synthetic_constants():
    grid = _grid()
    cal = pm.fit(grid, device="cpu", interpret=True)
    assert cal.fit["n_samples"] == len(grid)
    assert cal.fit["max_abs_rel_err"] < 1e-6
    for s in grid[:6]:
        assert pm.predict_sample(s, cal).t_total_s == pytest.approx(
            s.measured_s, rel=1e-6)
    # the partition defaults to the one most samples belong to
    assert pm.fit(grid + _grid(interpret=False)[:3]).interpret is True


def test_calibration_roundtrip_identical_predictions(tmp_path):
    cal = pm.fit(_grid(), device="cpu", interpret=True)
    path = tmp_path / "c.json"
    cal.save(path)
    assert pm.validate_calibration_file(path) == []
    loaded = pm.load_calibration(path, device="cpu", interpret=True)
    assert loaded is not None
    for s in _grid():
        assert (pm.predict_sample(s, loaded).t_total_s
                == pm.predict_sample(s, cal).t_total_s)  # bitwise


def test_calibration_partition_and_staleness(tmp_path):
    cal = pm.fit(_grid(), device="cpu", interpret=True)
    path = tmp_path / "c.json"
    cal.save(path)
    card = "cuda:NVIDIA H100 80GB HBM3"
    assert pm.load_calibration(path, device=card, interpret=False) is None
    assert pm.load_calibration(path, device="cpu", interpret=False) is None
    assert pm.load_calibration(path, device="cpu", interpret=True)
    assert pm.load_calibration(path)  # no partition asked: any
    assert pm.load_calibration(path, max_age_s=1e-9) is None  # stale
    doc = json.loads(path.read_text())
    doc["version"] = 99
    doc.pop("crc")
    path.write_text(json.dumps(doc))
    assert pm.load_calibration(path, device="cpu", interpret=True) is None
    assert pm.validate_calibration_file(path)
    path.write_text("{not json")
    assert pm.load_calibration(path, device="cpu", interpret=True) is None
    assert list(tmp_path.glob("c.json.quarantined*"))


def test_fit_requires_samples_in_partition():
    wrong = [_sample("msgemm_cuda", MS, 16, 24, 8, interpret=False)
             for _ in range(5)]
    with pytest.raises(ValueError, match="needs >= 3 samples"):
        pm.fit(wrong, device="cpu", interpret=True)


# ------------------------------------------------- parity with the reference
def test_fit_constants_match_reference_on_identical_rows(monkeypatch):
    rng = np.random.default_rng(7)
    rows = rng.uniform(1.0, 1e6, size=(24, 5)) * np.array(
        [1.0, 1.0, 1e3, 1e2, 1e4])
    truth = np.array([3e-6, 2e-7, 1e-12, 4e-11, 2e-12])
    times = rows @ truth * rng.uniform(0.9, 1.1, size=24)
    feats = {f"r{i}": dict(zip(pm.CONSTANT_NAMES, map(float, r)))
             for i, r in enumerate(rows)}

    def ours():
        return [pm.Sample(backend="msgemm_cuda", mode="msgemm", d=3,
                          scale_block=36, m=1, k=1, b=1, measured_s=float(t),
                          device="cpu", interpret=True, source=f"r{i}")
                for i, t in enumerate(times)]

    def theirs():
        return [jpm.Sample(backend="msgemm_pallas", mode="msgemm", d=3,
                           scale_block=36, m=1, k=1, b=1,
                           measured_s=float(t), device="cpu",
                           interpret=True, source=f"r{i}")
                for i, t in enumerate(times)]

    monkeypatch.setattr(pm, "sample_features", lambda s: feats[s.source])
    monkeypatch.setattr(jpm, "sample_features", lambda s: feats[s.source])
    got, want = pm._fit_constants(ours()), jpm._fit_constants(theirs())
    assert set(got) == set(want) == set(pm.CONSTANT_NAMES)
    for name in pm.CONSTANT_NAMES:
        assert got[name] == pytest.approx(want[name], rel=1e-9, abs=1e-30)


def test_each_validator_accepts_the_others_calibration():
    ours = pm.fit(_grid(), device="cpu", interpret=True).as_dict()
    assert jpm.validate_calibration(json.loads(json.dumps(ours))) == []
    jgrid = [jpm.Sample(backend="msgemm_jnp", mode="msgemm", d=2,
                        scale_block=12, m=m, k=k, b=b,
                        measured_s=1e-4 + 1e-9 * m * k * b, device="cpu",
                        interpret=True, source=f"j{m}.{k}.{b}")
             for m, k, b in [(16, 24, 8), (64, 24, 8), (16, 48, 8),
                             (128, 96, 16), (256, 24, 64)]]
    theirs = jpm.fit(jgrid, device="cpu", interpret=True).as_dict()
    assert pm.validate_calibration(json.loads(json.dumps(theirs))) == []
    assert pm.validate_calibration({"version": 1}) != []


CFG = JConfig(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
              d_ff=128, vocab_size=211, max_seq_len=128)


def test_reference_reads_the_port_engines_snapshot():
    spec = JSpec(mode="msgemm", d=3, scale_block=36)
    jp = j_quantize(JT.init_params(jax.random.PRNGKey(0), CFG), CFG, spec)
    tcfg = convert.config_from_jax(CFG.replace(quant=spec))
    model = convert.params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                                    device="cpu")
    obs.enable_tracing(clear=True)
    eng = Engine(model, tcfg, max_slots=2, block_size=4, prefill_chunk=4,
                 max_model_len=32)
    eng.run([Request(rid=0, prompt=(5, 6, 7, 8, 9), max_new_tokens=3)])
    obs.disable_tracing()
    snap = json.loads(json.dumps(obs.registry().snapshot()))
    theirs = jpm.samples_from_snapshot(snap, device="cpu", interpret=True)
    ours = pm.samples_from_snapshot(snap, device="cpu", interpret=True)
    assert theirs and len(theirs) == len(ours)
    assert {(s.backend, s.m, s.k, s.b) for s in theirs} == \
        {(s.backend, s.m, s.k, s.b) for s in ours}
    assert all(s.backend == "msgemm_cuda" for s in theirs)
    # the port's samples carry the served tiles from the series' labels
    assert all(s.tiles == ops.msgemm_tiles(s.m, -(-s.k // 3), s.b, 3, 36)
               for s in ours)
    with pytest.raises(ValueError, match="partition"):
        pm.samples_from_snapshot(snap)


# ----------------------------------------------- model-guided autotune
SHAPES = [(1024, 96, 4), (2048, 96, 4), (1024, 120, 1)]


def test_model_guided_matches_full_search_winner(monkeypatch, tmp_path):
    SYNTH_CAL.save(tmp_path / "calib.json")
    calls = _patch_synthetic_clock(monkeypatch)
    for m, k, b in SHAPES:
        calls.clear()
        dispatch.set_cache_path(tmp_path / "full.json")
        full = at.autotune(MS, m, k, b, "msgemm_cuda", device_type="cpu",
                           search="full")
        n_full = len(calls)
        calls.clear()
        dispatch.set_cache_path(tmp_path / "model.json")
        guided = at.autotune(MS, m, k, b, "msgemm_cuda", device_type="cpu",
                             search="model")
        assert len(calls) <= at.MODEL_TOP_K < n_full
        assert guided == full
        d = dispatch.plan_d(MS, m, k)
        cands = at.candidate_plans(MS, d, m, k, b, "msgemm_cuda", "cpu")
        base = dispatch.heuristic_plan(MS, d, m, k, b, "msgemm_cuda")
        kept = at._model_prune(cands, MS, d, m, k, b, "msgemm_cuda", base,
                               SYNTH_CAL)
        assert full in kept and base in kept
    pruned = obs.registry().value(
        "counter", "dispatch_autotune_model_pruned_total",
        backend="msgemm_cuda")
    assert pruned > 0


def test_full_search_bypasses_model(monkeypatch, tmp_path):
    SYNTH_CAL.save(tmp_path / "calib.json")
    calls = _patch_synthetic_clock(monkeypatch)
    at.autotune(MS, *SHAPES[0], "msgemm_cuda", device_type="cpu",
                search="full")
    assert len(calls) > at.MODEL_TOP_K
    assert obs.registry().value(
        "counter", "dispatch_autotune_model_pruned_total",
        backend="msgemm_cuda") is None


def test_model_search_falls_back_without_calibration(monkeypatch):
    calls = _patch_synthetic_clock(monkeypatch)
    at.autotune(MS, *SHAPES[0], "msgemm_cuda", device_type="cpu",
                search="model")
    assert len(calls) > at.MODEL_TOP_K
    assert obs.registry().value(
        "counter", "dispatch_autotune_model_fallback_total",
        backend="msgemm_cuda") == 1


def test_timings_rows_carry_partition_and_tiles(monkeypatch):
    _patch_synthetic_clock(monkeypatch)
    at.autotune(MS, 16, 24, 8, "msgemm_cuda", device_type="cpu",
                search="full")
    key = at.cache().timing_keys()[0]
    rows = at.cache().timings(key)
    assert rows and sum(r["winner"] for r in rows) == 1
    for r in rows:
        assert r["interpret"] is True and r["device"] == "cpu"
        assert isinstance(at.tiles_from(r), Tiles)
    samples, untagged = pm.samples_from_plan_cache(at.cache().path)
    assert untagged == 0 and len(samples) == len(rows)
    assert {s.tiles for s in samples} == {at.tiles_from(r) for r in rows}


def test_samples_from_plan_cache_skips_untagged(monkeypatch):
    _patch_synthetic_clock(monkeypatch)
    at.autotune(MS, 16, 24, 8, "msgemm_cuda", device_type="cpu",
                search="full")
    path = at.cache().path
    doc = json.loads(path.read_text())
    key = next(iter(doc["timings"]))
    legacy = dict(doc["timings"][key][0])
    legacy.pop("interpret")
    doc["timings"][key].append(legacy)
    doc.pop("crc")  # hand-edited: drop the stamp
    path.write_text(json.dumps(doc))
    samples, untagged = pm.samples_from_plan_cache(path)
    assert untagged == 1
    assert len(samples) == len(doc["timings"][key]) - 1


def test_samples_from_bench_reads_profile_gemm_rows(tmp_path):
    rows = [ops.profile_gemm("msgemm", 32, 48, 4, d=3, scale_block=12,
                             reps=1, device="cpu"),
            ops.profile_gemm("int4", 32, 64, 2, scale_block=32, reps=1,
                             device="cpu")]
    assert rows[0]["kind"] == "msgemm" and rows[0]["interpret"] is True
    assert rows[0]["hardware"] == "cpu-host" and rows[0]["measured_s"] > 0
    hists = [r for r in obs.registry().snapshot()["histograms"]
             if r["name"] == "kernel_profile_s"]
    assert sorted(r["labels"]["kind"] for r in hists) == ["int4", "msgemm"]
    path = tmp_path / "bench.json"
    path.write_text(json.dumps(rows))
    samples = pm.samples_from_bench(path)
    assert [(s.backend, s.m, s.k, s.b, s.device) for s in samples] == [
        ("msgemm_cuda", 32, 48, 4, "cpu"), ("int4_cuda", 32, 64, 2, "cpu")]


# ------------------------------------------------------------- sentinel
def test_sentinel_passes_clean_and_flags_injected_regression():
    grid = _grid()
    cal = pm.fit(grid, device="cpu", interpret=True)
    clean = pm.check_regressions(grid, cal)
    assert clean["ok"] and clean["n_outliers"] == 0
    assert clean["n_samples"] == len(grid)
    slowed = list(grid)
    slowed[5] = dataclasses.replace(slowed[5],
                                    measured_s=slowed[5].measured_s * 100)
    report = pm.check_regressions(slowed, cal)
    assert not report["ok"] and report["n_outliers"] == 1
    assert report["rows"][0]["outlier"]
    assert report["rows"][0]["source"] == slowed[5].source
    text = pm.render_report(report)
    assert "REGRESSION" in text and "OUTLIER" in text


def test_sentinel_skips_other_partition_and_fast_rows_pass():
    cal = pm.fit(_grid(), device="cpu", interpret=True)
    mixed = [_sample("msgemm_cuda", MS, 16, 24, 8, interpret=False),
             _sample("msgemm_cuda", MS, 16, 24, 8, scale=0.01)]
    report = pm.check_regressions(mixed, cal)
    assert report["ok"]
    assert report["n_skipped_other_partition"] == 1
    assert report["n_fast"] == 1


def test_samples_from_snapshot_requires_labels():
    reg = obs.Registry()
    reg.histogram("kernel_gemm_s", help="t", backend="msgemm_cuda",
                  m=16, k=24, b=8, mode="msgemm", d=3, sb=12,
                  tiles="tb=4,rows=512,stage=16,tj=8").observe(0.5)
    reg.histogram("kernel_gemm_s", help="t", backend="msgemm_cuda",
                  m=16, k=24, b=8).observe(0.5)  # pre-tag series
    samples = pm.samples_from_snapshot(reg.snapshot(), device="cpu",
                                       interpret=True)
    assert len(samples) == 1
    s = samples[0]
    assert (s.mode, s.d, s.scale_block) == ("msgemm", 3, 12)
    assert s.tiles == Tiles(4, 512, 16, 8)
    assert s.measured_s == pytest.approx(0.5)


# ------------------------------------------------------------------ CLI
def test_obs_cli_calibrate_and_check_regressions(monkeypatch, tmp_path,
                                                 capsys):
    from repro_torch.obs.__main__ import main as obs_main

    _patch_synthetic_clock(monkeypatch)
    for m, k, b in [(16, 24, 8), (64, 24, 8), (32, 48, 16)]:
        at.autotune(MS, m, k, b, "msgemm_cuda", device_type="cpu",
                    search="full")
    cache_path = str(at.cache().path)
    calib = str(tmp_path / "cli_calib.json")
    assert obs_main(["--calibrate", "--plan-cache", cache_path,
                     "--calibration", calib]) == 0
    assert obs_main(["--validate-calibration", calib]) == 0
    report = str(tmp_path / "report.md")
    assert obs_main(["--check-regressions", "--plan-cache", cache_path,
                     "--calibration", calib, "--report-out",
                     report]) == 0
    assert "verdict: OK" in open(report).read()
    # one timing row's s x100, the CRC field dropped: exit 1
    doc = json.loads(open(cache_path).read())
    key = next(iter(doc["timings"]))
    doc["timings"][key][0]["s"] *= 100
    doc.pop("crc")
    slow = tmp_path / "slow.json"
    slow.write_text(json.dumps(doc))
    capsys.readouterr()
    assert obs_main(["--check-regressions", "--plan-cache", str(slow),
                     "--calibration", calib]) == 1
    assert "OUTLIER" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        obs_main([])  # nothing to do
