"""Port parity, the plan layer: ``core.complexity``, ``obs.artifacts``,
``obs.costs``, ``dispatch.plan`` (ExecPolicy, plan keys, collection, the
memoized ``plan()``, quarantine) and ``dispatch.autotune`` (the plan
cache, the Hopper candidates, the CLI smoke) against the JAX package
where both compute the same thing (mirrors tests/test_dispatch.py and
tests/test_obs.py's cost tests); and the engine with ``autotune=True``:
plans resolved at build, no plan-cache miss on its first step on either
route, no tuning inside a capture, a rebuild that times nothing, and the
reference engine's greedy tokens."""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread each: the suite runs in parallel workers
torch.set_num_threads(1)

import jax  # noqa: E402

from repro.core import complexity as jcx  # noqa: E402
from repro.core.spec import QuantSpec as JSpec  # noqa: E402
from repro.dispatch import plan_key as j_plan_key  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.config import ModelConfig as JConfig  # noqa: E402
from repro.obs import artifacts as jart  # noqa: E402
from repro.obs import costs as jcosts  # noqa: E402
from repro.quant import quantize_model as j_quantize  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro_torch import convert, dispatch, obs  # noqa: E402
from repro_torch.core import complexity as cx  # noqa: E402
from repro_torch.core import linear as t_linear  # noqa: E402
from repro_torch.core.epilogue import Epilogue  # noqa: E402
from repro_torch.core.spec import DENSE, QuantSpec, as_spec  # noqa: E402
from repro_torch.dispatch import ExecPlan, ExecPolicy, registry  # noqa: E402
from repro_torch.dispatch import autotune as at  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.int4_matmul import Int4Tiles  # noqa: E402
from repro_torch.kernels.msgemm import Tiles  # noqa: E402
from repro_torch.obs import artifacts, costs  # noqa: E402
from repro_torch.serving import Engine, Request  # noqa: E402

MS = QuantSpec(mode="msgemm", d=3, scale_block=12)
I4 = QuantSpec(mode="int4_dequant", d=3, scale_block=12, storage="packed_u8")


@pytest.fixture(autouse=True)
def _isolated(tmp_path, monkeypatch):
    """Every test gets its own plan-cache file and calibration path, an
    empty registry, and leaves the default policy and quarantine as it
    found them."""
    monkeypatch.setenv("REPRO_PLAN_CACHE", str(tmp_path / "plans.json"))
    monkeypatch.setenv("REPRO_CALIBRATION", str(tmp_path / "calib.json"))
    dispatch.set_cache_path(None)
    obs.disable_tracing()
    obs.registry().reset()
    yield
    dispatch.set_cache_path(None)
    dispatch.set_default_policy(None)
    dispatch.clear_quarantine()


def _count(name, **labels):
    return obs.registry().value("counter", name, **labels) or 0


# ------------------------------------------------------------ complexity
@pytest.mark.parametrize("d", [1, 2, 3, 4])
def test_complexity_equals_reference(d):
    for m in (1, 16, 256, 2048, 16384):
        for k in (4, 24, 2048, 16384):
            for b in (1, 4, 8):
                assert cx.c_lut(k, d) == jcx.c_lut(k, d)
                assert cx.m_lut(k) == jcx.m_lut(k)
                assert cx.c_consume(m, k, d) == jcx.c_consume(m, k, d)
                assert cx.m_consume(m, k) == jcx.m_consume(m, k)
                assert cx.c_msgemm(m, k, b, d) == jcx.c_msgemm(m, k, b, d)
                assert cx.c_gemm(m, k, b) == jcx.c_gemm(m, k, b)
                assert cx.m_msgemm(m, k, b) == jcx.m_msgemm(m, k, b)
                assert cx.m_gemm(m, k, b) == jcx.m_gemm(m, k, b)
                assert cx.speedup(m, k, b, d) == jcx.speedup(m, k, b, d)
                assert cx.lut_bytes(k, d, b) == jcx.lut_bytes(k, d, b)
        assert cx.best_d(m, 2048) == jcx.best_d(m, 2048)
        assert cx.best_d(m, 2048, range(2, 5)) == \
            jcx.best_d(m, 2048, range(2, 5))


@pytest.mark.parametrize("d", [1, 2, 3])
def test_counted_msgemm_equals_reference(d):
    rng = np.random.default_rng(d)
    codes = rng.integers(0, 16, size=(5, 6 * d)).astype(np.uint8)
    x = rng.standard_normal((6 * d, 2)).astype(np.float32)
    y, counts = cx.counted_msgemm(codes, x, d)
    jy, jcounts = jcx.counted_msgemm(codes, x, d)
    np.testing.assert_array_equal(y, jy)
    assert counts == cx.OpCounts(**dataclasses.asdict(jcounts))
    assert counts.total_compute == jcounts.total_compute
    w = rng.standard_normal((5, 6 * d))
    gy, gcounts = cx.counted_gemm(w, x)
    jgy, jgcounts = jcx.counted_gemm(w, x)
    np.testing.assert_array_equal(gy, jgy)
    assert dataclasses.asdict(gcounts) == dataclasses.asdict(jgcounts)


def test_resolve_d_unchanged_and_spec_helpers():
    for sb in (12, 24, 36):
        spec, jspec = (S(mode="msgemm", d="adaptive", scale_block=sb)
                       for S in (QuantSpec, JSpec))
        for m in (16, 256, 2048, 16384, 256000):
            for k in (24, 2048, 16384):
                assert spec.resolve_d(k, m) == jspec.resolve_d(k, m)
    assert MS.with_mode("int4_dequant") == QuantSpec(
        mode="int4_dequant", d=3, scale_block=12)
    assert as_spec(MS) is MS
    with pytest.raises(TypeError):
        as_spec("msgemm")


# ------------------------------------------------------------- artifacts
PAYLOAD = {"version": 3, "plans": {"a|b": {"tb": 4, "rows": 1024}},
           "timings": {"a|b": [{"s": 1.5e-05, "winner": True}]}}


def test_payload_crc_equal_across_packages():
    assert artifacts.payload_crc(PAYLOAD) == jart.payload_crc(PAYLOAD)
    stamped = artifacts.stamp_crc(json.loads(json.dumps(PAYLOAD)))
    assert jart.check_crc(stamped) and artifacts.check_crc(stamped)
    theirs = jart.stamp_crc(json.loads(json.dumps(PAYLOAD)))
    assert theirs["crc"] == stamped["crc"] and artifacts.check_crc(theirs)
    assert artifacts.check_crc(dict(PAYLOAD))  # legacy: no stamp
    assert not artifacts.check_crc(dict(stamped, version=4))


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_stamped_file_passes_the_other_package(tmp_path, writer):
    path = tmp_path / "a.json"
    mod, other = (artifacts, jart) if writer == "port" else (jart, artifacts)
    mod.atomic_write_json(path, mod.stamp_crc(json.loads(json.dumps(
        PAYLOAD))))
    assert other.load_json_checked(path, "plan_cache")["plans"] == \
        PAYLOAD["plans"]


def test_corrupt_artifact_is_quarantined(tmp_path):
    path = tmp_path / "c.json"
    doc = artifacts.stamp_crc(json.loads(json.dumps(PAYLOAD)))
    doc["plans"]["a|b"]["tb"] = 8  # bit rot after the stamp
    path.write_text(json.dumps(doc))
    assert artifacts.load_json_checked(path, "plan_cache") is None
    assert not path.exists() and (tmp_path / "c.json.quarantined").exists()
    assert _count("artifact_quarantined_total", artifact="plan_cache",
                  reason="crc") == 1
    assert artifacts.load_json_checked(path, "plan_cache") is None  # gone


# ------------------------------------------------------------------ costs
@pytest.mark.parametrize("d", [1, 2, 4])
def test_costs_equal_reference(d):
    assert costs.produce_table_ops(d) == jcosts.produce_table_ops(d)
    assert costs.lut_bytes(2048, 8, d) == jcosts.lut_bytes(2048, 8, d)
    for quant in ("msgemm", "int4_dequant", "bf16"):
        assert costs.gemm_cost(2048, 768, 8, quant=quant, d=d) == \
            jcosts.gemm_cost(2048, 768, 8, quant=quant, d=d)
    row = costs.annotate(1e-3, 2048, 768, 8, d=d, dev=costs.device("cpu"))
    want = jcosts.annotate(1e-3, 2048, 768, 8, d=d,
                           dev=jcosts.DEVICES["cpu"])
    assert row == want


def test_card_row_is_the_h100_sxm():
    h100 = costs.DEVICES["cuda"]
    assert (h100.mem_bw, h100.vector_flops, h100.matmul_flops) == \
        (3.35e12, 67e12, 989e12)
    assert costs.device() is h100 and costs.device("mps") is \
        costs.DEVICES["cpu"]
    assert set(costs.DEVICES) == {"cuda", "cpu"}  # no TPU or A100 row
    cost = costs.gemm_cost(2048, 2048, 4, d=3)
    assert costs.attainable_s(cost) == max(
        cost["produce_flops"] / 989e12 + cost["consume_ops"] / 67e12,
        cost["bytes"] / 3.35e12)


# ------------------------------------------------------------------- plan
def test_plan_key_has_the_reference_field_order():
    for spec, jspec in ((MS, JSpec(mode="msgemm", d=3, scale_block=12)),
                        (I4, JSpec(mode="int4_dequant", d=3, scale_block=12,
                                   storage="packed_u8"))):
        got = dispatch.plan_key("x_cuda", spec, 3, 16, 24, 8,
                                "cuda:NVIDIA H100 80GB HBM3")
        assert got == j_plan_key("x_cuda", jspec, 3, 16, 24, 8,
                                 "cuda:NVIDIA H100 80GB HBM3")
        assert got.endswith("|accfloat32|sh-")
    assert dispatch.device_name("cpu") == "cpu"


def test_plan_is_frozen_hashable_and_the_heuristic():
    p = dispatch.plan(MS, 64, 72, 16, device_type="cpu")
    assert isinstance(hash(p), int) and p.source == "heuristic"
    with pytest.raises(dataclasses.FrozenInstanceError):
        p.backend = "dense"
    assert p.tiles == ops.msgemm_tiles(64, 24, 16, 3, 12) and p.epilogue
    p4 = dispatch.plan(I4, 64, 72, 16, device_type="cpu")
    assert p4 == ExecPlan("int4_cuda", tiles=ops.int4_tiles(64, 72, 16))
    assert dispatch.plan(DENSE, 64, 72, 16, device_type="cpu") == \
        ExecPlan("dense")
    with pytest.raises(ValueError):
        ExecPolicy(acc_dtype="bfloat16")  # both kernels accumulate in f32
    with pytest.raises(ValueError):
        ExecPolicy(autotune="fast")


def test_memoized_plan_counts_once_per_key():
    for _ in range(5):
        dispatch.plan(MS, 16, 24, 8, device_type="cpu")
    assert _count("dispatch_backend_selected_total",
                  backend="msgemm_cuda") == 1
    assert _count("dispatch_plan_cache_total", result="miss") == 1
    dispatch.plan(MS, 16, 24, 4, device_type="cpu")  # another key
    assert _count("dispatch_plan_cache_total", result="miss") == 2
    dispatch.set_cache_path(None)  # the memo is dropped with the cache
    dispatch.plan(MS, 16, 24, 8, device_type="cpu")
    assert _count("dispatch_backend_selected_total",
                  backend="msgemm_cuda") == 3


def test_explicit_plan_override_and_epilogue_flag():
    rng = np.random.default_rng(3)
    w = torch.from_numpy(rng.standard_normal((16, 24)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((2, 5, 24)).astype(np.float32))
    p = t_linear.from_dense(w, MS)
    want = t_linear.apply(p, x, MS, in_dim=24)
    tiles = Tiles(tb=4, rows=512, stage=16, tj=4)
    plan = ExecPlan("msgemm_cuda", tiles=tiles, source="explicit")
    with dispatch.using_policy(ExecPolicy(plan=plan)):
        assert dispatch.plan(MS, 16, 24, 10) is plan
        got = t_linear.apply(p, x, MS, in_dim=24)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    ep = Epilogue(act="relu", residual=True)
    res = torch.from_numpy(rng.standard_normal((2, 5, 16)).astype(
        np.float32))
    fused = dispatch.execute(p, x, MS, in_dim=24, plan_override=plan,
                             epilogue=ep, residual=res)
    unfused = dispatch.execute(
        p, x, MS, in_dim=24, epilogue=ep, residual=res,
        plan_override=dataclasses.replace(plan, epilogue=False))
    torch.testing.assert_close(fused, unfused, rtol=2e-5, atol=2e-5)
    assert _count("dispatch_epilogue_total", fused="true") == 1
    assert _count("dispatch_epilogue_total", fused="false") == 1


def test_using_policy_is_scoped():
    pol = ExecPolicy(backend="msgemm_cuda", autotune="full")
    with dispatch.using_policy(pol):
        assert dispatch.get_default_policy() is pol
        with dispatch.using_policy(None):  # None leaves it
            assert dispatch.get_default_policy() is pol
    assert dispatch.get_default_policy() is dispatch.DEFAULT_POLICY
    with pytest.raises(RuntimeError):
        with dispatch.using_policy(pol):
            raise RuntimeError("boom")
    assert dispatch.get_default_policy() is dispatch.DEFAULT_POLICY


def test_forced_backend_falls_back_for_specs_it_cannot_run():
    pol = ExecPolicy(backend="int4_cuda")
    assert dispatch.plan(MS, 16, 24, 8, device_type="cpu",
                         policy=pol).backend == "msgemm_cuda"
    assert dispatch.plan(I4, 16, 24, 8, device_type="cpu",
                         policy=pol).backend == "int4_cuda"
    assert dispatch.plan(DENSE, 16, 24, 8, device_type="cpu",
                         policy=pol).backend == "dense"
    with pytest.raises(ValueError, match="unknown backend"):
        dispatch.plan(MS, 16, 24, 8, policy=ExecPolicy(backend="nope"))


def test_quarantine_skips_a_backend_and_never_empties_selection():
    alt = registry.register_backend(
        "msgemm_alt", modes=("msgemm",), run=registry.get_backend(
            "msgemm_cuda").run, priority=55)
    try:
        assert dispatch.plan(MS, 16, 24, 8,
                             device_type="cpu").backend == "msgemm_cuda"
        dispatch.quarantine_backend("msgemm_cuda", "nan logits")
        assert dispatch.is_quarantined("msgemm_cuda")
        assert dispatch.quarantined() == {"msgemm_cuda": "nan logits"}
        assert obs.registry().value(
            "gauge", "dispatch_backends_quarantined") == 1
        assert _count("dispatch_backend_quarantined_total",
                      backend="msgemm_cuda") == 1
        # the memo was dropped: the next resolution skips it
        assert dispatch.plan(MS, 16, 24, 8,
                             device_type="cpu").backend == alt.name
        forced = ExecPolicy(backend="msgemm_cuda")
        assert dispatch.plan(MS, 16, 24, 8, device_type="cpu",
                             policy=forced).backend == alt.name
        dispatch.quarantine_backend("int4_cuda")
        assert dispatch.plan(I4, 16, 24, 8,
                             device_type="cpu").backend == "int4_torch"
        dispatch.quarantine_backend("int4_torch")  # down the ladder
        assert dispatch.plan(I4, 16, 24, 8,
                             device_type="cpu").backend == "dense_fallback"
        dispatch.quarantine_backend("dense_fallback")  # every int4 path
        assert dispatch.plan(I4, 16, 24, 8,
                             device_type="cpu").backend == "int4_cuda"
        dispatch.clear_quarantine()
        assert dispatch.plan(MS, 16, 24, 8,
                             device_type="cpu").backend == "msgemm_cuda"
        assert obs.registry().value(
            "gauge", "dispatch_backends_quarantined") == 0
        with pytest.raises(ValueError):
            dispatch.quarantine_backend("no-such-backend")
    finally:
        registry._REGISTRY.pop("msgemm_alt", None)
        dispatch.clear_quarantine()


def test_plan_never_tunes_while_a_graph_is_captured(monkeypatch):
    pol = ExecPolicy(autotune=True)
    before = at.num_timed_candidates
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    p = dispatch.plan(MS, 64, 72, 4, device_type="cpu", policy=pol)
    assert p.source == "heuristic" and at.num_timed_candidates == before
    assert len(dispatch.cache()) == 0
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    # the heuristic was not memoized: outside the capture it tunes
    p = dispatch.plan(MS, 64, 72, 4, device_type="cpu", policy=pol)
    assert p.source == "autotuned" and at.num_timed_candidates > before


def test_collecting_records_requests_and_counts_nothing():
    before = at.num_timed_candidates
    with dispatch.collecting() as reqs:
        dispatch.plan(MS, 16, 24, 8, device_type="cpu")
        dispatch.plan(MS, 16, 24, 8, device_type="cpu",
                      policy=ExecPolicy(autotune=True))
    assert len(reqs) == 2 and at.num_timed_candidates == before
    assert reqs[0] == dispatch.PlanRequest(MS, 16, 24, 8, "msgemm_cuda",
                                           "cpu")
    assert _count("dispatch_plan_cache_total", result="miss") == 0
    warmed = dispatch.warm(reqs)
    assert len(warmed) == 1  # deduped
    (key, plan), = warmed.items()
    assert key == dispatch.plan_key("msgemm_cuda", MS, 3, 16, 24, 8, "cpu")
    assert plan.source == "heuristic" and len(dispatch.cache()) == 0


# --------------------------------------------------------------- autotune
def test_autotune_persists_and_reloads(tmp_path):
    cache_file = tmp_path / "c.json"
    dispatch.set_cache_path(cache_file)
    p1 = at.autotune(MS, 16, 24, 8, "msgemm_cuda", device_type="cpu",
                     reps=1)
    assert p1.source == "autotuned" and cache_file.exists()
    raw = json.loads(cache_file.read_text())
    assert raw["version"] == 3 and len(raw["plans"]) == 1 and raw["crc"]
    (key, fields), = raw["plans"].items()
    assert key == "cpu|msgemm_cuda|msgemm|d3|sb12|packed_idx|cbnone|m16|" \
                  "k24|b8|accfloat32|sh-"
    assert set(fields) == {"backend", "epilogue", "tb", "rows", "stage",
                           "tj"}
    rows = raw["timings"][key]
    assert len(rows) == len(at.candidate_plans(MS, 3, 16, 24, 8,
                                               "msgemm_cuda", "cpu"))
    dispatch.set_cache_path(cache_file)  # a fresh view of the same file
    before = at.num_timed_candidates
    p2 = at.autotune(MS, 16, 24, 8, "msgemm_cuda", device_type="cpu")
    assert p2 == p1 and p2.tiles == p1.tiles
    assert at.num_timed_candidates == before  # nothing timed again


def test_autotuned_plan_flows_through_plan():
    pol = ExecPolicy(autotune=True)
    p = dispatch.plan(I4, 16, 1024, 4, device_type="cpu", policy=pol)
    assert p.source == "autotuned" and isinstance(p.tiles, Int4Tiles)
    timed = at.num_timed_candidates
    assert dispatch.plan(I4, 16, 1024, 4, device_type="cpu",
                         policy=pol) == p
    # a policy without tuning reads the same cache entry
    assert dispatch.plan(I4, 16, 1024, 4, device_type="cpu") == p
    assert at.num_timed_candidates == timed


@pytest.mark.parametrize("mode", ["msgemm", "int4"])
def test_candidates_include_the_heuristic(mode):
    if mode == "msgemm":
        spec, backend, m, k, b = MS, "msgemm_cuda", 16384, 2048, 1
        variants = ops.msgemm_variants(m, -(-k // 3), b, 3, 12)
    else:
        spec, backend, m, k, b = I4, "int4_cuda", 2048, 16384, 4
        variants = ops.int4_variants(m, k, b)
    card = at.candidate_plans(spec, 3, m, k, b, backend, "cuda")
    base = dispatch.heuristic_plan(spec, 3, m, k, b, backend)
    assert base in card and [p.tiles for p in card] == variants
    assert len(card) > at.CPU_CANDIDATES
    cpu = at.candidate_plans(spec, 3, m, k, b, backend, "cpu")
    assert base in cpu and len(cpu) <= at.CPU_CANDIDATES + 1
    assert at.candidate_plans(DENSE, 0, m, k, b, "dense") == \
        [ExecPlan("dense")]


@pytest.mark.parametrize("kind", ["garbage", "newer-version", "schema",
                                  "crc"])
def test_corrupt_or_unknown_cache_degrades_to_empty(tmp_path, kind):
    path = tmp_path / "p.json"
    good = {"version": 3, "plans": {"k": {"backend": "dense",
                                          "epilogue": True}}}
    text = {"garbage": "{not json",
            "newer-version": json.dumps(dict(good, version=9)),
            "schema": json.dumps({"version": 3, "plans": {"k": {}}}),
            "crc": json.dumps(dict(good, crc="00000000"))}[kind]
    path.write_text(text)
    c = dispatch.PlanCache(path)
    assert len(c) == 0 and c.get("k") is None
    quarantined = kind != "newer-version"
    assert (tmp_path / "p.json.quarantined").exists() == quarantined
    c.put("k", ExecPlan("dense"))  # rebuilds
    assert dispatch.PlanCache(path).get("k") == ExecPlan("dense")


def test_tiles_round_trip_through_the_json(tmp_path):
    path = tmp_path / "p.json"
    c = dispatch.PlanCache(path)
    ms_plan = ExecPlan("msgemm_cuda", tiles=Tiles(4, 1024, 8, 96),
                       epilogue=False)
    i4_plan = ExecPlan("int4_cuda", tiles=Int4Tiles(8, 1024, 3))
    c.put("a", ms_plan)
    c.put("b", i4_plan, timings=[{"s": 1e-5, "tb": 8, "tk": 1024,
                                  "nsplit": 3, "winner": True,
                                  "interpret": False, "device": "x"}])
    again = dispatch.PlanCache(path)
    a, b = again.get("a"), again.get("b")
    assert type(a.tiles) is Tiles and a == ms_plan and a.epilogue is False
    assert type(b.tiles) is Int4Tiles and b == i4_plan
    assert a.source == b.source == "autotuned"
    assert at.tiles_from(again.timings("b")[0]) == Int4Tiles(8, 1024, 3)


def test_dispatch_cli_smoke(tmp_path, capsys):
    from repro_torch.dispatch.__main__ import main

    path = str(tmp_path / "smoke.json")
    assert main(["--smoke", "--cache", path, "--device", "cpu"]) == 0
    assert "0 candidates re-timed" in capsys.readouterr().out
    assert main(["--cache", path, "--device", "cpu", "--mode",
                 "int4_dequant", "--m", "16", "--k", "512",
                 "--batch", "2"]) == 0
    assert len(dispatch.PlanCache(path)) == 3


# ----------------------------------------------------------------- engine
CFG = JConfig(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
              d_ff=128, vocab_size=211, max_seq_len=128)
SPECS = {"msgemm": dict(mode="msgemm", d=3, scale_block=36),
         "int4": dict(mode="int4_dequant", d=3, scale_block=36,
                      storage="packed_u8")}


@pytest.fixture(scope="module", params=sorted(SPECS))
def pair(request):
    spec = JSpec(**SPECS[request.param])
    jp = j_quantize(JT.init_params(jax.random.PRNGKey(0), CFG), CFG, spec)
    jcfg = CFG.replace(quant=spec)
    tcfg = convert.config_from_jax(jcfg)
    model = convert.params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                                    device="cpu")
    return jp, jcfg, model, tcfg


PROMPTS = [(5, 17, 3, 99, 42, 7, 8), (11, 12, 13), (200, 1, 2, 3, 4)]


def _run(engine_cls, req_cls, params, cfg, **kw):
    eng = engine_cls(params, cfg, max_slots=2, block_size=4,
                     prefill_chunk=4, max_model_len=32, **kw)
    res = eng.run([req_cls(rid=i, prompt=p, max_new_tokens=5)
                   for i, p in enumerate(PROMPTS)])
    return eng, [res[i].generated for i in range(len(PROMPTS))]


def test_engine_autotune_resolves_plans_at_build(pair, tmp_path):
    jp, jcfg, model, tcfg = pair
    cache_file = tmp_path / "engine.json"
    eng = Engine(model, tcfg, max_slots=2, block_size=4, prefill_chunk=4,
                 max_model_len=32, autotune=True, autotune_cache=cache_file)
    tuned = {k: p for k, p in eng.exec_plans.items() if p.tiles is not None}
    assert tuned and all(p.source == "autotuned" for p in tuned.values())
    assert {int(k.split("|b")[1].split("|")[0]) for k in tuned} == {4, 2}
    assert cache_file.exists() and at.num_timed_candidates > 0
    misses = _count("dispatch_plan_cache_total", result="miss")
    res = eng.run([Request(rid=i, prompt=p, max_new_tokens=5)
                   for i, p in enumerate(PROMPTS)])
    toks = [res[i].generated for i in range(len(PROMPTS))]
    # every GeMM of the steps resolved from the warm cache
    assert _count("dispatch_plan_cache_total", result="miss") == misses
    _, want = _run(JEngine, JRequest, jp, jcfg)
    assert toks == want
    # a second engine over the reloaded file times nothing
    dispatch.set_cache_path(cache_file)
    before = at.num_timed_candidates
    eng2, toks2 = _run(Engine, Request, model, tcfg, autotune=True,
                       autotune_cache=cache_file)
    assert at.num_timed_candidates == before
    assert eng2.exec_plans == eng.exec_plans and toks2 == toks


def test_engine_without_policy_is_unchanged(pair):
    jp, jcfg, model, tcfg = pair
    eng, toks = _run(Engine, Request, model, tcfg)
    assert eng.exec_plans == {} and eng.runner.policy is None
    # the eager route resolved each key once, not once per call
    misses = _count("dispatch_plan_cache_total", result="miss")
    assert eng.num_steps > 1 and misses > 0
    backend = "msgemm_cuda" if tcfg.quant.mode == "msgemm" else "int4_cuda"
    before = at.num_timed_candidates
    forced, same = _run(Engine, Request, model, tcfg, backend=backend)
    assert same == toks and at.num_timed_candidates == before
    assert len(forced.exec_plans) == misses
    assert all(p.source == "heuristic" for p in forced.exec_plans.values())
