"""Port parity, observability and the compiled step: ``repro_torch.obs``
against ``repro.obs`` (registry semantics, byte-identical Prometheus text,
snapshots and traces that validate under both packages), the port engine's
series against the reference engine's on the same request stream
(counters, histogram observation counts, kv_* gauges on an f32 and a kv8
pool), tracing as an observer only, ``runtime.serve.sample`` and
``decode_positions`` against the reference's, and the step runner's CPU
route against a direct ``paged_step`` loop and static ``generate``."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_plan_isolation import (  # noqa: E402,F401  (autouse)
    isolated_plan_cache, isolated_plan_cache_module)
# one intra-op thread each: the suite runs in parallel workers
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import obs as jobs  # noqa: E402
from repro.kvq import KVQuantSpec as JKVSpec  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.config import ModelConfig as JConfig  # noqa: E402
from repro.runtime import serve as JSV  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro_torch import convert, obs  # noqa: E402
from repro_torch.kvq import KVQuantSpec  # noqa: E402
from repro_torch.launch import serve as cli  # noqa: E402
from repro_torch.obs import trace as TR  # noqa: E402
from repro_torch.obs.metrics import Registry  # noqa: E402
from repro_torch.runtime import serve as SV  # noqa: E402
from repro_torch.serving import Engine, Request  # noqa: E402
from repro_torch.serving.engine import StepRunner  # noqa: E402
from repro_torch.serving import kv_blocks  # noqa: E402

CFG = JConfig(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
              d_ff=128, vocab_size=211, max_seq_len=128)


@pytest.fixture(autouse=True)
def _clean_obs():
    """Tracing and the registries are process-wide: leave both packages'
    off and empty around every test."""
    for o in (obs, jobs):
        o.disable_tracing()
        o.tracer().clear()
        o.registry().reset()
    yield
    for o in (obs, jobs):
        o.disable_tracing()
        o.tracer().clear()


@pytest.fixture(scope="module")
def pair():
    jp = JT.init_params(jax.random.PRNGKey(0), CFG)
    tcfg = convert.config_from_jax(CFG)
    model = convert.params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                                    device="cpu")
    return jp, model, tcfg


def _prompts(lens, seed):
    rng = np.random.default_rng(seed)
    return [tuple(int(t) for t in rng.integers(0, CFG.vocab_size, size=L))
            for L in lens]


def _drive(engine_cls, req_cls, params, cfg, prompts, new, **kw):
    eng = engine_cls(params, cfg, **kw)
    res = eng.run([req_cls(rid=i, prompt=p, max_new_tokens=new)
                   for i, p in enumerate(prompts)])
    return eng, {rid: seq.generated for rid, seq in res.items()}


# ---------------------------------------------------------------- registry
def test_registry_get_or_create_and_reset_prefix():
    reg = Registry()
    c = reg.counter("t_total", region="us")
    c.inc()
    c.inc(2)
    assert reg.counter("t_total", region="us") is c
    assert reg.value("counter", "t_total", region="us") == 3
    assert reg.value("counter", "t_total", region="eu") is None
    reg.gauge("t_depth").set(7)
    assert reg.value("gauge", "t_depth") == 7
    reg.counter("serving_x").inc()
    reg.counter("dispatch_y").inc()
    reg.reset(prefix="serving_")
    assert reg.value("counter", "serving_x") is None
    assert reg.value("counter", "dispatch_y") == 1
    reg.reset()
    assert reg.value("counter", "dispatch_y") is None


def test_histogram_percentile_edge_cases():
    h = Registry().histogram("t_s")
    assert h.percentile(50) is None  # empty: null, never raises
    assert h.as_dict()["p50"] is None and h.as_dict()["min"] == 0.0
    h.observe(0.25)
    assert h.percentile(0) == h.percentile(99) == 0.25  # one sample
    for v in (0.5, 0.75, 1.0):
        h.observe(v)
    assert h.percentile(0) == 0.25 and h.percentile(100) == 1.0
    assert h.percentile(50) == pytest.approx(0.625)
    d = h.as_dict()
    assert d["count"] == 4 and d["sum"] == pytest.approx(2.5)
    assert d["buckets"]["+Inf"] == 4 and d["buckets"]["0.3"] == 1


def _feed(reg):
    reg.counter("serving_requests_submitted_total", help="requests").inc(3)
    reg.counter("dispatch_epilogue_total", fused="true").inc(7)
    reg.gauge("kv_pool_bytes", help="pool").set(69632)
    h = reg.histogram("serving_ttft_s", help="ttft")
    for v in (0.001, 0.02, 0.3, 4.0, 0.0005):
        h.observe(v)
    reg.histogram("serving_queue_depth_samples",
                  buckets=(0, 1, 2, 4)).observe(2)
    reg.histogram("kernel_gemm_s", backend="dense", m=64, k=64, b=4)


def test_same_series_same_exports_and_cross_validation():
    from repro.obs.metrics import Registry as JRegistry

    ours, theirs = Registry(), JRegistry()
    _feed(ours)
    _feed(theirs)
    assert ours.prometheus_text() == theirs.prometheus_text()
    a, b = ours.snapshot(extra={"k": 1}), theirs.snapshot(extra={"k": 1})
    a.pop("created_unix")
    b.pop("created_unix")
    assert json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)
    for snap in (ours.snapshot(), theirs.snapshot()):
        assert obs.validate_snapshot(snap) == []
        assert jobs.validate_snapshot(snap) == []
    bad = ours.snapshot()
    bad["schema_version"] = 99
    assert obs.validate_snapshot(bad) and jobs.validate_snapshot(bad)


def test_serve_prometheus_endpoint():
    import urllib.request

    reg = Registry()
    reg.counter("t_total").inc(2)
    server = obs.serve_prometheus(0, reg)
    try:
        port = server.server_address[1]
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                    timeout=10) as r:
            body = r.read().decode()
    finally:
        server.shutdown()
    assert "# TYPE t_total counter" in body and "t_total 2" in body


# ------------------------------------------------------------------ tracer
def test_trace_spans_marks_and_cross_validation(tmp_path):
    t = obs.enable_tracing(clear=True)
    with t.span("outer", cat="test", n=1):
        x = obs.mark_begin(torch.ones(4), "gemm.test")
        y = obs.mark_end(x * 2, "gemm.test", cat="gemm",
                         hist="kernel_gemm_s", hist_labels={"m": 4})
        t.instant("tick")
        t.counter("queue", waiting=2)
    assert torch.equal(y, torch.full((4,), 2.0))
    t.resolve_marks(t.take_marks())
    doc = t.save(tmp_path / "t.json")
    names = {(e["name"], e["tid"]) for e in doc["traceEvents"]}
    assert ("outer", TR.TID_HOST) in names
    assert ("gemm.test", TR.TID_DEVICE) in names
    assert obs.registry().value("histogram", "kernel_gemm_s", m=4) == 1
    assert obs.validate_trace_file(tmp_path / "t.json") == []
    assert jobs.validate_trace_file(tmp_path / "t.json") == []
    assert TR.Tracer.load(tmp_path / "t.json")["metadata"][
        "schema_version"] == jobs.TRACE_SCHEMA_VERSION
    assert obs.validate_trace({"traceEvents": [{"ph": "X"}]})


def test_tracing_off_stages_nothing(pair):
    _, model, tcfg = pair
    before = TR.marks_staged
    _drive(Engine, Request, model, tcfg, _prompts((5, 9), 7), 4,
           max_slots=2, block_size=4, prefill_chunk=4, max_model_len=32)
    assert TR.marks_staged == before
    assert obs.tracer().events() == [] and obs.tracer().take_marks() == []


def test_engine_tokens_identical_tracing_on_vs_off(pair, tmp_path):
    _, model, tcfg = pair
    kw = dict(max_slots=2, block_size=4, prefill_chunk=4, max_model_len=32)
    prompts = _prompts((5, 9), 7)
    _, off = _drive(Engine, Request, model, tcfg, prompts, 4, **kw)
    obs.enable_tracing(clear=True)  # before the engine is built
    _, on = _drive(Engine, Request, model, tcfg, prompts, 4, **kw)
    obs.disable_tracing()
    assert on == off
    doc = obs.tracer().save(tmp_path / "t.json")
    names = {e["name"] for e in doc["traceEvents"]}
    assert {"engine.prefill_chunk", "engine.decode_step", "request.submit",
            "request.finish", "scheduler.admit"} <= names
    gemms = [e for e in doc["traceEvents"] if e["name"].startswith("gemm.")]
    assert gemms and all(e["tid"] == TR.TID_DEVICE for e in gemms)
    assert jobs.validate_trace(doc) == []


# ------------------------------------------------ the engines' series
def _series(snap):
    counters = {r["name"]: r["value"] for r in snap["counters"]
                if r["name"].startswith("serving_")}
    hists = {(r["name"], tuple(sorted(r["labels"].items()))): r["count"]
             for r in snap["histograms"] if r["name"].startswith("serving_")}
    gauges = {r["name"]: r["value"] for r in snap["gauges"]
              if r["name"].startswith("kv_")}
    return counters, hists, gauges


@pytest.mark.parametrize("kv_bits", [16, 8], ids=["f32-pool", "kv8-pool"])
def test_engine_series_match_reference_engine(pair, kv_bits):
    jp, model, tcfg = pair
    prompts = _prompts((6, 6, 5), seed=12)
    kw = dict(max_slots=2, block_size=4, prefill_chunk=8, max_model_len=16,
              num_blocks=7)  # pool too small: preemption
    eng, got = _drive(Engine, Request, model, tcfg, prompts, 10,
                      kv_quant=KVQuantSpec(kv_bits) if kv_bits < 16 else None,
                      **kw)
    jeng, want = _drive(JEngine, JRequest, jp, CFG, prompts, 10,
                        kv_quant=JKVSpec(kv_bits) if kv_bits < 16 else None,
                        **kw)
    assert got == want
    assert eng.scheduler.num_preemptions > 0
    ours, theirs = obs.registry().snapshot(), jobs.registry().snapshot()
    assert _series(ours) == _series(theirs)
    counters, hists, gauges = _series(ours)
    assert counters["serving_requests_submitted_total"] == 3
    assert counters["serving_requests_finished_total"] == 3
    assert counters["serving_preemptions_total"] == \
        eng.scheduler.num_preemptions
    assert counters["serving_evicted_blocks_total"] == \
        eng.scheduler.num_evicted_blocks
    assert hists[("serving_ttft_s", ())] == 3
    assert hists[("serving_request_latency_s", ())] == 3
    assert hists[("serving_intertoken_s", ())] > 0
    assert set(gauges) == ({"kv_pool_bytes", "kv_bytes_per_token",
                            "kv_capacity_seqs"}
                           | ({"kv_dequant_hbm_bytes"} if kv_bits < 16
                              else set()))
    m, jm = eng.metrics(), jeng.metrics()
    for key in ("requests", "generated_tokens", "preemptions",
                "evicted_blocks", "admitted", "prefill_steps",
                "decode_steps", "preempt_thrash"):
        assert m[key] == jm[key], key
    assert obs.validate_snapshot(ours) == jobs.validate_snapshot(ours) == []


def test_engine_metrics_edge_cases_and_reset(pair):
    _, model, tcfg = pair
    eng = Engine(model, tcfg, max_slots=2, block_size=4, prefill_chunk=4,
                 max_model_len=32)
    m0 = eng.metrics()  # nothing finished: counts 0, percentiles None
    assert m0["requests"] == 0 and m0["tok_per_s"] == 0.0
    assert m0["latency_p50_s"] is None and m0["ttft_p95_s"] is None
    assert m0["intertoken_p50_s"] is None and m0["queue_wait_p95_s"] is None
    eng.submit(Request(rid=9, prompt=(1, 2), max_new_tokens=2))
    eng.step()
    mf = eng.metrics()  # mid-flight: still no raise
    assert mf["requests"] == 0 and mf["latency_p95_s"] is None
    assert mf["queue_wait_p95_s"] is not None
    eng.run([Request(rid=0, prompt=(1, 2, 3), max_new_tokens=3)])
    m1 = eng.metrics()
    assert m1["requests"] >= 1
    assert m1["latency_p50_s"] > 0 and m1["latency_p95_s"] > 0
    assert m1["intertoken_p50_s"] is not None
    assert eng.summary() == m1
    eng.reset_metrics()
    m2 = eng.metrics()
    assert m2["requests"] == 0 and m2["generated_tokens"] == 0
    assert m2["latency_p50_s"] is None and m2["intertoken_p50_s"] is None
    reg = obs.registry()
    assert reg.value("histogram", "serving_ttft_s") in (None, 0)
    assert reg.value("gauge", "kv_pool_bytes") > 0  # capacity stays


# ------------------------------------------------------ sample, positions
def test_sample_and_decode_positions_match_reference_shapes():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((3, 17)).astype(np.float32)
    j0 = JSV.sample(jnp.asarray(logits), jax.random.PRNGKey(0), 0.0)
    t0 = SV.sample(torch.from_numpy(logits), None, 0.0)
    assert t0.dtype == torch.int32 and tuple(t0.shape) == j0.shape
    assert t0.tolist() == np.asarray(j0).tolist()  # greedy: same tokens
    j1 = JSV.sample(jnp.asarray(logits), jax.random.PRNGKey(0), 0.7)
    draws = [SV.sample(torch.from_numpy(logits),
                       torch.Generator().manual_seed(5), 0.7)
             for _ in range(2)]
    assert tuple(draws[0].shape) == j1.shape and draws[0].dtype == torch.int32
    assert torch.equal(draws[0], draws[1])  # seeded: repeatable
    assert ((draws[0] >= 0) & (draws[0] < 17)).all()
    # a near-one-hot row is drawn at its peak whatever the generator
    peaked = torch.full((2, 17), -1e4)
    peaked[:, 11] = 0.0
    assert SV.sample(peaked, torch.Generator().manual_seed(1),
                     1.0).tolist() == [11, 11]
    jp = JSV.decode_positions(CFG, 4, 9)
    tp = SV.decode_positions(convert.config_from_jax(CFG), 4, 9)
    assert tp.dtype == torch.int32 and tp.tolist() == np.asarray(jp).tolist()


# ------------------------------------------------------------- step runner
def test_step_runner_cpu_route_matches_paged_step_and_static(pair):
    _, model, tcfg = pair
    bs, W, nb = 4, 16, 9
    kv_a = SV.init_paged_cache(tcfg, nb, bs, device="cpu")
    kv_b = SV.init_paged_cache(tcfg, nb, bs, device="cpu")
    runner = StepRunner(model, tcfg, kv_a, torch.device("cpu"),
                        {"prefill": (1, 4), "decode": (2, 1)}, width=W,
                        block_size=bs, cuda_graph=False)
    prompt = _prompts((6,), seed=4)[0]
    blocks = [1, 2, 3, 4]
    toks = []
    for start in (0, 4):  # two prefill chunks, the second ragged
        n = min(4, len(prompt) - start)
        tokens = np.zeros((1, 4), np.int32)
        tokens[0, :n] = prompt[start:start + n]
        arrays = (tokens, (start + np.arange(4, dtype=np.int32))[None],
                  kv_blocks.write_slots(blocks, start, n, 4, bs)[None],
                  kv_blocks.view_slots(blocks, 4, bs)[None],
                  np.array([n - 1], np.int32))
        tok, ok, logits = runner("prefill", *arrays)
        with torch.no_grad():
            want, _ = SV.paged_step(model, tcfg, *[torch.from_numpy(a)
                                                   for a in arrays[:1]],
                                    kv_b, *[torch.from_numpy(a)
                                            for a in arrays[1:]])
        assert torch.equal(logits, want)
        assert tok.tolist() == SV.greedy(want).tolist()
        assert ok.tolist() == [1]  # the per-row finite flag
    toks.append(int(tok[0]))
    for i in range(3):  # decode in row 1 of 2; row 0 idles on scratch
        pos = len(prompt) + i
        arrays = (np.array([[0], [toks[-1]]], np.int32),
                  np.array([[0], [pos]], np.int32),
                  np.stack([np.arange(1, dtype=np.int32),
                            kv_blocks.write_slots(blocks, pos, 1, 1, bs)]),
                  np.stack([np.zeros(W, np.int32),
                            kv_blocks.view_slots(blocks, 4, bs)]),
                  np.zeros(2, np.int32))
        tok, ok, logits = runner("decode", *arrays)
        with torch.no_grad():
            want, _ = SV.paged_step(model, tcfg, torch.from_numpy(arrays[0]),
                                    kv_b, *[torch.from_numpy(a)
                                            for a in arrays[1:]])
        assert torch.equal(logits[1], want[1])
        toks.append(int(tok[1]))
    for name in ("k", "v"):
        assert torch.equal(kv_a[0][name][1:], kv_b[0][name][1:])
    static = SV.generate(model, tcfg, torch.tensor([prompt],
                                                   dtype=torch.int32),
                         max_new_tokens=4)
    assert toks == static[0].tolist()
    with pytest.raises(ValueError, match="CUDA"):
        Engine(model, tcfg, max_slots=1, block_size=4, max_model_len=16,
               cuda_graph=True)


def test_serve_cli_writes_valid_metrics_and_trace(tmp_path):
    m, t = tmp_path / "m.json", tmp_path / "t.json"
    out = cli.main(["--arch", "gemma_2b", "--smoke", "--device", "cpu",
                    "--quant", "bf16", "--engine", "continuous",
                    "--num-requests", "2", "--new-tokens", "3",
                    "--prompt-len", "6", "--no-cuda-graph",
                    "--metrics-json", str(m), "--trace-out", str(t)])
    assert all(s.status == "ok" for s in out["results"].values())
    for path in (m, t):
        assert path.exists()
    assert obs.validate_snapshot_file(m) == jobs.validate_snapshot_file(m) \
        == []
    assert obs.validate_trace_file(t) == jobs.validate_trace_file(t) == []
    snap = json.loads(m.read_text())
    names = {r["name"] for kind in ("counters", "gauges", "histograms")
             for r in snap[kind]}
    assert {"serving_requests_finished_total", "serving_ttft_s",
            "kv_pool_bytes", "kernel_gemm_s"} <= names
    assert snap["context"]["no_cuda_graph"] is True
    assert not obs.tracer().enabled  # the CLI turns tracing off on exit
