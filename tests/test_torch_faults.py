"""Port parity, resilience: ``repro_torch.faults``, the engine's recovery
paths, the degradation ladder and artifact corruption.

The first part twins every test of tests/test_faults.py on the port
(deterministic seeded schedules, zero overhead and token identity when
disarmed, per-class engine recovery, deadlines and shedding, the
preemption-thrash guard, quarantine and ``dense_fallback``, corrupt plan
cache, calibration and checkpoint).  The second holds the port against
the JAX package on the same inputs: (a) both plans fire at the same
opportunities and draw the same victims, (b) ``parse_spec`` accepts and
rejects the same strings, (c) both engines under the same single-class
spec and seed give the same statuses, counters and, where the ladders
agree, tokens (deadlines under an injected clock), and (d)
``dense_fallback`` agrees with ``msgemm_torch`` and with the reference's
``dense_fallback`` within the reference's 1e-4.

On the msgemm model a replan moves the port from ``msgemm_cuda`` (its
plain version on the CPU) to ``msgemm_torch`` and the reference from
``msgemm_jnp`` to ``dense_fallback``, so after ``nan_logits`` and
``hang`` only statuses and counters are compared there; tokens on the
dense model, where nothing is quarantined.
"""

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

from repro import dispatch as jdispatch  # noqa: E402
from repro import faults as jfaults  # noqa: E402
from repro import obs as jobs  # noqa: E402
from repro.core import linear as jlinear  # noqa: E402
from repro.core.spec import QuantSpec as JSpec  # noqa: E402
from repro.distributed.watchdog import Watchdog as JWatchdog  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.config import ModelConfig as JConfig  # noqa: E402
from repro.quant import quantize_model as j_quantize  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro_torch import convert, dispatch, faults, obs  # noqa: E402
from repro_torch.core import linear as tlinear  # noqa: E402
from repro_torch.core.spec import QuantSpec  # noqa: E402
from repro_torch.distributed.watchdog import Watchdog  # noqa: E402
from repro_torch.runtime import serve as SV  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    BlockPool, Engine, Request, Scheduler,
)
from repro_torch.serving.request import Sequence  # noqa: E402
from repro_torch.serving.scheduler import THRASH_AFTER  # noqa: E402

CFG = JConfig(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
              d_ff=128, vocab_size=211, max_seq_len=128)
MS = QuantSpec(mode="msgemm", d=3, scale_block=36)


def _model(mode):
    jp = JT.init_params(jax.random.PRNGKey(0), CFG)
    jcfg = CFG
    if mode == "msgemm":
        spec = JSpec(mode="msgemm", d=3, scale_block=36)
        jp, jcfg = j_quantize(jp, CFG, spec), CFG.replace(quant=spec)
    tcfg = convert.config_from_jax(jcfg)
    model = convert.params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                                    device="cpu")
    return jp, jcfg, model, tcfg


@pytest.fixture(scope="module")
def models():
    return {mode: _model(mode) for mode in ("bf16", "msgemm")}


@pytest.fixture(scope="module")
def params(models):
    return models["bf16"][2]


@pytest.fixture(autouse=True)
def _clean():
    """Every test starts and ends disarmed with no quarantined backend and
    fresh serving_* series, in both packages (all process-global)."""
    for f, d, o in ((faults, dispatch, obs), (jfaults, jdispatch, jobs)):
        f.disarm()
        d.clear_quarantine()
        o.registry().reset(prefix="serving_")
    yield
    for f, d in ((faults, dispatch), (jfaults, jdispatch)):
        f.disarm()
        d.clear_quarantine()


def _prompts(lens, seed=1):
    rng = np.random.default_rng(seed)
    return [tuple(int(t) for t in rng.integers(0, CFG.vocab_size, size=L))
            for L in lens]


PROMPTS = _prompts((5, 11, 3, 8))


def _reqs(new=6, cls=Request, **kw):
    return [cls(rid=i, prompt=p, max_new_tokens=new, **kw)
            for i, p in enumerate(PROMPTS)]


def _engine(params, cfg=None, cls=Engine, **kw):
    kw.setdefault("max_slots", 3)
    kw.setdefault("block_size", 4)
    kw.setdefault("prefill_chunk", 4)
    kw.setdefault("max_model_len", 64)
    return cls(params, cfg if cfg is not None else
               convert.config_from_jax(CFG), **kw)


@pytest.fixture(scope="module")
def ref_tokens(params):
    tcfg = convert.config_from_jax(CFG)
    out = {}
    for i, p in enumerate(PROMPTS):
        r = SV.generate(params, tcfg, torch.tensor([p], dtype=torch.int32),
                        max_new_tokens=6)
        out[i] = [int(t) for t in r[0]]
    return out


# ------------------------------------------------------------ fault plan
def test_plan_determinism_and_budget():
    a = faults.FaultPlan("step_fail:p=0.5,max=0", seed=7)
    b = faults.FaultPlan("step_fail:p=0.5,max=0", seed=7)
    sa = [a.fire("step_fail") is not None for _ in range(200)]
    sb = [b.fire("step_fail") is not None for _ in range(200)]
    assert sa == sb and 40 < sum(sa) < 160
    c = faults.FaultPlan("step_fail:p=0.5,max=0", seed=8)
    assert sa != [c.fire("step_fail") is not None for _ in range(200)]

    capped = faults.FaultPlan("oom:p=1.0,after=3,max=2")
    fires = [capped.fire("oom") for _ in range(10)]
    assert [f is not None for f in fires] == [False] * 3 + [True] * 2 \
        + [False] * 5
    assert capped.fires("oom") == 2 and capped.exhausted()


def test_always_draw_keeps_stream_budget_independent():
    wide = faults.FaultPlan("oom:p=0.5,max=0", seed=3)
    narrow = faults.FaultPlan("oom:p=0.5,max=1", seed=3)
    w = [wide.fire("oom") is not None for _ in range(50)]
    n = [narrow.fire("oom") is not None for _ in range(50)]
    first = w.index(True)
    assert n[:first + 1] == w[:first + 1] and not any(n[first + 1:])


def test_parse_spec_grammar_and_validation():
    specs = faults.parse_spec("all")
    assert {s.cls for s in specs} == set(faults.CLASSES)
    [s] = faults.parse_spec("hang:p=0.25,after=2,max=3,mag=1.5")
    assert (s.p, s.after, s.max_fires, s.magnitude) == (0.25, 2, 3, 1.5)
    two = faults.parse_spec("oom;disconnect:max=2")
    assert [s.cls for s in two] == ["oom", "disconnect"]
    with pytest.raises(ValueError):
        faults.parse_spec("not_a_class")
    with pytest.raises(ValueError):
        faults.parse_spec("oom:bogus=1")
    with pytest.raises(ValueError):
        faults.FaultPlan("oom;oom")


def test_arm_disarm_gauge_and_env(monkeypatch):
    g = obs.registry().gauge("faults_armed")
    assert faults.active() is None and g.value == 0
    faults.arm("oom;hang")
    assert g.value == 2 and faults.active() is not None
    faults.disarm()
    assert g.value == 0 and faults.fire("oom") is None

    monkeypatch.setenv("REPRO_FAULTS", "latency:max=1")
    monkeypatch.setenv("REPRO_FAULT_SEED", "5")
    plan = faults.plan_from_env()
    assert plan is not None and plan.seed == 5
    assert plan.armed_classes() == ("latency",)
    faults.disarm()
    monkeypatch.setenv("REPRO_FAULTS", "")
    assert faults.plan_from_env() is None


def test_fire_counts_injections():
    faults.arm("oom:p=1.0,after=0,max=2")
    assert faults.fire("oom") is not None and faults.fire("oom") is not None
    assert faults.fire("oom") is None and faults.fire("hang") is None
    assert obs.registry().value("counter", "faults_injected_total",
                                cls="oom") == 2


# ------------------------------------------ disarmed = identical serving
def test_disarmed_engine_token_identical_and_armed_gauge_zero(
        params, ref_tokens):
    eng = _engine(params)
    assert obs.registry().gauge("faults_armed").value == 0
    res = eng.run(_reqs())
    for i in ref_tokens:
        assert res[i].status == "ok"
        assert res[i].generated == ref_tokens[i], f"req {i}"
    m = eng.metrics()
    assert m["shed"] == m["step_retries"] == m["replans"] == 0
    assert m["nan_quarantined"] == m["kv_rebuilds"] == m["cancelled"] == 0
    assert eng.runner.captures == 0 and not dispatch.quarantined()


# --------------------------------------------------- per-class recovery
@pytest.mark.parametrize("spec", [
    "latency:p=1.0,after=1,max=2,mag=0.01",
    "oom:p=0.5,after=1,max=4",
    "step_fail:p=1.0,after=2,max=2",
])
def test_transient_faults_recover_token_identically(
        params, ref_tokens, spec):
    faults.arm(spec)
    eng = _engine(params)
    res = eng.run(_reqs())
    faults.disarm()
    for i in ref_tokens:
        assert res[i].status == "ok"
        assert res[i].generated == ref_tokens[i], f"req {i} under {spec}"
    if spec.startswith("step_fail"):
        assert eng.num_step_retries == 2


def test_step_fail_exhausted_retries_reraise(params):
    faults.arm("step_fail:p=1.0,after=0,max=0")
    eng = _engine(params, step_retries=2, retry_backoff_s=0.001)
    with pytest.raises(faults.InjectedFault):
        eng.run(_reqs(new=2))
    assert eng.num_step_retries == 3  # two retries, then the re-raise


def test_nan_guard_quarantines_sequence_then_backend(models, ref_tokens):
    faults.arm("nan_logits:p=1.0,after=3,max=2")
    eng = _engine(models["bf16"][2])
    res = eng.run(_reqs())
    faults.disarm()
    statuses = {i: res[i].status for i in res}
    assert sum(1 for s in statuses.values() if s == "quarantined") == 2
    assert eng.num_nan_events == 2
    assert eng.num_replans >= 1
    for i in res:
        if res[i].status == "ok":
            assert res[i].generated == ref_tokens[i]
    # on the msgemm model the replan quarantines the kernel's backend and
    # the resolved plans move one rung down the ladder
    _, _, model, tcfg = models["msgemm"]
    faults.arm("nan_logits:p=1.0,after=3,max=2")
    eng = _engine(model, tcfg)
    eng.run(_reqs())
    faults.disarm()
    assert eng.num_replans == 1 and "msgemm_cuda" in dispatch.quarantined()
    assert {p.backend for p in eng.exec_plans.values()} == {"msgemm_torch"}


def test_disconnect_cancels_victim_cleanly(params, ref_tokens):
    faults.arm("disconnect:p=1.0,after=2,max=1")
    eng = _engine(params)
    res = eng.run(_reqs())
    faults.disarm()
    statuses = [res[i].status for i in res]
    assert statuses.count("disconnected") == 1
    for i in res:
        if res[i].status == "ok":
            assert res[i].generated == ref_tokens[i]


def test_hang_escalates_and_serving_continues(params):
    wd = Watchdog(min_steps=2, min_timeout_s=0.05)
    eng = _engine(params, watchdog=wd)
    eng.run(_reqs(new=2))  # warm, so the hang timer is tight
    eng.reset_metrics()
    faults.arm("hang:p=1.0,after=4,max=1,mag=0.1")
    res = eng.run(_reqs())
    faults.disarm()
    assert wd.hang_count >= 1
    assert eng.num_replans >= 1
    assert all(res[i].status == "ok" for i in res)
    assert all(res[i].done for i in res)


def test_watchdog_true_is_the_serving_default(params):
    eng = _engine(params, watchdog=True)
    wd = eng._watchdog
    assert isinstance(wd, Watchdog)
    assert (wd.min_steps, wd.min_timeout_s) == (3, 0.5)
    assert wd.on_hang == eng._hang_flag.set


def test_injected_oom_is_indistinguishable_from_pressure():
    pool = BlockPool(8, 4)
    faults.arm("oom:p=1.0,after=0,max=1")
    assert pool.alloc(2) is None      # injected exhaustion
    got = pool.alloc(2)               # budget spent: real allocation
    faults.disarm()
    assert got is not None and pool.free_blocks == 5


# ------------------------------------------------- deadlines / shedding
def test_deadline_cancels_cleanly(params):
    eng = _engine(params, deadline_s=1e-6)
    res = eng.run(_reqs())
    assert all(res[i].status == "deadline" for i in res)
    m = eng.metrics()
    assert m["cancelled"] == 4 and m["shed"] == 0


def test_ttft_deadline_per_request(params):
    eng = _engine(params)
    res = eng.run([Request(rid=0, prompt=PROMPTS[0], max_new_tokens=6,
                           ttft_deadline_s=1e-7)])
    assert res[0].status == "deadline"


def test_queue_full_sheds(params):
    eng = _engine(params, max_slots=1, max_queue=1)
    res = eng.run(_reqs())
    statuses = [res[i].status for i in res]
    assert statuses.count("shed") >= 1
    for i in res:
        if res[i].status == "ok":
            assert len(res[i].generated) == 6
    assert eng.metrics()["shed"] == statuses.count("shed")


def test_deadline_hopeless_sheds_at_submit(params):
    obs.registry().histogram("serving_queue_wait_s").observe(5.0)
    eng = _engine(params)
    seq = eng.submit(Request(rid=0, prompt=PROMPTS[0], max_new_tokens=4,
                             deadline_s=0.001))
    assert seq.status == "shed"
    assert eng.rejected == [seq] and not eng.scheduler.has_work()


def test_request_deadline_validation():
    with pytest.raises(ValueError):
        Request(rid=0, prompt=(1,), max_new_tokens=1, deadline_s=0.0)
    with pytest.raises(ValueError):
        Request(rid=0, prompt=(1,), max_new_tokens=1, ttft_deadline_s=-1.0)


def test_metrics_never_raises_zero_submitted(params):
    eng = _engine(params)
    m = eng.metrics()
    assert m["requests"] == 0 and m["tok_per_s"] == 0.0
    assert m["latency_p50_s"] is None and m["ttft_p95_s"] is None
    assert m["intertoken_p95_s"] is None
    assert m["queue_wait_p95_s"] is None
    assert eng.summary() == m


def test_metrics_never_raises_mid_flight(params):
    eng = _engine(params)
    eng.submit(Request(rid=0, prompt=PROMPTS[0], max_new_tokens=6))
    eng.step()  # prefill under way, nothing finished
    m = eng.metrics()
    assert m["requests"] == 0
    assert m["latency_p50_s"] is None and m["latency_p95_s"] is None


# ---------------------------------------------------------- thrash guard
def test_preemption_thrash_guard_backs_off():
    pool = BlockPool(60, 4)
    sched = Scheduler(pool, max_slots=2, prefill_chunk=4)
    hog = Sequence(req=Request(rid=0, prompt=(1,) * 8, max_new_tokens=4))
    victim = Sequence(req=Request(rid=1, prompt=(1,) * 8,
                                  max_new_tokens=4))
    sched.add(hog)
    sched.add(victim)
    sched.schedule()
    assert victim in sched.running
    victim.preemptions = THRASH_AFTER - 1
    sched.preempt(victim)
    assert sched.num_thrash == 1
    assert victim.readmit_after_tick > sched.tick
    assert obs.registry().value(
        "counter", "scheduler_preempt_thrash_total") >= 1
    sched.schedule()
    assert victim not in sched.running and sched.waiting[0] is victim
    for _ in range(victim.readmit_after_tick - sched.tick):
        sched.schedule()
    assert victim in sched.running


def test_thrash_backoff_ignored_when_nothing_running():
    pool = BlockPool(60, 4)
    sched = Scheduler(pool, max_slots=1, prefill_chunk=4)
    seq = Sequence(req=Request(rid=0, prompt=(1,) * 8, max_new_tokens=4))
    seq.preemptions = THRASH_AFTER + 2
    sched.add(seq)
    seq.readmit_after_tick = sched.tick + 1000
    sched.schedule()
    assert seq in sched.running


# ------------------------------------- backend quarantine / degradation
def test_backend_quarantine_ladder():
    names = dispatch.backend_names()
    assert "dense_fallback" in names
    be = dispatch.get_backend("dense_fallback")
    assert be.priority == -100 and be.modes == ("msgemm", "int4_dequant")
    assert be.is_available("cuda") and be.is_available("cpu")
    # msgemm_cuda -> msgemm_torch -> dense_fallback, on both devices
    for dev in ("cuda", "cpu"):
        ladder = [b.name for b in dispatch.available_backends(MS, 3, dev)]
        assert ladder == ["msgemm_cuda", "msgemm_torch", "dense_fallback"]
    int4 = QuantSpec(mode="int4_dequant", d=3, scale_block=36)
    assert [b.name for b in dispatch.available_backends(int4, 3, "cuda")] \
        == ["int4_cuda", "int4_torch", "dense_fallback"]
    dispatch.quarantine_backend("msgemm_cuda", "test")
    assert dispatch.is_quarantined("msgemm_cuda")
    assert "msgemm_cuda" in dispatch.quarantined()
    assert dispatch.select_backend(MS, 3, "cpu").name == "msgemm_torch"
    assert dispatch.plan(MS, 16, 36, 3, device_type="cpu").backend \
        == "msgemm_torch"
    dispatch.quarantine_backend("msgemm_torch", "test")
    assert dispatch.select_backend(MS, 3, "cpu").name == "dense_fallback"
    dispatch.clear_quarantine("msgemm_cuda")
    dispatch.clear_quarantine("msgemm_torch")
    assert not dispatch.quarantined()
    with pytest.raises(ValueError):
        dispatch.quarantine_backend("no_such_backend", "test")


def test_quarantine_never_empties_candidates():
    for name in dispatch.backend_names():
        dispatch.quarantine_backend(name, "test")
    assert dispatch.registry.select_backend(MS, 3, "cpu") is not None


def test_dense_fallback_matches_msgemm_numerics():
    """dense_fallback against msgemm_torch on the port's leaves and
    against the reference's dense_fallback on the reference's leaves of
    the same weight, within the reference's 1e-4."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal((16, 36)).astype(np.float32)
    x = rng.standard_normal((5, 36)).astype(np.float32)
    qp = tlinear.from_dense(torch.from_numpy(w), MS)
    xt = torch.from_numpy(x)
    ref = dispatch.execute(qp, xt, MS, plan_override=dispatch.ExecPlan(
        backend="msgemm_torch"))
    got = dispatch.execute(qp, xt, MS, plan_override=dispatch.ExecPlan(
        backend="dense_fallback"))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-4,
                               rtol=1e-4)
    jspec = JSpec(mode="msgemm", d=3, scale_block=36)
    jqp = jlinear.from_dense(jnp.asarray(w), jspec)
    theirs = jdispatch.execute(jqp, jnp.asarray(x), jspec,
                               plan_override=jdispatch.ExecPlan(
                                   backend="dense_fallback"))
    np.testing.assert_allclose(got.numpy(), np.asarray(theirs), atol=1e-4,
                               rtol=1e-4)


# ------------------------------------------------- artifacts: corruption
def test_plan_cache_atomic_write_and_corrupt_rebuild(tmp_path):
    path = tmp_path / "plans.json"
    c = dispatch.set_cache_path(path)
    c.put("k|1", dispatch.ExecPlan(backend="msgemm_torch"))
    assert not list(tmp_path.glob("*.tmp*"))  # atomic: no temp left
    assert "crc" in json.loads(path.read_text())
    assert len(dispatch.set_cache_path(path)) == 1

    path.write_text('{"version": 3, "plans": {broken')
    c = dispatch.set_cache_path(path)
    assert len(c) == 0  # quarantined + rebuilt empty
    assert list(tmp_path.glob("plans.json.quarantined*"))
    c.put("k|1", dispatch.ExecPlan(backend="msgemm_torch"))
    assert len(dispatch.set_cache_path(path)) == 1  # rebuilt


def test_plan_cache_crc_mismatch_quarantined(tmp_path):
    path = tmp_path / "plans.json"
    dispatch.set_cache_path(path).put(
        "k|1", dispatch.ExecPlan(backend="msgemm_torch"))
    doc = json.loads(path.read_text())
    doc["crc"] = "deadbeef"
    path.write_text(json.dumps(doc))
    assert len(dispatch.set_cache_path(path)) == 0
    assert list(tmp_path.glob("plans.json.quarantined*"))


def test_injected_plan_cache_corruption_recovers(tmp_path):
    path = tmp_path / "plans.json"
    faults.arm("corrupt_plan_cache")
    dispatch.set_cache_path(path).put(
        "k|1", dispatch.ExecPlan(backend="msgemm_torch"))
    faults.disarm()
    assert len(dispatch.set_cache_path(path)) == 0  # corrupt -> empty
    assert list(tmp_path.glob("plans.json.quarantined*"))
    dispatch.set_cache_path(path).put(
        "k|1", dispatch.ExecPlan(backend="msgemm_torch"))
    assert len(dispatch.set_cache_path(path)) == 1  # round-trips again


def test_calibration_corruption_quarantined(tmp_path):
    from repro_torch.obs import perfmodel as pm

    path = tmp_path / "calibration.json"
    device, interpret = pm.current_partition("cpu")
    cal = pm.Calibration(device=device, interpret=interpret,
                         constants={"*": {"launch_s": 1e-6, "step_s": 1e-8,
                                          "produce_s_per_flop": 1e-9,
                                          "consume_s_per_op": 1e-9,
                                          "hbm_s_per_byte": 1e-10}},
                         fit={"n_samples": 4})
    faults.arm("corrupt_calibration")
    cal.save(path)
    faults.disarm()
    assert pm.load_calibration(path) is None
    assert list(tmp_path.glob("calibration.json.quarantined*"))
    cal.save(path)  # rebuild
    assert pm.load_calibration(path) is not None


def test_checkpoint_corruption_falls_back_to_older_step(tmp_path):
    from repro_torch.checkpoint import CheckpointManager

    mgr = CheckpointManager(str(tmp_path / "ckpt"), keep=3)
    tree = {"w": np.arange(6, dtype=np.float32)}
    mgr.save(1, tree)
    faults.arm("corrupt_checkpoint")
    mgr.save(2, tree)
    faults.disarm()
    step, restored = mgr.restore_latest(tree)
    assert step == 1 and np.array_equal(restored["w"], tree["w"])
    assert mgr.all_steps() == [1]  # corpse excluded from step listing
    assert obs.registry().value("counter", "artifact_quarantined_total",
                                artifact="checkpoint",
                                reason="corrupt") >= 1


# =========================================== parity with the JAX package
def _probe(plan, cls, n=300):
    """(opportunity, victim draws) of every fire in ``n`` opportunities."""
    out = []
    for i in range(n):
        ev = plan.fire(cls)
        if ev is not None:
            out.append((i, ev.index, ev.magnitude,
                        int(ev.rng.integers(7)),
                        ev.rng.integers(0, 256, size=16).tolist()))
    return out


@pytest.mark.parametrize("cls", faults.CLASSES)
def test_decision_streams_match_reference(cls):
    assert faults.CLASSES == jfaults.CLASSES
    for seed in range(4):
        for spec in (f"{cls}:p=0.5,max=0", cls):  # unbounded; defaults
            ours = _probe(faults.FaultPlan(spec, seed=seed), cls)
            theirs = _probe(jfaults.FaultPlan(spec, seed=seed), cls)
            assert ours == theirs, (spec, seed)
        assert ours  # the default schedule fires at least once


@pytest.mark.parametrize("text", [
    "all", "", "  ", "nan_logits", "step_fail:p=0.5,after=2,max=3",
    "oom:p=0.2;disconnect:max=1", "hang:mag=0.5", "latency:p=1",
    "oom;", "not_a_class", "oom:bogus=1", "oom:p=1.5", "oom:after=-1",
    "oom:p=x", "oom;oom", "corrupt_checkpoint:max=0",
])
def test_parse_spec_matches_reference(text):
    def outcome(mod):
        try:
            return [tuple(vars(s).values()) for s in mod.parse_spec(text)], \
                mod.FaultPlan(text).describe()
        except ValueError:
            return "ValueError"

    assert outcome(faults) == outcome(jfaults)


def _both(models, mode, spec, reqs_kw=None, warm=False, **engine_kw):
    """Serve the same requests through the reference engine and the
    port's CPU engine, each under ``spec`` armed in its own package.
    Returns {side: (engine, {rid: (status, tokens)})}."""
    jp, jcfg, model, tcfg = models[mode]
    out = {}
    for side, (f, d, o, eng_cls, req_cls, wd_cls, params, cfg) in {
            "ref": (jfaults, jdispatch, jobs, JEngine, JRequest, JWatchdog,
                    jp, jcfg),
            "port": (faults, dispatch, obs, Engine, Request, Watchdog,
                     model, tcfg)}.items():
        d.clear_quarantine()
        o.registry().reset(prefix="serving_")
        kw = dict(engine_kw)
        if kw.get("watchdog") is not None:
            kw["watchdog"] = wd_cls(**kw["watchdog"])
        if callable(kw.get("clock")):  # a fresh clock per engine
            kw["clock"], kw["on_token"] = kw["clock"]()
        eng = _engine(params, cfg, cls=eng_cls, **kw)
        if warm:
            eng.run(_reqs(new=2, cls=req_cls))
            eng.reset_metrics()
        if spec:
            f.arm(spec)
        try:
            res = eng.run(_reqs(cls=req_cls, **(reqs_kw or {})))
        finally:
            f.disarm()
        out[side] = (eng, {i: (res[i].status, list(res[i].generated))
                           for i in sorted(res)})
    return out


COUNTERS = ("shed", "cancelled", "step_retries", "nan_quarantined",
            "replans")

# one spec per serving class: the reference test's where it has one
SERVING = {
    "latency": ("latency:p=1.0,after=1,max=2,mag=0.01", {}),
    "oom": ("oom:p=0.5,after=1,max=4", {}),
    "step_fail": ("step_fail:p=1.0,after=2,max=2", {}),
    "disconnect": ("disconnect:p=1.0,after=2,max=1", {}),
    "nan_logits": ("nan_logits:p=1.0,after=3,max=2", {}),
    # a timeout well above a step of either engine (the reference's first
    # steps after a replan compile), so only the injected stall fires
    "hang": ("hang:p=1.0,after=4,max=1,mag=0.1",
             dict(warm=True, watchdog=dict(min_steps=2,
                                           min_timeout_s=2.0))),
}


@pytest.mark.parametrize("mode", ["bf16", "msgemm"])
@pytest.mark.parametrize("cls", list(SERVING))
def test_engine_matches_reference_under_fault_class(models, cls, mode):
    spec, kw = SERVING[cls]
    both = _both(models, mode, spec, **kw)
    (jeng, theirs), (eng, ours) = both["ref"], both["port"]
    jm, m = jeng.metrics(), eng.metrics()
    assert {k: m[k] for k in COUNTERS} == {k: jm[k] for k in COUNTERS}
    assert m["kv_rebuilds"] == 0
    assert {i: s for i, (s, _) in ours.items()} == \
        {i: s for i, (s, _) in theirs.items()}
    if mode == "msgemm" and cls in ("nan_logits", "hang"):
        # the ladders differ below the kernel: statuses and counters only
        assert m["replans"] >= 1 and dispatch.is_quarantined("msgemm_cuda")
        assert {p.backend for p in eng.exec_plans.values()} == \
            {"msgemm_torch"}
    else:
        assert ours == theirs
    if cls == "hang":
        assert m["replans"] >= 1
        assert all(s == "ok" for s, _ in ours.values())
    if cls == "step_fail":
        assert m["step_retries"] == 2


def _token_clock():
    """A clock that advances one unit per emitted token (and not
    otherwise): the same deadlines fire at the same tokens in both
    engines, whatever their wall times."""
    t = [0.0]

    def on_token(rid, tok, text):
        t[0] += 1.0

    return (lambda: t[0]), on_token


@pytest.mark.parametrize("case", [
    ("deadline", {}, dict(deadline_s=7.5)),
    ("ttft", {}, dict(ttft_deadline_s=2.5)),
    ("request-deadline", dict(deadline_s=9.5), {}),
    ("queue-full", {}, dict(max_slots=1, max_queue=1)),
], ids=lambda c: c[0])
def test_deadlines_and_shedding_match_reference(models, case):
    _, reqs_kw, engine_kw = case
    both = _both(models, "bf16", None, reqs_kw=reqs_kw, clock=_token_clock,
                 **engine_kw)
    (jeng, theirs), (eng, ours) = both["ref"], both["port"]
    assert ours == theirs
    jm, m = jeng.metrics(), eng.metrics()
    assert {k: m[k] for k in COUNTERS} == {k: jm[k] for k in COUNTERS}
    statuses = [s for s, _ in ours.values()]
    assert any(s != "ok" for s in statuses), statuses  # the case bites


def test_deadline_hopeless_matches_reference(models):
    """The same p95 queue wait in both registries sheds the same request
    at submission."""
    got = {}
    for side, (o, eng_cls, req_cls, params, cfg) in {
            "ref": (jobs, JEngine, JRequest, models["bf16"][0], CFG),
            "port": (obs, Engine, Request, models["bf16"][2],
                     models["bf16"][3])}.items():
        o.registry().reset(prefix="serving_")
        for v in (0.5, 5.0, 6.0):
            o.registry().histogram("serving_queue_wait_s").observe(v)
        eng = _engine(params, cfg, cls=eng_cls)
        reqs = [req_cls(rid=i, prompt=p, max_new_tokens=3,
                        deadline_s=None if i % 2 else 1.0)
                for i, p in enumerate(PROMPTS)]
        res = eng.run(reqs)
        got[side] = ({i: (res[i].status, res[i].generated)
                      for i in sorted(res)}, eng.metrics()["shed"])
    assert got["port"] == got["ref"] and got["port"][1] == 2
