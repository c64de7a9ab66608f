"""Port parity, serving layer: the port's continuous-batching Engine gives
the same greedy tokens as the JAX Engine on the same weights and as the
port's static ``generate``, with chunked prefill and with preemption
(mirrors tests/test_serving.py); plus the copied scheduler and block pool
on their own."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_plan_isolation import (  # noqa: E402,F401  (autouse)
    isolated_plan_cache, isolated_plan_cache_module)
# one intra-op thread each: the suite runs in parallel workers
torch.set_num_threads(1)

import jax  # noqa: E402

from repro.core.spec import QuantSpec as JSpec  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.config import ModelConfig as JConfig  # noqa: E402
from repro.quant import quantize_model as j_quantize  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro_torch import convert, obs  # noqa: E402
from repro_torch.runtime import serve as TSV  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    BlockPool, Engine, Phase, Request, Scheduler, Sequence,
)

CFG = JConfig(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
              d_ff=128, vocab_size=211, max_seq_len=128)


@pytest.fixture(scope="module", params=["bf16", "msgemm"])
def pair(request):
    jp = JT.init_params(jax.random.PRNGKey(0), CFG)
    jcfg = CFG
    if request.param == "msgemm":
        spec = JSpec(mode="msgemm", d=3, scale_block=36)
        jp, jcfg = j_quantize(jp, CFG, spec), CFG.replace(quant=spec)
    tcfg = convert.config_from_jax(jcfg)
    model = convert.params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                                    device="cpu")
    return jp, jcfg, model, tcfg


def _prompts(lens, seed):
    rng = np.random.default_rng(seed)
    return [tuple(int(t) for t in rng.integers(0, CFG.vocab_size, size=L))
            for L in lens]


def _serve(engine_cls, req_cls, params, cfg, prompts, new, temperature=0.0,
           **kw):
    kw.setdefault("max_slots", 3)
    kw.setdefault("block_size", 4)
    kw.setdefault("prefill_chunk", 4)
    kw.setdefault("max_model_len", 64)
    eng = engine_cls(params, cfg, **kw)
    res = eng.run([req_cls(rid=i, prompt=p, max_new_tokens=new,
                           temperature=temperature)
                   for i, p in enumerate(prompts)])
    return eng, [res[i].generated for i in range(len(prompts))]


def _static(model, cfg, prompt, new):
    out = TSV.generate(model, cfg, torch.tensor([prompt], dtype=torch.int32),
                       max_new_tokens=new)
    return [int(t) for t in out[0]]


@pytest.mark.parametrize("lens,new,kw", [
    ((5, 11, 3, 8), 6, {}),
    ((23,), 5, dict(prefill_chunk=4)),  # chunk boundaries change nothing
    ((6, 6), 10, dict(max_slots=2, prefill_chunk=8, max_model_len=16,
                      num_blocks=7)),  # pool too small: preemption
], ids=["mixed", "chunked", "preempt"])
def test_engine_tokens_match_jax_engine_and_static(pair, lens, new, kw):
    jp, jcfg, model, tcfg = pair
    prompts = _prompts(lens, seed=sum(lens))
    eng, got = _serve(Engine, Request, model, tcfg, prompts, new, **kw)
    _, want = _serve(JEngine, JRequest, jp, jcfg, prompts, new, **kw)
    assert got == want
    for prompt, toks in zip(prompts, got):
        assert toks == _static(model, tcfg, prompt, new)
    if "num_blocks" in kw:
        assert eng.scheduler.num_preemptions > 0
    assert eng.pool.free_blocks == eng.pool.capacity  # no leaks


def test_sampled_tokens_match_jax_engine(pair):
    """Same weights, same numpy Gumbel draws -> same sampled tokens."""
    jp, jcfg, model, tcfg = pair
    prompts = _prompts((6, 4), seed=8)
    kw = dict(max_slots=2, prefill_chunk=8, max_model_len=32, sample_seed=7)
    _, got = _serve(Engine, Request, model, tcfg, prompts, 8,
                    temperature=5.0, **kw)
    _, want = _serve(JEngine, JRequest, jp, jcfg, prompts, 8,
                     temperature=5.0, **kw)
    assert got == want
    assert got[0] != _static(model, tcfg, prompts[0], 8)  # not greedy


def test_streaming_and_metrics(pair):
    _, _, model, tcfg = pair
    events = []
    prompts = _prompts((4, 6), seed=7)
    eng = Engine(model, tcfg, max_slots=2, block_size=4, prefill_chunk=8,
                 max_model_len=32,
                 on_token=lambda rid, tok, text: events.append((rid, tok)))
    res = eng.run([Request(rid=i, prompt=p, max_new_tokens=3)
                   for i, p in enumerate(prompts)])
    assert sorted(events) == sorted(
        (i, t) for i in res for t in res[i].generated)
    s = eng.summary()
    assert s["requests"] == 2 and s["generated_tokens"] == 6
    assert s["tok_per_s"] > 0 and s["latency_p95_s"] >= s["latency_p50_s"]
    assert s["intertoken_p50_s"] is not None
    assert eng.num_steps == s["prefill_steps"] + s["decode_steps"]


def test_oversized_request_rejected(pair):
    _, _, model, tcfg = pair
    eng = Engine(model, tcfg, max_slots=1, block_size=4, max_model_len=16)
    with pytest.raises(ValueError):
        eng.submit(Request(rid=0, prompt=tuple(range(14)), max_new_tokens=8))


# ------------------------------------------------ scheduler and block pool
def _seq(rid, plen, new=4):
    return Sequence(req=Request(rid=rid, prompt=tuple(range(1, plen + 1)),
                                max_new_tokens=new))


def test_scheduler_admits_fcfs_within_blocks():
    obs.registry().reset(prefix="serving_")
    pool = BlockPool(num_blocks=5, block_size=4)
    sched = Scheduler(pool, max_slots=4, prefill_chunk=8)
    big, small, third, fourth = _seq(0, 12), _seq(1, 4), _seq(2, 8), \
        _seq(3, 4)
    for s in (big, small):
        sched.add(s)
    sched._admit()
    assert big.phase is Phase.PREFILL and small.phase is Phase.PREFILL
    for s in (third, fourth):
        sched.add(s)
    kind, seq, start, end = sched.schedule()
    assert kind == "prefill" and seq is big and (start, end) == (0, 8)
    assert third.phase is Phase.WAITING and fourth.phase is Phase.WAITING
    sched.finish(big)
    sched._admit()
    assert third.admit_seqno < fourth.admit_seqno
    # one queue-wait observation per admission, in the registry
    assert obs.registry().value("histogram", "serving_queue_wait_s") == 4


def test_scheduler_preempts_latest_and_self():
    pool = BlockPool(num_blocks=5, block_size=4)
    sched = Scheduler(pool, max_slots=2, prefill_chunk=8)
    a, b = _seq(0, 8, new=9), _seq(1, 8, new=9)
    sched.add(a)
    sched.add(b)
    sched._admit()
    a.phase = b.phase = Phase.DECODE
    a.generated = [7]
    assert sched.grow_for_decode(a) is True
    assert b.phase is Phase.WAITING and sched.waiting[0] is b
    pool = BlockPool(num_blocks=4, block_size=4)
    sched = Scheduler(pool, max_slots=2, prefill_chunk=8)
    a, b = _seq(0, 8, new=9), _seq(1, 4, new=9)
    sched.add(a)
    sched.add(b)
    sched._admit()
    a.phase = b.phase = Phase.DECODE
    b.generated = [1, 2, 3, 4, 5]
    assert sched.grow_for_decode(b) is False
    assert pool.free_blocks == 1


def test_block_pool_rejects_bad_frees():
    pool = BlockPool(num_blocks=3, block_size=2)
    got = pool.alloc(2)
    assert pool.alloc(1) is None
    pool.free(got)
    for bad in ([got[0]], [0], [9]):
        with pytest.raises(ValueError):
            pool.free(bad)
