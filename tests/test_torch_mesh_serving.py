"""Tensor-parallel serving of the port on the CPU: the continuous engine on
a (data=2, model=2) mesh of four gloo ranks (``launch.mesh.run_ranks``;
one spawn for the module, the rank body in ``tests/torch_mesh_ranks.py``)
against the port's single-device engine and the reference's single-device
engine, on the reference's sharded-serving config
(``tests/test_sharded_serving.py``: 2 layers, d_model 32, 4 heads, 2 kv
heads, d=2 / scale_block=8, so every linear shards on model=2).

The reference's own mesh engine fails under this JAX (ROADMAP C), so the
sharded engine is held to the single-device engines: greedy tokens equal
for msgemm, int4_dequant and bf16 weights, under reduce_scatter,
pipelining (2 chunks), mid-stream preemption, with a kv8 pool, under
the 'default' rules (the weights also stored cut over 'data', FSDP) for
msgemm and int4_dequant weights, and with the collective layouts tuned
(``shard_pipeline=0``: the twin of the reference's
``test_shard_variant_autotune_roundtrip``). Also: plans resolved at
build and keyed by the mesh, an off-mesh cache entry never replayed
sharded, the refusals (a recurrent model, which has no paged state,
``cuda_graph=True``, an unknown rule set), and the serve CLI's
``--mesh`` (``--shard-pipeline 0`` and ``--mesh-rules default`` too).
A rank keeps none of the whole model's weights but its copy's, whether
``Engine(mesh=)`` cut the copy or the serve CLI drew it a block at a
time (weak references to the whole model's leaves).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_plan_isolation import (  # noqa: E402,F401  (autouse)
    isolated_plan_cache, isolated_plan_cache_module)

import jax  # noqa: E402

import torch_mesh_ranks as R  # noqa: E402
from repro.core.spec import QuantSpec as JSpec  # noqa: E402
from repro.kvq import KVQuantSpec as JKV  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.config import ModelConfig as JModelConfig  # noqa: E402
from repro.quant import quantize_model as j_quantize  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.kvq import KVQuantSpec as TKV  # noqa: E402
from repro_torch.launch import serve as CLI  # noqa: E402
from repro_torch.launch.mesh import run_ranks  # noqa: E402
from repro_torch.serving import Engine, Request  # noqa: E402

CFG = JModelConfig(num_layers=2, d_model=32, num_heads=4, num_kv_heads=2,
                   d_ff=64, vocab_size=64, max_seq_len=64)
REC_CFG = CFG.replace(block_pattern=("attn", "mamba"))
BASE = dict(max_slots=4, block_size=4, prefill_chunk=4, max_model_len=32)
PREEMPT = dict(max_slots=2, block_size=4, prefill_chunk=8, num_blocks=7,
               max_model_len=16)


def _prompts(lens, seed):
    rng = np.random.default_rng(seed)
    return [tuple(int(t) for t in rng.integers(0, 64, size=L))
            for L in lens]


# name, weights, Engine kwargs (the mesh ones too), prompts, new tokens
SCENARIOS = [
    ("msgemm", "msgemm", BASE, _prompts((5, 9, 3, 7), 1), 4),
    ("int4_dequant", "int4_dequant", BASE, _prompts((5, 9, 3, 7), 1), 4),
    ("bf16", "bf16", BASE, _prompts((5, 9, 3, 7), 1), 4),
    ("reduce_scatter", "msgemm",
     dict(BASE, shard_collective="reduce_scatter"), _prompts((5, 9), 4), 4),
    ("pipelined", "msgemm", dict(BASE, shard_pipeline=2),
     _prompts((5, 9), 6), 4),
    ("preemption", "msgemm", PREEMPT, _prompts((6, 6), 5), 10),
    # after 'msgemm': the cache holds off-mesh twins of its plan keys
    ("offmesh_cache", "msgemm", BASE, _prompts((5,), 3), 3),
    # a kv8 pool, its kv heads split over 'model' with the weights
    ("kv8", "msgemm", dict(BASE, kv_quant=TKV(bits=8)),
     _prompts((6, 4), 7), 4),
    # FSDP storage: each rank keeps its 'data' block of the weights
    ("default_rules", "msgemm", dict(BASE, mesh_rules="default"),
     _prompts((5, 9, 3, 7), 1), 4),
    ("default_rules_int4", "int4_dequant",
     dict(BASE, mesh_rules="default"), _prompts((5, 9, 3, 7), 1), 4),
    # the collective layouts tuned at build (engine_rank's round trip)
    ("tuned", "msgemm", dict(BASE, shard_pipeline=0), _prompts((5, 9), 6),
     4),
]
# NaN logits injected on the leader: its guard quarantines the sequences
# and replans; the followers replan with it
REPLAN = ("replan", "msgemm", BASE, _prompts((5, 6, 4), 8), 4)
MESH_KW = ("shard_collective", "shard_pipeline", "shard_impl",
           "mesh_rules")


def _ref_tree(mode, cfg=CFG):
    params = JT.init_params(jax.random.PRNGKey(0), cfg)
    if mode == "bf16":
        return jax.tree.map(np.asarray, params), cfg
    spec = JSpec(mode=mode, d=2, scale_block=8,
                 storage="packed_u8" if mode == "int4_dequant"
                 else "packed_idx")
    q = j_quantize(params, cfg, spec)
    return jax.tree.map(np.asarray, q), cfg.replace(quant=spec)


@pytest.fixture(scope="module")
def weights():
    """{key: (numpy reference tree, reference cfg, port cfg)}."""
    out = {}
    for mode in ("msgemm", "int4_dequant", "bf16"):
        tree, jcfg = _ref_tree(mode)
        out[mode] = (tree, jcfg, convert.config_from_jax(jcfg))
    # the recurrent refusal reads the config alone
    out["recurrent"] = (None, REC_CFG, convert.config_from_jax(REC_CFG))
    return out


@pytest.fixture(scope="module")
def tune_caches(tmp_path_factory):
    """The plan-cache files of the 'tuned' scenario's builds: the layout
    tuner's, then the one that tunes the kernel tiles too."""
    d = tmp_path_factory.mktemp("tuned")
    return str(d / "plans.json"), str(d / "tiles.json")


@pytest.fixture(scope="module")
def sharded(weights, tune_caches):
    """The four ranks' results of every scenario, one spawn."""
    trees = {k: v[0] for k, v in weights.items() if v[0] is not None}
    tcfgs = {k: v[2] for k, v in weights.items()}
    return run_ranks(R.engine_rank, 4, trees, tcfgs, SCENARIOS + [REPLAN],
                     tune_caches, timeout=300)


def _single(weights, key, kw, prompts, new):
    """(port single-device tokens, preemptions, reference tokens)."""
    tree, jcfg, tcfg = weights[key]
    base = {k: v for k, v in kw.items() if k not in MESH_KW}
    eng = Engine(convert.params_from_jax(tree, tcfg, device="cpu"), tcfg,
                 **base)
    res = eng.run([Request(rid=i, prompt=p, max_new_tokens=new)
                   for i, p in enumerate(prompts)])
    if "kv_quant" in base:
        base = dict(base, kv_quant=JKV(bits=base["kv_quant"].bits))
    jeng = JEngine(jax.tree.map(jax.numpy.asarray, tree), jcfg, **base)
    jres = jeng.run([JRequest(rid=i, prompt=p, max_new_tokens=new)
                     for i, p in enumerate(prompts)])
    return ({r: s.generated for r, s in res.items()},
            eng.scheduler.num_preemptions,
            {r: s.generated for r, s in jres.items()})


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda s: s[0])
def test_mesh_engine_tokens_equal_single_device(weights, sharded,
                                                scenario):
    """Every rank returns the leader's results, and its greedy tokens equal
    the port's single-device engine's and the reference's."""
    name, key, kw, prompts, new = scenario
    port, preempts, ref = _single(weights, key, kw, prompts, new)
    assert port == ref
    runs = [r[name] for r in sharded]
    assert [r["leader"] for r in runs] == [True, False, False, False]
    for r in runs:
        assert r["tokens"] == port
    if name == "preemption":
        assert preempts > 0  # the scenario really preempts
        assert runs[0]["preemptions"] == preempts


def test_mesh_plans_resolved_at_build_and_keyed_by_mesh(sharded):
    """Every exec plan is resolved at build, keyed by the mesh; the linears
    shard (column- and row-parallel, the decode rows over 'data'); the
    collective and pipelining knobs reach the row-parallel plans."""
    plans = sharded[0]["msgemm"]["plans"]
    assert plans and all("|shdata2.model2" in k for k in plans)
    tags = {t for _, t in plans.values() if t is not None}
    assert any("/m=model/" in t for t in tags)
    assert any("/k=model/" in t for t in tags)
    assert any("/b=data/" in t for t in tags)
    rs = {t for _, t in sharded[0]["reduce_scatter"]["plans"].values() if t}
    assert any(t.endswith("/reduce_scatter") for t in rs)
    pc = {t for _, t in sharded[0]["pipelined"]["plans"].values() if t}
    assert any(t.endswith("/pc2.xla") for t in pc)
    assert all(r["msgemm"]["plans"] == plans for r in sharded)


def test_offmesh_cache_entry_never_replayed_sharded(sharded):
    """The plan cache held an off-mesh ('|sh-') plan on the plain backend
    for every key the engine asks for: the sharded engine keyed and
    planned past it."""
    plans = sharded[0]["offmesh_cache"]["plans"]
    assert plans and not any(k.endswith("|sh-") for k in plans)
    assert {b for b, _ in plans.values()} == {"msgemm_cuda"}


def test_mesh_replan_reaches_every_rank(sharded):
    runs = [r["replan"] for r in sharded]
    assert runs[0]["replans"] == 1
    assert [r["replans"] for r in runs] == [1, 1, 1, 1]
    assert sorted(runs[0]["status"].values()).count("quarantined") == 2
    assert all(r["tokens"] == runs[0]["tokens"] for r in runs)


def test_mesh_engine_refusals(sharded):
    assert sharded[0]["refusals"] == {"cuda_graph": "ValueError",
                                      "unknown_rules": "ValueError",
                                      "recurrent": "NotImplementedError"}


@pytest.mark.parametrize("name", ["default_rules", "default_rules_int4"])
def test_default_rules_store_weights_cut_over_data(sharded, name):
    """Under 'default' a rank holds fewer weight bytes than under 'serve'
    (its 'data' block of every leaf whose model dim takes 'data'), on
    the same plans."""
    serve = "msgemm" if name == "default_rules" else "int4_dequant"
    for r in sharded:
        assert r[name]["resident"] < 0.75 * r[serve]["resident"]
        assert r[name]["plans"] == r[serve]["plans"]


@pytest.mark.parametrize("how", ["engine", "cli"])
def test_mesh_rank_keeps_no_whole_model(sharded, how):
    """After ``Engine(mesh=)`` cuts its copy from a whole model (which the
    caller then drops), or the serve CLI draws a rank's copy a block at a
    time, under 'default' on (data=2, model=2): of the whole model's
    weight leaves (every linear's and expert stack's, a weak reference
    to each taken before its cut) none is alive but those the copy
    itself holds, and the cut ones are freed."""
    for r in sharded:
        got = r["ownership"][how]
        assert got["leaves"] > 0 and got["freed"] > 0
        assert got["stray"] == 0
    if how == "cli":
        assert sharded[0]["ownership"]["cli"]["served_on"] == (
            (("data", 2), ("model", 2)), "default")


def test_shard_variant_tuner_round_trip(sharded, tune_caches):
    """``shard_pipeline=0``: the first build times the variant grid of
    every row-parallel key and persists one winner a key with its rows
    (hops and bytes included); a rebuild from the file times none and
    gives equal plans; every rank holds the same winners and plans (the
    slowest rank's times decide), the kernel-tile winners too; the run
    replays the winners (its tokens: the scenario test)."""
    import json

    doc = json.loads(open(tune_caches[0]).read())
    table = doc["shard_variants"]
    assert table
    for key, v in table.items():
        assert "/k=model/" in key and "/pc" not in key
        assert {"pipeline_chunks", "collective_impl", "rows"} <= set(v)
        assert sum(r["winner"] for r in v["rows"]) == 1
        win = next(r for r in v["rows"] if r["winner"])
        assert (win["pipeline_chunks"], win["collective_impl"]) == \
            (v["pipeline_chunks"], v["collective_impl"])
        assert all({"s", "hops", "bytes", "device"} <= set(r)
                   and "interpret" not in r for r in v["rows"])
        assert (1, "xla") in {(r["pipeline_chunks"], r["collective_impl"])
                              for r in v["rows"]}
    runs = [r["tuned"] for r in sharded]
    assert runs[0]["tuner"]["timed"] == sum(len(v["rows"])
                                            for v in table.values())
    for r in runs:
        t = r["tuner"]
        assert t["rebuilt_timed"] == 0 and t["rebuilt_same"]
        assert t["variants"] == runs[0]["tuner"]["variants"]
        assert {k: v["pipeline_chunks"] for k, v in t["variants"].items()} \
            == {k: v["pipeline_chunks"] for k, v in table.items()}
        assert t["tile_plans"] == runs[0]["tuner"]["tile_plans"]
        assert r["plans"] == runs[0]["plans"]
    tags = {t for _, t in runs[0]["plans"].values() if t and "/k=" in t}
    winners = {(v["pipeline_chunks"], v["collective_impl"])
               for v in table.values()}
    if winners != {(1, "xla")}:
        assert any("/pc" in t for t in tags)


def test_cli_serves_on_a_mesh_of_host_ranks(capfd):
    out = CLI.main(["--arch", "gemma_2b", "--smoke", "--device", "cpu",
                    "--engine", "continuous", "--check", "--num-requests",
                    "2", "--new-tokens", "3", "--mesh", "model=2",
                    "--force-host-devices", "2"])
    text = capfd.readouterr().out
    assert "[serve] mesh {'model': 2}: " in text
    assert "plans resolved at build" in text and "sharded" in text
    assert "static-path parity check: 2/2 identical" in text
    assert out["checked"] == 2 and out["sharded"] > 0
    assert out["launches"]["msgemm"] == 0  # the CPU runs the plain version


def test_cli_refuses_what_it_cannot_serve_on_a_mesh(monkeypatch):
    from repro_torch.launch import mesh as MS

    monkeypatch.delenv(MS.HOST_DEVICES_ENV, raising=False)
    with pytest.raises(SystemExit, match="needs 4 devices"):
        CLI.main(["--arch", "gemma_2b", "--smoke", "--device", "cpu",
                  "--engine", "continuous", "--mesh", "model=4"])
    with pytest.raises(NotImplementedError, match="static engine"):
        CLI.main(["--arch", "xlstm_1b3", "--smoke", "--device", "cpu",
                  "--engine", "continuous", "--mesh", "model=2",
                  "--force-host-devices", "2"])
    # --shard-pipeline 0 (once refused) tunes the layouts, here with the
    # weights stored cut over 'data'
    out = CLI.main(["--arch", "gemma_2b", "--smoke", "--device", "cpu",
                    "--engine", "continuous", "--check", "--num-requests",
                    "2", "--new-tokens", "3", "--mesh", "data=2,model=2",
                    "--force-host-devices", "4", "--shard-pipeline", "0",
                    "--mesh-rules", "default"])
    assert out["checked"] == 2 and out["sharded"] > 0


def test_mesh_runner_failure_is_fatal_on_every_rank(weights, tmp_path):
    """A failure inside the leader's step, after its followers were told
    to step, is not retried (a retry would pair unlike collectives): the
    run fails at once on every rank instead of hanging."""
    import json

    tree, _, tcfg = weights["msgemm"]
    path = tmp_path / "leader.json"
    with pytest.raises(RuntimeError, match="rank [01] failed"):
        run_ranks(R.runner_failure_rank, 2, tree, tcfg,
                  _prompts((5, 7), 2), str(path), timeout=120)
    assert json.loads(path.read_text()) == {"calls": 2, "retries": 0}
