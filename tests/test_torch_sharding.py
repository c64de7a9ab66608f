"""Port parity, the mesh's rules and specs without processes:
``repro_torch.distributed.sharding`` (the rule tables and the spec
trees), ``repro_torch.dispatch.shard`` (ShardSpec, shard_spec_for and
the plan keys), ``distributed.collectives.collective_cost`` and
``kernels.ops.k_chunk_params``, against the reference's own functions on
shape-only meshes (the reference's ``FakeMesh``).

The port's trees have no stacked 'layers' dim (one module a layer), so
a port spec is held equal to the reference's without its leading entry,
leaf for leaf through ``convert.port_path``.  Everything here is exact.
"""

import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_plan_isolation import (  # noqa: E402,F401  (autouse)
    isolated_plan_cache, isolated_plan_cache_module)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as j_configs  # noqa: E402
from repro.core.spec import QuantSpec as JSpec  # noqa: E402
from repro import dispatch as jdispatch  # noqa: E402
from repro.dispatch import shard as jshard  # noqa: E402
from repro.distributed import collectives as jcoll  # noqa: E402
from repro.distributed import sharding as jshd  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.quant import quantize_model as j_quantize  # noqa: E402
from repro.runtime import serve as JSV  # noqa: E402
from repro_torch import convert, dispatch, obs  # noqa: E402
from repro_torch.core.spec import QuantSpec  # noqa: E402
from repro_torch.device import generator  # noqa: E402
from repro_torch.dispatch import autotune as at  # noqa: E402
from repro_torch.dispatch.shard import ShardSpec, shard_spec_for  # noqa: E402
from repro_torch.distributed import collectives as coll  # noqa: E402
from repro_torch.distributed import compat  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.runtime import serve as TSV  # noqa: E402


class FakeMesh:
    """Shape-only stand-in so rule tests don't touch devices."""

    def __init__(self, **shape):
        self.shape = shape
        self.axis_names = tuple(shape)


MESH = FakeMesh(data=16, model=16)
POD = FakeMesh(pod=2, data=16, model=16)
MESH24 = FakeMesh(data=2, model=4)
MESHES = {"data16.model16": MESH, "pod2.data16.model16": POD,
          "data2.model4": MESH24}
RULES = ("default", "serve_tp", "serve")
ARCHS = ("gemma_2b", "starcoder2_15b", "gemma2_9b")


def _pad(spec, ndim) -> tuple:
    return tuple(spec) + (None,) * (ndim - len(spec))


def spec(axes, shape, kind="act", mesh=MESH):
    got = shd._resolve(tuple(axes), tuple(shape), mesh,
                       shd.RULE_SETS["default"][0 if kind == "act" else 1])
    want = jshd._resolve(tuple(axes), tuple(shape), mesh,
                         jshd.RULE_SETS["default"][0 if kind == "act" else 1])
    assert got == _pad(want, len(axes))
    return got


# ---------------------------------------- twins of tests/test_distributed
def test_tables_are_the_reference_tables():
    assert shd.PRIORITY == jshd.PRIORITY
    assert shd.ACT_RULES == jshd.ACT_RULES
    assert shd.PARAM_RULES == jshd.PARAM_RULES
    assert shd.RULE_SETS == jshd.RULE_SETS
    assert shd.LINEAR_AXES == jshd.LINEAR_AXES
    assert shd.VECTOR_AXES == jshd.VECTOR_AXES
    assert shd.CACHE_AXES == jshd.CACHE_AXES
    assert shd.PAGED_CACHE_AXES == jshd.PAGED_CACHE_AXES


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("rules", RULES)
def test_residual_axis_is_the_reference_pin(mesh, rules):
    """``sharding.residual_axis`` is the 'seq' entry of the reference's
    spec for the residual stream, ``("batch", "seq", "embed")`` under the
    same rules: 'model' wherever S divides it (decode's S = 1 never),
    else None; None without a mesh."""
    fm = MESHES[mesh]
    rows = 2 * fm.shape["data"] * fm.shape.get("pod", 1)
    for S in (1, 3, 12, 16, 4096, 4098, 32768):
        want = _pad(jshd.spec_for(("batch", "seq", "embed"), (rows, S, 2048),
                                  mesh=fm, rules=rules), 3)[1]
        with shd.use(fm, rules):
            assert shd.residual_axis(S) == want, S
        assert want == ("model" if S % fm.shape["model"] == 0 else None)
    assert shd.residual_axis(16) is None


def test_batch_folds_over_pod_and_data():
    assert spec(("batch", "seq"), (256, 4096), mesh=POD) == \
        (("pod", "data"), "model")


def test_heads_shard_when_divisible():
    s = spec(("batch", "seq", "heads", "head_dim"), (32, 4096, 48, 128))
    assert s == ("data", None, "model", None)


def test_seq_parallel_fallback_when_heads_dont_divide():
    """llama4: 40 heads % 16 != 0 -> seq takes the model axis."""
    s = spec(("batch", "seq", "heads", "head_dim"), (32, 4096, 40, 128))
    assert s == ("data", "model", None, None)


def test_kv_cache_seq_sharding_fallback():
    s = spec(("batch", "kv_seq", "kvheads", "head_dim"),
             (128, 32768, 4, 128))
    assert s == ("data", "model", None, None)
    s = spec(("batch", "kv_seq", "kvheads", "head_dim"),
             (128, 32768, 16, 128))
    assert s == ("data", None, "model", None)


def test_expert_ep_full_sharding():
    s = spec(("layers", "expert", "expert_out", "expert_in"),
             (24, 128, 8192, 5120), kind="param")
    assert s == (None, "model", "data", None)


def test_expert_fallback_per_expert_tp():
    s = spec(("layers", "expert", "expert_out", "expert_in"),
             (24, 60, 1408, 2048), kind="param")
    assert s == (None, None, "model", None)


def test_param_fsdp_embed_on_data():
    assert spec(("mlp", "embed"), (24576, 6144), kind="param") == \
        ("model", "data")


def test_constrain_noop_without_mesh():
    x = torch.ones((4, 4))
    assert shd.constrain(x, "batch", "embed") is x
    assert shd.gather_rows(x) is x and shd.rows_factor() == 1


def test_spec_for_without_mesh_and_placements():
    from torch.distributed.tensor import Replicate, Shard

    assert shd.spec_for(("batch", "embed"), (4, 4)) == ()
    assert compat.axes_of(MESH24) == {"data": 2, "model": 4}
    assert compat.placements(("data", None, "model"), MESH24) == \
        (Shard(0), Shard(2))
    assert compat.placements((None, None), MESH24) == \
        (Replicate(), Replicate())
    assert compat.placements((("pod", "data"), "model"), POD) == \
        (Shard(0), Shard(0), Shard(1))


# --------------------------------------------------- spec trees, per leaf
def _ref_leaves(tree):
    """{'a/b/c': shape} of a reference pytree (of arrays or shapes)."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        name = "/".join(str(getattr(p, "key", getattr(p, "name", p)))
                        for p in path)
        out[name] = leaf
    return out


def _port_map(ref: dict, tcfg) -> dict:
    """Reference {stacked path: value (G, ...)} -> {port name: value of
    slice g} through ``convert.port_path``."""
    out = {}
    for path, v in ref.items():
        parts = path.split("/")
        if "blocks" in parts[:2]:
            for g in range(tcfg.num_layers // len(tcfg.block_pattern)):
                out[convert.port_path(path, g, tcfg)] = ("stacked", v)
        else:
            out[path.replace("/", ".")] = ("whole", v)
    return out


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    """(reference dense and msgemm param shapes, port dense and msgemm
    models, reference cfg, port cfg) of one SMOKE config."""
    jcfg = j_configs.get_smoke(request.param)
    tcfg = convert.config_from_jax(jcfg)
    dense = jax.eval_shape(lambda: JT.init_params(jax.random.PRNGKey(0),
                                                  jcfg))
    jq = JSpec(mode="msgemm", d=3, scale_block=36)
    quant = jax.eval_shape(lambda: j_quantize(
        JT.init_params(jax.random.PRNGKey(0), jcfg), jcfg, jq))
    tq = QuantSpec(mode="msgemm", d=3, scale_block=36)
    gen = lambda: generator(0, "cpu")  # noqa: E731
    return dict(ref={"dense": dense, "msgemm": quant},
                port={"dense": TT.init_params(tcfg, generator=gen(),
                                              device="cpu"),
                      "msgemm": TT.init_params(tcfg, generator=gen(),
                                               device="cpu", quant=tq)},
                jcfg=jcfg, tcfg=tcfg)


@pytest.mark.parametrize("rules", RULES)
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("weights", ["dense", "msgemm"])
def test_param_specs_match_reference(models, weights, mesh, rules):
    """Leaf for leaf: the port's buffers are the reference's leaves (one a
    layer), and each spec is the reference's without its 'layers'
    entry."""
    fm = MESHES[mesh]
    ref = _ref_leaves(jshd.param_specs(models["ref"][weights], fm, rules))
    shapes = _ref_leaves(models["ref"][weights])
    want = _port_map({p: (_pad(s, len(shapes[p].shape)))
                      for p, s in ref.items()}, models["tcfg"])
    got = shd.param_specs(models["port"][weights], fm, rules)
    assert set(got) == set(want)
    for name, (kind, s) in want.items():
        assert got[name] == (s[1:] if kind == "stacked" else s), name
    placed = shd.shardings(models["port"][weights], fm, rules)
    assert set(placed) == set(got)


@pytest.mark.parametrize("rules", RULES)
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_cache_specs_match_reference(models, mesh, rules):
    fm, jcfg, tcfg = MESHES[mesh], models["jcfg"], models["tcfg"]
    jcache = jax.eval_shape(lambda: JT.init_cache(jcfg, 32, 64))
    ref = jshd.cache_specs(jcache, fm, rules)
    got = shd.cache_specs(TT.init_cache(tcfg, 32, 64, device="cpu"), fm,
                          rules)
    P = len(tcfg.block_pattern)
    assert len(got) == tcfg.num_layers
    for layer, leaves in enumerate(got):
        group = ref[f"{layer % P}:{tcfg.block_pattern[layer % P]}"]
        assert set(leaves) == set(group)
        for name, s in leaves.items():
            nd = len(jcache[f"{layer % P}:{tcfg.block_pattern[layer % P]}"]
                     [name].shape)
            assert s == _pad(group[name], nd)[1:], (layer, name)


@pytest.mark.parametrize("rules", RULES)
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("kv_bits", [16, 8])
def test_paged_cache_and_batch_specs_match_reference(models, mesh, rules,
                                                     kv_bits):
    from repro.kvq import KVQuantSpec as JKV
    from repro_torch.kvq import KVQuantSpec as TKV

    fm, jcfg, tcfg = MESHES[mesh], models["jcfg"], models["tcfg"]
    jspec = None if kv_bits == 16 else JKV(bits=kv_bits)
    tspec = None if kv_bits == 16 else TKV(bits=kv_bits)
    jpool = jax.eval_shape(lambda: JSV.init_paged_cache(
        jcfg, 64, 8, kv_spec=jspec))
    ref = jshd.paged_cache_specs(jpool, fm, rules)
    got = shd.paged_cache_specs(
        TSV.init_paged_cache(tcfg, 64, 8, device="cpu", kv_spec=tspec), fm,
        rules)
    P = len(tcfg.block_pattern)
    for layer, leaves in enumerate(got):
        key = f"{layer % P}:{tcfg.block_pattern[layer % P]}"
        assert set(leaves) == set(ref[key])
        for name, s in leaves.items():
            nd = len(jpool[key][name].shape)
            assert s == _pad(ref[key][name], nd)[1:], (layer, name)
    batch = {"tokens": (32, 16), "labels": (32, 16), "token": (32,),
             "pos": (32,), "embeds": (32, 16, 64)}
    jbatch = {k: jax.ShapeDtypeStruct(v, jnp.int32) for k, v in batch.items()}
    want = jshd.batch_specs(jbatch, fm, rules)
    got = shd.batch_specs(batch, fm, rules)
    assert got == {k: _pad(v, len(batch[k])) for k, v in want.items()}


def _fields(s):
    return None if s is None else (
        tuple(s.mesh_axes), s.m, s.k, s.batch, s.collective,
        s.pipeline_chunks, s.collective_impl, s.tag())


def _linears(cfg):
    """(tag, m, k) of every linear of a dense decoder config."""
    d, h, hk, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    out = [("wq", h * dh, d), ("wk", hk * dh, d), ("wv", hk * dh, d),
           ("wo", d, h * dh), ("up", cfg.d_ff, d), ("gate", cfg.d_ff, d),
           ("down", d, cfg.d_ff)]
    if not cfg.tie_embeddings:
        out.append(("lm_head", cfg.vocab_size, d))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_shard_spec_for_every_linear_matches_reference(arch):
    """shard_spec_for on every linear of the config, at each mesh, rule
    set, collective, pipeline request and quantization, at a dividing and
    a ragged batch: the reference's ShardSpec, field for field and tag."""
    jcfg = j_configs.get_smoke(arch)
    full = j_configs.get_config(arch)
    n = 0
    for cfg in (jcfg, full):
        for (tag, m, k), mesh, rules, coll_, (pc, impl), q, batch in \
                itertools.product(
                    _linears(cfg), MESHES.values(), RULES,
                    ("psum", "reduce_scatter"),
                    ((1, "xla"), (2, "ring"), (3, "xla")),
                    ((3, 36, "msgemm"), (2, 8, "msgemm"),
                     (2, 8, "int4_dequant"), (3, 36, "bf16")),
                    (32, 3)):
            d, sb, mode = q
            kw = dict(mode=mode, d=d, scale_block=sb,
                      storage="packed_u8" if mode == "int4_dequant"
                      else "packed_idx")
            args = (shd.LINEAR_AXES[tag], m, k, batch * 4, mesh)
            opts = dict(lead_batch=batch, collective=coll_, rules=rules,
                        pipeline_chunks=pc, collective_impl=impl)
            want = jshard.shard_spec_for(JSpec(**kw), *args, **opts)
            got = shard_spec_for(QuantSpec(**kw), *args, **opts)
            assert _fields(got) == _fields(want), (tag, mesh.shape, rules,
                                                   opts, q)
            n += 1
    assert n > 1000


def test_shard_linear_cuts_the_planned_layout():
    """shard_linear takes this rank's rows (column-parallel) or packed
    columns (row-parallel) and leaves an unsplittable linear whole; on a
    shape-only mesh the coordinate comes from ``get_local_rank``."""
    from repro_torch.core import linear as qlinear
    from repro_torch.dispatch.shard import shard_linear

    class RankMesh(FakeMesh):
        def get_local_rank(self, axis):
            return 1

    mesh = RankMesh(model=2)
    spec = QuantSpec(mode="msgemm", d=2, scale_block=8)
    w = torch.randn(16, 32, generator=generator(0, "cpu"))
    leaves = qlinear.from_dense(w, spec)
    col = shard_linear(spec, ("mlp", "embed"), leaves, 16, 32, mesh)
    assert torch.equal(col["idx"], leaves["idx"][8:])
    assert torch.equal(col["scales"], leaves["scales"][8:])
    row = shard_linear(spec, ("embed", "mlp"), leaves, 16, 32, mesh)
    assert torch.equal(row["idx"], leaves["idx"][:, 8:])
    assert torch.equal(row["scales"], leaves["scales"][:, 2:])
    # k_local = 12 is no multiple of scale_block 8: whole
    odd = qlinear.from_dense(torch.randn(16, 24), spec)
    assert shard_linear(spec, ("embed", "mlp"), odd, 16, 24, mesh) is odd


# ------------------- twins of tests/test_sharded_serving.py's derivations
SPEC = QuantSpec(mode="msgemm", d=2, scale_block=8)
MESH42 = FakeMesh(data=2, model=4)


def test_shard_spec_column_parallel():
    s = shard_spec_for(SPEC, ("mlp", "embed"), 64, 32, 32, MESH42,
                       lead_batch=4)
    assert (s.m, s.k, s.batch) == ("model", None, "data")
    assert s.local_mkb(64, 32, 32) == (16, 32, 16)
    assert "model4" in s.tag() and "m=model" in s.tag()


def test_shard_spec_row_parallel_and_alignment():
    s = shard_spec_for(SPEC, ("embed", "mlp"), 32, 64, 32, MESH42,
                       lead_batch=4)
    assert (s.m, s.k) == (None, "model") and s.collective == "psum"
    assert shard_spec_for(SPEC, ("embed", "mlp"), 32, 36, 3, MESH42,
                          lead_batch=3) is None


def test_shard_spec_reduce_scatter_fallback():
    s = shard_spec_for(SPEC, ("embed", "mlp"), 32, 64, 32, MESH42,
                       lead_batch=4, collective="reduce_scatter")
    assert s.collective == "reduce_scatter"
    s = shard_spec_for(SPEC, ("embed", "mlp"), 30, 64, 32, MESH42,
                       lead_batch=4, collective="reduce_scatter")
    assert s.collective == "psum"


def test_shard_spec_respects_rule_set():
    s = shard_spec_for(SPEC, ("mlp", "embed"), 64, 32, 32, MESH42,
                       lead_batch=4, rules="serve_tp")
    assert (s.m, s.batch) == ("model", None)
    s = shard_spec_for(SPEC, ("mlp", "embed"), 64, 32, 32, MESH42,
                       lead_batch=4, rules="serve")
    assert (s.m, s.batch) == ("model", "data")


def test_shard_spec_adaptive_d_never_shards():
    spec = QuantSpec(mode="msgemm", d="adaptive", scale_block=12)
    assert shard_spec_for(spec, ("mlp", "embed"), 64, 36, 32, MESH42,
                          lead_batch=4) is None


def test_shard_spec_validation():
    with pytest.raises(ValueError):
        ShardSpec(mesh_axes=(("model", 4),), m="model", k="model")
    with pytest.raises(ValueError):
        ShardSpec(collective="allreduce")
    with pytest.raises(ValueError):
        dispatch.ExecPolicy(shard_collective="bogus")


def test_plan_key_carries_shard_tag():
    key = dispatch.plan_key("msgemm_cuda", SPEC, 2, 16, 32, 8, "cpu",
                            shard="data2.model4/m=model/k=-/b=data/psum")
    assert key.endswith("|shdata2.model4/m=model/k=-/b=data/psum")
    want = jdispatch.plan_key(
        "msgemm_cuda", JSpec(mode="msgemm", d=2, scale_block=8), 2, 16, 32,
        8, "cpu", shard="data2.model4/m=model/k=-/b=data/psum")
    assert key == want


def _fallbacks(kind, **labels):
    return obs.registry().counter(
        "dispatch_shard_collective_fallback_total",
        kind=kind, **labels).value


def test_shard_spec_pipelined_tag_additive():
    base = shard_spec_for(SPEC, ("embed", "mlp"), 32, 64, 32, MESH42,
                          lead_batch=4)
    piped = shard_spec_for(SPEC, ("embed", "mlp"), 32, 64, 32, MESH42,
                           lead_batch=4, pipeline_chunks=2,
                           collective_impl="ring")
    assert not base.is_pipelined and "/pc" not in base.tag()
    assert piped.is_pipelined and piped.tag() == base.tag() + "/pc2.ring"
    assert base.exec_mkb(32, 64, 32) == base.local_mkb(32, 64, 32)
    lm, lk, lb = piped.local_mkb(32, 64, 32)
    assert piped.exec_mkb(32, 64, 32) == (lm, lk // 2, lb)


def test_reduce_scatter_fallback_counted():
    before = _fallbacks("reduce_scatter_to_psum", axis="model")
    s = shard_spec_for(SPEC, ("embed", "mlp"), 30, 64, 32, MESH42,
                       lead_batch=4, collective="reduce_scatter")
    assert s.collective == "psum"
    assert _fallbacks("reduce_scatter_to_psum", axis="model") == before + 1
    s = shard_spec_for(SPEC, ("embed", "mlp"), 30, 64, 32, MESH42,
                       lead_batch=4, collective="reduce_scatter",
                       pipeline_chunks=2, collective_impl="ring")
    assert s.collective == "psum"
    assert (s.pipeline_chunks, s.collective_impl) == (2, "ring")
    assert _fallbacks("reduce_scatter_to_psum", axis="model") == before + 2


def test_pipeline_chunks_clamped_counted():
    before = _fallbacks("pipeline_chunks_clamped", axis="model",
                        requested=3, clamped=2)
    s = shard_spec_for(SPEC, ("embed", "mlp"), 32, 64, 32, MESH42,
                       lead_batch=4, pipeline_chunks=3)
    assert s.pipeline_chunks == 2
    assert _fallbacks("pipeline_chunks_clamped", axis="model",
                      requested=3, clamped=2) == before + 1
    s = shard_spec_for(SPEC, ("embed", "mlp"), 32, 32, 32, MESH42,
                       lead_batch=4, pipeline_chunks=2)
    assert s.pipeline_chunks == 1 and "/pc" not in s.tag()
    assert _fallbacks("pipeline_chunks_clamped", axis="model",
                      requested=2, clamped=1) >= 1


def test_pipelined_spec_validation():
    with pytest.raises(ValueError):
        ShardSpec(mesh_axes=(("model", 4),), k="model",
                  collective_impl="bogus")
    with pytest.raises(ValueError):
        ShardSpec(mesh_axes=(("model", 4),), k="model", pipeline_chunks=0)
    with pytest.raises(ValueError):  # pipelining needs a k axis
        ShardSpec(mesh_axes=(("model", 4),), m="model", pipeline_chunks=2)
    with pytest.raises(ValueError):
        dispatch.ExecPolicy(shard_impl="bogus")
    with pytest.raises(ValueError):
        dispatch.ExecPolicy(shard_pipeline=-1)


def test_plan_cache_shard_variants_roundtrip(tmp_path):
    """shard_variants is an additive table: files without it load (and
    answer None), files with it round-trip."""
    import json

    from repro_torch.obs import artifacts

    path = tmp_path / "plans.json"
    c1 = at.PlanCache(path)
    assert c1.shard_variant("k") is None  # no file at all
    c1.put_shard_variant("k", {"pipeline_chunks": 2,
                               "collective_impl": "ring", "rows": []})
    c2 = at.PlanCache(path)
    assert c2.shard_variant("k")["pipeline_chunks"] == 2
    doc = json.loads(path.read_text())
    doc.pop("shard_variants")
    doc.pop("crc", None)
    artifacts.atomic_write_json(path, artifacts.stamp_crc(doc))
    c3 = at.PlanCache(path)
    assert c3.shard_variant("k") is None
    assert len(c3) == len(c2)


# ------------------------------------------------- costs, contraction chunks
def test_collective_cost_matches_reference():
    n = 0
    for impl, c, size, elems, db, pc in itertools.product(
            ("xla", "ring"), ("psum", "reduce_scatter"), (1, 2, 3, 4, 16),
            (0, 7, 64, 4096, 12288), (2, 4), (1, 2, 3, 4)):
        kw = dict(impl=impl, collective=c, axis_size=size, elems=elems,
                  dtype_bytes=db, pipeline_chunks=pc)
        assert coll.collective_cost(**kw) == jcoll.collective_cost(**kw)
        n += 1
    assert n == 800


@pytest.mark.parametrize("chunks", [1, 2, 3, 4])
def test_k_chunk_params_matches_reference(chunks):
    """Every leaf's chunk (its own column density) equals the reference's
    slice; the codebook goes whole into every chunk; a misaligned chunk
    count raises on both sides."""
    rng = np.random.default_rng(chunks)
    k, d, sb = 144, 3, 12
    leaves = {"w": rng.standard_normal((8, k)).astype(np.float32),
              "idx": rng.integers(0, 4096, (8, k // d)).astype(np.int32),
              "u8": rng.integers(0, 256, (8, k // 2)).astype(np.uint8),
              "scales": rng.random((8, k // sb)).astype(np.float32),
              "codebook": rng.random(16).astype(np.float32)}
    want = jops.k_chunk_params({n: jnp.asarray(v) for n, v in leaves.items()},
                               k=k, chunks=chunks, d=d, scale_block=sb)
    got = ops.k_chunk_params({n: torch.from_numpy(v)
                              for n, v in leaves.items()},
                             k=k, chunks=chunks, d=d, scale_block=sb)
    assert len(got) == len(want) == chunks
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for name in g:
            np.testing.assert_array_equal(g[name].numpy(),
                                          np.asarray(w[name]))
    with pytest.raises(ValueError):
        ops.k_chunk_params({"idx": torch.zeros(2, 5)}, k=15, chunks=2, d=3)
    with pytest.raises(ValueError):
        jops.k_chunk_params({"idx": jnp.zeros((2, 5))}, k=15, chunks=2, d=3)


@pytest.mark.parametrize("chunks", [0, -1])
def test_shard_pipeline_below_one_refused(chunks):
    """``shard_pipeline`` below 0 is refused by the policy and the serve
    CLI; 0 (the tuned variant) derives the one-shot layout first and
    replays the variant the cache stores for that key, as the
    reference's ``plan`` does (the one-shot layout where none is
    stored)."""
    from repro_torch.launch import serve as S

    axes = ("embed", "mlp")
    if chunks < 0:
        with pytest.raises(ValueError, match="shard_pipeline"):
            dispatch.ExecPolicy(shard_pipeline=chunks)
        with pytest.raises(SystemExit, match="--shard-pipeline"):
            S.main(["--arch", "gemma_2b", "--smoke", "--device", "cpu",
                    "--engine", "continuous", "--mesh", "model=2",
                    "--force-host-devices", "2",
                    "--shard-pipeline", str(chunks)])
        return
    policy = dispatch.ExecPolicy(shard_pipeline=chunks)
    with shd.use(MESH42, "serve"), dispatch.using_policy(policy):
        base = dispatch.plan(SPEC, 32, 64, 4, device_type="cpu",
                             shard_axes=axes, lead_batch=4)
        assert base.shard.pipeline_chunks == 1
        assert base.shard.collective_impl == "xla"
        lm, lk, lb = base.shard.exec_mkb(32, 64, 4)
        key = dispatch.plan_key(base.backend, SPEC, 2, lm, lk, lb, "cpu",
                                shard=base.shard.tag())
        at.cache().put_shard_variant(key, {"pipeline_chunks": 2,
                                           "collective_impl": "ring"},
                                     persist=False)
        again = dispatch.plan(SPEC, 32, 64, 4, device_type="cpu",
                              shard_axes=axes, lead_batch=4)
    assert (again.shard.pipeline_chunks, again.shard.collective_impl) == \
        (2, "ring")
    assert again.shard.tag() == base.shard.tag() + "/pc2.ring"


class _RankMesh(FakeMesh):
    """A shape-only mesh seen from its rank at coordinate 0 of every
    axis: ``runtime.serve.shard_params`` cuts that rank's blocks."""

    def get_local_rank(self, axis):
        return 0


DATA_CUT_ARCHS = ("gemma_2b", "jamba_v01", "qwen2_moe", "whisper_medium")
DATA_CUT_MESHES = {"data2.model2": dict(data=2, model=2),
                   "data4": dict(data=4),
                   "data16.model16": dict(data=16, model=16)}


@pytest.mark.parametrize("mode", ["msgemm", "int4_dequant"])
@pytest.mark.parametrize("mesh", sorted(DATA_CUT_MESHES))
@pytest.mark.parametrize("arch", DATA_CUT_ARCHS)
def test_default_rules_store_the_reference_data_cut(arch, mesh, mode):
    """``shard_params(..., "default")`` stores every leaf as 'serve' does,
    except that a leaf whose dim takes 'data' under the reference's
    ``param_specs(..., "default")`` (on its packed leaves) holds its
    1/data block of that dim, where the stored dim divides; the cut is
    recorded on the block (or the head) that gathers it, an expert
    stack's on its ``Experts`` module instead (``data_out``: the stack
    stays cut and the tokens move to it)."""
    jcfg = j_configs.get_smoke(arch)
    tcfg = convert.config_from_jax(jcfg)
    storage = "packed_u8" if mode == "int4_dequant" else "packed_idx"
    jq = JSpec(mode=mode, d=2, scale_block=8, storage=storage)
    jshapes = jax.eval_shape(lambda: j_quantize(
        JT.init_params(jax.random.PRNGKey(0), jcfg), jcfg, jq))
    tq = QuantSpec(mode=mode, d=2, scale_block=8, storage=storage)
    model = TT.init_params(tcfg, generator=generator(0, "cpu"),
                           device="cpu", quant=tq)
    tcfg = tcfg.replace(quant=tq)
    fm = _RankMesh(**DATA_CUT_MESHES[mesh])
    n = fm.shape["data"]
    ref = _ref_leaves(jshd.param_specs(jshapes, fm, "default"))
    shapes = _ref_leaves(jshapes)
    want = _port_map({p: _pad(s, len(shapes[p].shape))
                      for p, s in ref.items()}, tcfg)
    serve = dict(TSV.shard_params(model, tcfg, fm, "serve").named_buffers())
    local = TSV.shard_params(model, tcfg, fm, "default")
    got = dict(local.named_buffers())
    assert set(got) == set(serve)
    # an msgemm model's expert stacks are int4 in the port, msgemm in the
    # reference: those leaves differ, and the port's own 'default' specs
    # (held to the reference's above) decide them
    own = shd.param_specs(model, fm, "default")
    experts = {n for n in set(got) ^ set(want) if ".experts." in n}
    assert set(got) ^ set(want) == experts
    want = {n: want[n] if n in want else ("whole", own[n]) for n in got}
    recorded = {(f"{p}." if p else "") + k: d
                for p, mod in local.named_modules()
                for k, d in getattr(mod, "fsdp", {}).items()}
    cut = {}
    for name, (kind, s) in want.items():
        s = s[1:] if kind == "stacked" else s
        dim = coll.spec_dim(s, "data")
        shape = list(serve[name].shape)
        if dim is not None and shape[dim] % n == 0:
            shape[dim] //= n
            cut[name] = dim
        assert list(got[name].shape) == shape, name
    stacks = {n for n in cut if shd.is_stack(n)}
    assert cut and recorded == {n: d for n, d in cut.items()
                                if n not in stacks}
    held = {(f"{p}." if p else "") + s for p, mod in local.named_modules()
            for s in getattr(mod, "data_out", ())}
    assert held == {n.rpartition(".")[0] for n in stacks}
def test_production_mesh_needs_its_world():
    """The reference's production shapes build only over a world of
    exactly their size; this single process has none."""
    from repro_torch.launch import mesh as MS

    with pytest.raises(ValueError, match="256"):
        MS.make_production_mesh()
    with pytest.raises(ValueError, match="512"):
        MS.make_production_mesh(multi_pod=True)
    assert MS.parse_mesh("model=4,data=2") == ((4, 2), ("model", "data"))
    with pytest.raises(ValueError):
        MS.parse_mesh("model=x")
    assert MS.mesh_devices(POD) == 512
