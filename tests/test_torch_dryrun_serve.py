"""The dry run's serve cells (``repro_torch.launch.dryrun``): one rank of
a mesh on a fake process group, its weights (msgemm, d=3 /
scale_block=36, cut by ``runtime.serve.shard_params``) and inputs as fake
tensors, running one real prefill or decode step.

* a prefill cell and a decode cell of gemma-2b SMOKE (one kv head: the
  decode cache splits its sequence over 'model') on (data=2, model=2),
  at a small shape, under the 'default' rules (the dry run's default:
  FSDP weight storage, the blocks' weights gathered over 'data') and
  under 'serve', against a real four-rank gloo run of the same steps
  (``tests/torch_mesh_ranks.serve_cell_rank``): for each rank, its
  collectives by kind (count and bytes) and its argument bytes (weights,
  inputs, cache) are equal; the peak covers the arguments; 'default'
  holds fewer argument bytes than 'serve'; the same for qwen2-moe SMOKE
  under 'default' ('ep' on model=2, the expert stacks kept cut over
  'data' while the tokens move to them: none of them among the
  ``fsdp_gather`` bytes, the tokens' collectives counted);
* the same for gemma-2b SMOKE with 6 query heads over 3 kv heads, which
  cannot take 'model' (the attention whole on every rank): the prefill
  splits its query positions with the residual's (the blocks' K/V
  gathers, the blocks' input gathers and the lookup's reduce-scatter
  among the kinds), decode splits the cache's;
* on fake tensors the GeMM kernels allocate what their CUDA launch does,
  never the plain msGeMM's tables: a msGeMM call's fake output has the
  kernel's (m, b) shape and layout;
* every architecture's decode cells (jamba's and xlstm's long_500k
  too), and the prefill cells of those without a recurrent block, come
  back ``ok`` at SMOKE width on the single-pod mesh.
"""

import pytest

torch = pytest.importorskip("torch")
from torch_plan_isolation import (  # noqa: E402,F401  (autouse)
    isolated_plan_cache, isolated_plan_cache_module)
torch.set_num_threads(1)

import torch_mesh_ranks as R  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs import shapes as shp  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import run_ranks  # noqa: E402

SHAPE, AXES = (2, 2), ("data", "model")
SHAPES = (shp.Shape("prefill_t", 16, 4, "prefill"),
          shp.Shape("decode_t", 16, 4, "decode"))


def seq_config():
    """gemma-2b SMOKE with 6 query heads over 3 kv heads: on model=2 the
    kv heads do not split, so neither do the query heads."""
    return dryrun.serve_config("gemma_2b", smoke=True).replace(
        num_heads=6, num_kv_heads=3)


@pytest.fixture(scope="module")
def real():
    cfg = dryrun.serve_config("gemma_2b", smoke=True)
    return run_ranks(R.serve_cell_rank, 4, cfg, SHAPES, SHAPE, AXES, 0,
                     ("default", "serve"),
                     dryrun.serve_config("qwen2_moe", smoke=True),
                     seq_config(), timeout=120)


@pytest.mark.parametrize("rules", ["default", "serve"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: s.name)
@pytest.mark.parametrize("rank", [0, 3])
def test_fake_serve_cell_equals_a_real_step(real, shape, rank, rules):
    _check_serve_cell(dryrun.serve_config("gemma_2b", smoke=True),
                      real[rank], shape, rank, rules)


@pytest.mark.parametrize("rules", ["default", "serve"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: s.name)
@pytest.mark.parametrize("rank", [0, 3])
def test_fake_split_query_serve_cell_equals_a_real_step(real, shape, rank,
                                                        rules):
    """The heads-cannot-split case of the test above: the prefill's query
    positions split over 'model' with the residual's (its K/V gathers,
    the MLPs' input gathers and the vocab-split lookup's reduce-scatter
    counted by kind alike; at d=3 ``down``'s 128-wide k slice does not
    split its packed storage, so ``down`` runs whole and keeps its block
    of the positions), decode's cache positions."""
    from repro_torch.distributed import collectives as coll
    from repro_torch.models import layers as L

    cfg = seq_config()
    got = _check_serve_cell(cfg, real[rank]["seq"], shape, rank, rules)
    split = shape.kind == "prefill"

    def count(kind):
        return got["collectives"].get(kind, {}).get("count", 0)

    assert count(L.SEQ_KV) == (2 * cfg.num_layers if split else 0)
    assert count(coll.SEQ_IN) == (cfg.num_layers if split else 0)
    assert count(coll.SEQ_OUT) == (1 if split else 0)
    assert count("seq_out_gather") == 0


def _check_serve_cell(cfg, real, shape, rank, rules):
    got = dryrun.measure_serve(cfg, shape, SHAPE, AXES, rank=rank,
                               rules=rules)
    want = real[rules][shape.name]
    assert got["collectives"] == want["collectives"]
    assert got["memory"]["argument_bytes_per_device"] == \
        want["argument_bytes"]
    assert got["memory"]["peak_bytes_per_device"] >= \
        got["memory"]["argument_bytes_per_device"] > 0
    assert got["local_batch"] == shape.global_batch // 2
    if shape.kind == "decode":  # the split-sequence softmax
        assert got["collectives"]["all_reduce_max"]["count"] == \
            cfg.num_layers
    if rules == "default":  # each block's weights, gathered over 'data'
        assert got["collectives"]["fsdp_gather"]["count"] > 0
        assert want["argument_bytes"] < \
            real["serve"][shape.name]["argument_bytes"]
    return got


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: s.name)
@pytest.mark.parametrize("rank", [0, 3])
def test_fake_moe_serve_cell_equals_a_real_step(real, shape, rank):
    cfg = dryrun.serve_config("qwen2_moe", smoke=True)
    got = dryrun.measure_serve(cfg, shape, SHAPE, AXES, rank=rank,
                               rules="default")
    want = real[rank]["moe"][shape.name]
    assert got["collectives"] == want["collectives"]
    assert got["memory"]["argument_bytes_per_device"] == \
        want["argument_bytes"]
    assert got["memory"]["peak_bytes_per_device"] >= \
        got["memory"]["argument_bytes_per_device"] > 0
    for kind in ("expert_hidden", "expert_return", "fsdp_gather"):
        assert got["collectives"][kind]["count"] > 0, kind


def test_fake_msgemm_allocates_the_kernels_output_only():
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.core.spec import QuantSpec
    from repro_torch.kernels import ops

    spec = QuantSpec(mode="msgemm", d=3, scale_block=36)
    with FakeTensorMode():
        idx = torch.empty((8192, 683), dtype=torch.int32)
        sc = torch.empty((8192, 57), dtype=torch.float32)
        x = torch.empty((2048, 4), dtype=torch.float32)
        y = ops.msgemm(idx, x, spec.d, scales=sc,
                       scale_block=spec.scale_block)
    assert tuple(y.shape) == (8192, 4) and y.stride() == (1, 8192)


def test_a_fake_call_leaves_no_fake_table_behind():
    """A dry run's fake msGeMM, then a real one in the same process: the
    value table the fake call made is not the one the real call reads."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.core import packing
    from repro_torch.kernels import ops

    packing._DEVICE_VALUES.clear()
    with FakeTensorMode():
        ops.msgemm(torch.empty((16, 2), dtype=torch.int32),
                   torch.empty((6, 1)), 3, scales=torch.empty((16, 1)),
                   scale_block=6)
    idx = torch.arange(32, dtype=torch.int32).reshape(16, 2)
    x = torch.ones((6, 1))
    y = ops.msgemm(idx, x, 3, scales=torch.ones((16, 1)), scale_block=6)
    assert tuple(y.shape) == (16, 1) and torch.isfinite(y).all()


# a recurrent arch's prefill runs its scans step by step over 32768
# positions, which takes minutes on fake tensors: its decode cells stand
# for it here (the CLI's --all runs them all)
RECURRENT = ("jamba_v01", "xlstm_1b3")


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_every_serve_cell_runs(arch):
    names = ["decode_32k", "long_500k"]
    if arch not in RECURRENT:
        names.append("prefill_32k")
    for shape_name in names:
        ok, _ = shp.applicable(configs.get_smoke(arch), shape_name)
        res = dryrun.run_cell(arch, shape_name, multi_pod=False,
                              smoke=True, verbose=False)
        assert res["status"] == ("ok" if ok else "skipped"), res
        if ok:
            assert res["quant"] == "msgemm" and res["rules"] == "default"
