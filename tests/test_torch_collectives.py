"""The port's collectives and sharded linears on real process groups:
gloo ranks on the CPU (``launch.mesh.run_ranks``: spawned processes
joined through a ``FileStore`` under a temporary directory), at 2 and 4
ranks, one spawn of each size for the whole module.  The rank bodies are
in ``tests/torch_mesh_ranks.py`` (torch only).

* the ring collectives (point-to-point hops) against the group's own
  all-reduce / reduce-scatter / all-gather and against the sum or
  concatenation of the ranks' inputs, on dims that divide the axis and
  dims that do not: bit-exact on integer-valued inputs, within 1e-6 on
  random ones (a ring adds in another order);
* the all-to-all (``collectives.all_to_all``: block j of a dim to rank
  j, the received blocks concatenated along another) against a plain
  split and concatenation of the ranks' inputs, exactly; its autograd
  form's backward equal to the adjoint all-to-all (the two dims
  swapped) and to the plain split of the cotangents; counted under its
  kind with its bytes; the autograd gather under a kind of its own,
  its backward the reduce-scatter of the cotangents; all of it through
  the host-staged transport the CPU ranks use;
* ``dispatch.execute`` of one linear sharded by ``run_sharded``
  (column-parallel; row-parallel under psum, reduce_scatter, both as
  rings, pipelined in 2 and 3 chunks) for msgemm, int4_dequant and bf16
  weights, with a gelu, a bias and a residual: within 1e-5 of the
  unsharded linear, so the epilogue ran exactly once.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_plan_isolation import (  # noqa: E402,F401  (autouse)
    isolated_plan_cache, isolated_plan_cache_module)

import torch_mesh_ranks as R  # noqa: E402
from repro_torch import dispatch  # noqa: E402
from repro_torch.launch.mesh import run_ranks  # noqa: E402

SIZES = (2, 4)


@pytest.fixture(scope="module")
def ranks():
    """{n: (collectives results by rank, linear results by rank)}."""
    out = {}
    for n in SIZES:
        out[n] = (run_ranks(R.collectives_rank, n, n, timeout=120),
                  run_ranks(R.linears_rank, n, n, timeout=120))
    return out


def _inputs(n, shape, integer):
    return [R.coll_input(r, shape, integer) for r in range(n)]


@pytest.mark.parametrize("integer", [True, False], ids=["int", "float"])
@pytest.mark.parametrize("case", R.COLL_SHAPES, ids=lambda c: c[0])
@pytest.mark.parametrize("n", SIZES)
def test_ring_collectives_equal_the_groups(ranks, n, case, integer):
    name, shape, dim = case
    res = ranks[n][0]
    key = f"{name}-{'int' if integer else 'float'}"
    xs = _inputs(n, shape, integer)
    total = sum(xs[1:], xs[0])
    gathered = torch.cat(xs, dim=dim)
    close = (lambda a, b: torch.equal(a, b)) if integer else \
        (lambda a, b: torch.allclose(a, b, rtol=1e-6, atol=1e-6))
    size = shape[dim]
    for r in range(n):
        got = res[r]
        assert close(got[f"{key}-psum"], total)
        assert close(got[f"{key}-ring_psum"], total)
        if integer:
            assert torch.equal(got[f"{key}-ring_psum"], got[f"{key}-psum"])
        assert torch.equal(got[f"{key}-all_gather"], gathered)
        assert torch.equal(got[f"{key}-ring_all_gather"], gathered)
        if size % n:
            assert got[f"{key}-psum_scatter"] == "ValueError"
            assert got[f"{key}-ring_reduce_scatter"] == "ValueError"
            continue
        blk = total.narrow(dim % total.ndim, r * (size // n), size // n)
        assert close(got[f"{key}-psum_scatter"], blk)
        assert close(got[f"{key}-ring_reduce_scatter"], blk)


@pytest.mark.parametrize("n", SIZES)
def test_broadcast_and_coordinates(ranks, n):
    res = ranks[n][0]
    for r in range(n):
        assert torch.equal(res[r]["broadcast"], torch.zeros(3))
        assert res[r]["broadcast_object"] == {"rank": 0}
        assert res[r]["coord"] == r and res[r]["axis_size"] == n
        # the ring counts a hop each; psum_scatter is an all-reduce
        assert res[r]["counts"]["ring_hop"] > 0
        assert res[r]["counts"]["all_reduce"] > 0


@pytest.mark.parametrize("n", SIZES)
def test_all_to_all_equals_a_plain_split(ranks, n):
    """Rank r's result is block r (along dim 1) of every rank's input,
    concatenated along the last dim in rank order; the backward of the
    autograd form sends each rank's cotangent block back where it came
    from: the adjoint all-to-all, and the plain split of the
    cotangents."""
    res = ranks[n][0]
    xs = [R.a2a_input(r, "x") for r in range(n)]
    blk = R.A2A_SHAPE[1] // n
    width = R.A2A_SHAPE[-1]
    for r in range(n):
        a = res[r]["a2a"]
        want = torch.cat([x[:, r * blk:(r + 1) * blk] for x in xs], dim=-1)
        assert torch.equal(a["y"], want) and torch.equal(a["plain"], want)
        cs = [R.a2a_input(j, "c", tuple(want.shape)) for j in range(n)]
        grad = torch.cat([c[..., r * width:(r + 1) * width] for c in cs],
                         dim=1)
        assert torch.equal(a["grad"], grad)
        assert torch.equal(a["grad"], a["adjoint"])
        # forward and backward, each counted by its result's bytes
        assert a["count"] == 2 and a["nbytes"] == 2 * want.numel() * 4
        assert a["indivisible"] == "ValueError"
        assert res[r]["counts"]["all_to_all"] >= 2  # plain and adjoint
        assert res[r]["transport"] == "gloo, host-staged"


@pytest.mark.parametrize("n", SIZES)
def test_autograd_gather_counts_its_kind(ranks, n):
    """``ad_all_gather(kind=)``: the concatenation of the inputs, counted
    under the kind; its backward this rank's block of the sum of every
    rank's cotangent (the reduce-scatter)."""
    res = ranks[n][0]
    xs = [R.a2a_input(r, "x") for r in range(n)]
    want = torch.cat(xs, dim=1)
    cs = [R.a2a_input(j, "c", tuple(want.shape)) for j in range(n)]
    total = sum(cs[1:], cs[0])
    size = R.A2A_SHAPE[1]
    for r in range(n):
        assert torch.equal(res[r]["ag"]["y"], want)
        assert torch.equal(res[r]["ag"]["grad"],
                           total[:, r * size:(r + 1) * size])
        assert res[r]["counts"]["expert_tokens"] == 1
        assert res[r]["nbytes"]["expert_tokens"] == want.numel() * 4


@pytest.mark.parametrize("layout", sorted(R.LAYOUTS))
@pytest.mark.parametrize("mode", R.MODES)
@pytest.mark.parametrize("n", SIZES)
def test_run_sharded_equals_the_unsharded_linear(ranks, n, mode, layout):
    whole, x, bias, residual, ep = R.lin_inputs(mode)
    want = dispatch.execute(whole, x, R.lin_spec(mode), in_dim=R.LIN_K,
                            epilogue=ep, bias=bias, residual=residual)
    axes, knobs = R.LAYOUTS[layout]
    tags = set()
    for r in range(n):
        y, tag = ranks[n][1][r][(mode, layout)]
        assert y.shape == want.shape
        np.testing.assert_allclose(y.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-5)
        tags.add(tag)
    (tag,) = tags  # every rank planned the same layout
    if layout == "column":
        assert f"model{n}/m=model/k=-" in tag
    else:
        assert f"model{n}/m=-/k=model" in tag
        assert tag.split("/")[4] == knobs.get("shard_collective", "psum")
        chunks = knobs.get("shard_pipeline", 1)
        impl = knobs.get("shard_impl", "xla")
        if chunks > 1 or impl != "xla":
            assert tag.endswith(f"/pc{chunks}.{impl}")


@pytest.mark.parametrize("devices, backend", [
    (["cpu", "cpu"], "gloo"),
    (["cuda:0", "cuda:0"], "gloo"),  # two ranks sharing one card
    (["cuda:0", "cuda"], "gloo"),  # 'cuda' is card 0
    (["cuda:0", "cuda:1"], "cpu:gloo,cuda:nccl"),
    (["cuda:0", "cpu"], "gloo"),
])
def test_backend_by_layout(devices, backend):
    """NCCL carries CUDA tensors only when each rank has a card of its
    own; ranks that share a card, or run on the CPU, stage through gloo."""
    from repro_torch.distributed import collectives as coll

    assert coll.backend_for(devices) == backend


@pytest.mark.parametrize("n", SIZES)
def test_cpu_ranks_stage_through_gloo(ranks, n):
    from repro_torch.distributed import collectives as coll

    assert [r["transport"] for r in ranks[n][0]] == [coll.STAGED] * n
