"""Port parity, the MoE block: ``repro_torch.models.moe.moe_apply`` against
``repro.models.moe.moe_apply`` on the reference's weights (through
``convert``) and numpy inputs, dense and in msgemm mode (whose experts run
int4 in both packages), with the reference's capacity and one small
enough to drop; the routing (keep mask, destinations) against the
reference's algorithm on its own logits; the expert axis of the int4
GeMM's plain version against a per-expert loop of the one-linear plain
version; and the expert stack through ``dispatch.execute`` with a plan
key that carries the expert count.

Tolerances: outputs within 1e-5 (f32; the int4 experts sum in the
kernel's lane order against the reference's dequantize-then-matmul, the
shared MLP's msGeMM likewise); routing, keep masks and dropped_frac
exactly equal; the plain expert axis bit for bit.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_plan_isolation import (  # noqa: E402,F401  (autouse)
    isolated_plan_cache, isolated_plan_cache_module)
# one intra-op thread each: the suite runs in parallel workers
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as j_configs  # noqa: E402
from repro.core.spec import QuantSpec as JSpec  # noqa: E402
from repro.models import moe as j_moe  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.quant import quantize_model as j_quantize  # noqa: E402
from repro_torch import convert, dispatch  # noqa: E402
from repro_torch.core import packing  # noqa: E402
from repro_torch.core.linear import QLinear  # noqa: E402
from repro_torch.core.spec import QuantSpec, expert_spec  # noqa: E402
from repro_torch.device import generator  # noqa: E402
from repro_torch.kernels import int4_matmul as i4  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.quant import quantize_model  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
MSGEMM = dict(mode="msgemm", d=3, scale_block=36)
# (arch, the layer holding the first MoE block)
ARCHS = [("qwen2_moe", 0), ("llama4_maverick", 1)]


def _pair(arch, quant):
    """The reference's SMOKE params (msgemm-quantized when asked) and the
    port's model converted from them, with both configs."""
    jcfg = j_configs.get_smoke(arch)
    jp = JT.init_params(jax.random.PRNGKey(3), jcfg)
    if quant:
        spec = JSpec(**MSGEMM)
        jp = j_quantize(jp, jcfg, spec)
        jcfg = jcfg.replace(quant=spec)
    tcfg = convert.config_from_jax(jcfg)
    model = convert.params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                                    device="cpu")
    return jp, jcfg, model, tcfg


@pytest.fixture(scope="module", params=[
    (a, q) for a, _ in ARCHS for q in (False, True)],
    ids=lambda p: f"{p[0]}-{'msgemm' if p[1] else 'dense'}")
def pair(request):
    arch, quant = request.param
    return (arch, *_pair(arch, quant))


def _moe_params(jp, jcfg, layer):
    """Layer ``layer``'s reference MoE params (its scan group's slice)."""
    g, i = divmod(layer, len(jcfg.block_pattern))
    blk = jp["blocks"][f"{i}:{jcfg.block_pattern[i]}"]
    return jax.tree.map(lambda a: a[g], blk["moe"])


def _x(cfg, B=2, S=9, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)


def _ref_keep(jlogits, jcfg, C):
    """The reference's keep mask (moe.py's top-k, one-hot cumsum and
    capacity test), on its own router logits."""
    B, S, E = jlogits.shape
    K = jcfg.num_experts_per_tok
    _, eidx = jax.lax.top_k(jlogits, K)
    oh = jax.nn.one_hot(eidx.reshape(B, S * K), E, dtype=jnp.int32)
    pos = jnp.sum((jnp.cumsum(oh, axis=1) - 1) * oh, axis=-1)
    return np.asarray(pos < C), np.asarray(eidx)


@pytest.mark.parametrize("capacity", [None, 1], ids=["default", "drops"])
def test_moe_apply_matches_reference(pair, capacity):
    arch, jp, jcfg, model, tcfg = pair
    layer = dict(ARCHS)[arch]
    x = _x(tcfg)
    want, jaux = j_moe.moe_apply(_moe_params(jp, jcfg, layer),
                                 jnp.asarray(x), jcfg, capacity=capacity)
    p = model.blocks[layer].moe
    got, aux = moe.moe_apply(p, torch.from_numpy(x), tcfg,
                             capacity=capacity)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux["load_balance"]),
                               float(jaux["load_balance"]), **TOL)
    assert float(aux["dropped_frac"]) == float(jaux["dropped_frac"])
    # the routing itself: the same experts, keep mask and capacity
    r = moe.route(p, torch.from_numpy(x), tcfg, capacity=capacity)
    jlogits = jnp.einsum("bsd,ed->bse", jnp.asarray(x),
                         _moe_params(jp, jcfg, layer)["router"]["w"])
    keep, eidx = _ref_keep(jlogits, jcfg, r["capacity"])
    np.testing.assert_array_equal(r["eidx"].numpy(), eidx)
    np.testing.assert_array_equal(r["keep"].numpy(), keep)
    if capacity == 1:
        assert float(aux["dropped_frac"]) > 0.0  # the case drops


def test_route_counts_add_up_the_dropped_slots():
    _, _, model, tcfg = _pair("qwen2_moe", False)
    p = model.blocks[0].moe
    moe.reset_route_counts(model)
    assert moe.dropped_frac(model) is None
    x = torch.from_numpy(_x(tcfg))
    fracs = [float(moe.moe_apply(p, x, tcfg, capacity=c)[1]["dropped_frac"])
             for c in (1, None)]
    assert moe.dropped_frac(model) == pytest.approx(sum(fracs) / 2)
    moe.reset_route_counts(model)
    assert int(p.route_counts.sum()) == 0


def _stack(rng, E, m, k, sb):
    codes = rng.integers(0, 16, size=(E, m, k)).astype(np.uint8)
    u8 = packing.pack_storage(torch.from_numpy(codes)).contiguous()
    sc = torch.from_numpy(((np.abs(rng.standard_normal(
        (E, m, -(-k // sb)))) + 0.1) * k**-0.5).astype(np.float32))
    return u8, sc


# (E, m, k, b, sb): qwen2-moe's ragged last scale block (k = 1408 = 39
# blocks of 36 + 4, not a whole number of 256-code steps) at a narrow m,
# a split contraction, b past one column tile, odd k
EXPERT_SHAPES = [(3, 40, 1408, 4, 36), (4, 24, 600, 9, 36),
                 (2, 17, 301, 1, 12)]


@pytest.mark.parametrize("act", ["none", "silu"])
@pytest.mark.parametrize("E,m,k,b,sb", EXPERT_SHAPES)
def test_expert_axis_plain_is_the_per_expert_loop(E, m, k, b, sb, act):
    rng = np.random.default_rng(E + m + k + b)
    u8, sc = _stack(rng, E, m, k, sb)
    x = torch.from_numpy(rng.standard_normal((E, b, k)).astype(
        np.float32)).transpose(1, 2)  # (E, k, b), the dispatch's layout
    tiles = ops.int4_tiles(m, k, b, E)
    for t in {tiles, tiles._replace(nsplit=2)}:
        got = i4.int4_matmul(u8, sc, x, scale_block=sb, tiles=t, act=act)
        want = torch.stack([i4.int4_matmul_plain(
            u8[e], sc[e], x[e], scale_block=sb, tiles=t, act=act)
            for e in range(E)])
        assert got.shape == (E, m, b)
        assert torch.equal(got, want)


def test_expert_tiles_count_every_experts_blocks():
    # one expert of qwen2-moe's up at decode: few blocks, so the
    # contraction splits; sixty of them fill the card unsplit
    assert ops.int4_tiles(1408, 2048, 16, 1).nsplit > 1
    assert ops.int4_tiles(1408, 2048, 16, 60).nsplit == 1
    t = ops.int4_tiles(1408, 2048, 16, 60)
    assert ops.int4_span(1408, 2048, 16, t, 60) > ops.int4_span(
        1408, 2048, 16, t, 1)
    assert t in ops.int4_variants(1408, 2048, 16, 60)


@pytest.mark.parametrize("backend", ["int4_cuda", "int4_torch",
                                     "dense_fallback"])
def test_expert_stack_through_dispatch(backend):
    """Every int4 backend runs a stack to what a per-expert loop of the
    same backend gives; the plan key carries E; msgemm stacks raise."""
    rng = np.random.default_rng(7)
    E, m, k = 3, 24, 100
    w = torch.from_numpy((rng.standard_normal((E, m, k)) * k**-0.5)
                         .astype(np.float32))
    spec = expert_spec(QuantSpec(**MSGEMM))
    assert (spec.mode, spec.storage) == ("int4_dequant", "packed_u8")
    holder = torch.nn.Module()
    holder.up = QLinear({"w": w})
    quantize_model(holder, QuantSpec(**MSGEMM))
    params = holder.up.params()
    assert params["u8"].shape == (E, m, 50)
    x = torch.from_numpy(rng.standard_normal((E, 5, k)).astype(np.float32))
    policy = dispatch.ExecPolicy(backend=backend)
    with dispatch.collecting() as reqs:
        dispatch.execute(params, x, spec, policy=policy)
    assert reqs[0].experts == E and reqs[0].batch == 5
    key = dispatch.plan_key(backend, spec, 3, m, k, 5, "cpu",
                            experts=E)
    assert key.endswith(f"|sh-|e{E}")
    got = dispatch.execute(params, x, spec, policy=policy)
    want = torch.stack([dispatch.execute(
        {n: t[e] for n, t in params.items()}, x[e], spec, policy=policy)
        for e in range(E)])
    if backend == "int4_cuda":  # one expert's split may differ from E's
        torch.testing.assert_close(got, want, **TOL)
    else:
        assert torch.equal(got, want)
    with pytest.raises(ValueError, match="msgemm"):
        dispatch.execute(params, x, QuantSpec(**MSGEMM), in_dim=k)


def test_moe_init_quantizes_one_expert_at_a_time():
    """init_params(quant=...) stores the experts as int4 codes two a byte
    (expert_spec) whatever the mode, the shared MLP and attention as the
    spec says, the router dense."""
    cfg = convert.config_from_jax(j_configs.get_smoke("qwen2_moe"))
    spec = QuantSpec(**MSGEMM)
    model = TT.init_params(cfg, generator=generator(0, "cpu"),
                           device="cpu", quant=spec)
    p = model.blocks[0].moe
    assert set(p.experts.up.params()) == {"u8", "scales"}
    assert p.experts.up.params()["u8"].shape == (
        cfg.num_experts, cfg.moe_d_ff, cfg.d_model // 2)
    assert set(p.shared.up.params()) == {"idx", "scales"}
    assert set(p.router.params()) == {"w"}
    logits = TT.forward(model, cfg.replace(quant=spec),
                        torch.zeros((1, 3), dtype=torch.int32))
    assert torch.isfinite(logits).all()
