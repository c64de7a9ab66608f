"""Port parity, core layer: packing, §3.3 scales, QuantSpec, epilogue, the
LUT algorithm and QuantizedLinear — repro_torch against repro on the same
numpy inputs (mirrors tests/test_msgemm_core.py)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_plan_isolation import (  # noqa: E402,F401  (autouse)
    isolated_plan_cache, isolated_plan_cache_module)
# one intra-op thread each: the suite runs in parallel workers
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.core import epilogue as j_ep  # noqa: E402
from repro.core import linear as j_linear  # noqa: E402
from repro.core import lut as j_lut  # noqa: E402
from repro.core import packing as j_pack  # noqa: E402
from repro.core import scales as j_scales  # noqa: E402
from repro.core import spec as j_spec  # noqa: E402
from repro_torch.core import epilogue as t_ep  # noqa: E402
from repro_torch.core import linear as t_linear  # noqa: E402
from repro_torch.core import lut as t_lut  # noqa: E402
from repro_torch.core import packing as t_pack  # noqa: E402
from repro_torch.core import scales as t_scales  # noqa: E402
from repro_torch.core import spec as t_spec  # noqa: E402


def _codes(rng, m, k):
    return rng.integers(0, 16, size=(m, k)).astype(np.uint8)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ------------------------------------------------------------------ packing
def test_b_values_and_b_hat_match():
    np.testing.assert_array_equal(t_pack.b_values().numpy(),
                                  np.asarray(j_pack.b_values()))
    vals = np.arange(-8, 8)
    np.testing.assert_array_equal(t_pack.b_hat(_t(vals)).numpy(),
                                  np.asarray(j_pack.b_hat(vals)))


@pytest.mark.parametrize("k", [4, 7, 16, 33])
def test_storage_roundtrip_and_layout(k):
    c = _codes(np.random.default_rng(k), 5, k)
    packed = t_pack.pack_storage(_t(c))
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(j_pack.pack_storage(c)))
    np.testing.assert_array_equal(t_pack.unpack_storage(packed, k).numpy(), c)


@pytest.mark.parametrize("d", [1, 2, 3, 4])
@pytest.mark.parametrize("k", [6, 12, 13])
def test_index_roundtrip_and_equality(d, k):
    c = _codes(np.random.default_rng(d * 100 + k), 4, k)
    idx = t_pack.pack_indices(_t(c), d)
    assert idx.dtype == torch.int32 and idx.shape == (4, -(-k // d))
    np.testing.assert_array_equal(idx.numpy(),
                                  np.asarray(j_pack.pack_indices(c, d)))
    np.testing.assert_array_equal(t_pack.unpack_indices(idx, d, k).numpy(), c)


@pytest.mark.parametrize("d", [2, 3])
def test_indices_from_storage(d):
    c = _codes(np.random.default_rng(3), 8, 10)
    got = t_pack.indices_from_storage(t_pack.pack_storage(_t(c)), d, 10)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(j_pack.pack_indices(c, d)))


# ------------------------------------------------------------------- scales
@pytest.mark.parametrize("power_of_two", [False, True])
@pytest.mark.parametrize("k,block", [(48, 12), (50, 12), (36, 36)])
def test_quantize_int4_identical(power_of_two, k, block):
    w = np.random.default_rng(5).standard_normal((16, k)).astype(np.float32)
    w[3, :block] = 0.0  # an all-zero block takes scale 1
    got = t_scales.quantize_int4(_t(w), block, power_of_two=power_of_two)
    want = j_scales.quantize_int4(jnp.asarray(w), block,
                                  power_of_two=power_of_two)
    np.testing.assert_array_equal(got.codes.numpy(), np.asarray(want.codes))
    np.testing.assert_array_equal(got.scales.numpy(), np.asarray(want.scales))
    np.testing.assert_array_equal(t_scales.dequantize(got).numpy(),
                                  np.asarray(j_scales.dequantize(want)))


def test_quantize_codebook_identical():
    rng = np.random.default_rng(6)
    w = rng.standard_normal((12, 40)).astype(np.float32)
    cb = np.concatenate([[0.0], np.sort(rng.uniform(-7, 7, 15))]) \
        .astype(np.float32)
    got = t_scales.quantize_codebook(_t(w), _t(cb), 8)
    want = j_scales.quantize_codebook(jnp.asarray(w), cb, 8)
    np.testing.assert_array_equal(got.codes.numpy(), np.asarray(want.codes))
    np.testing.assert_array_equal(got.scales.numpy(), np.asarray(want.scales))
    np.testing.assert_array_equal(t_scales.dequantize(got).numpy(),
                                  np.asarray(j_scales.dequantize(want)))


def test_scale_rules():
    t_scales.check_applicable(6, 3)
    for bad in [(4, 3), (2, 3)]:
        with pytest.raises(ValueError):
            t_scales.check_applicable(*bad)
    with pytest.raises(ValueError):
        t_scales.check_applicable(6, 3, axis="column")


def test_quant_spec_validation_matches():
    for kw in [dict(mode="msgemm"), dict(mode="msgemm", d=2),
               dict(mode="msgemm", d="adaptive"), dict(mode="bf16", d=4)]:
        assert t_spec.QuantSpec(**kw).scale_block == \
            j_spec.QuantSpec(**kw).scale_block
    for kw in [dict(mode="fp8"), dict(d=5), dict(d=0), dict(storage="x"),
               dict(codebook="x"), dict(scale_block=-1),
               dict(mode="msgemm", d=3, scale_block=8)]:
        with pytest.raises(ValueError):
            j_spec.QuantSpec(**kw)
        with pytest.raises(ValueError):
            t_spec.QuantSpec(**kw)
    ad_t = t_spec.QuantSpec(mode="msgemm", d="adaptive")
    ad_j = j_spec.QuantSpec(mode="msgemm", d="adaptive")
    for in_dim, out_dim in [(2048, 256000), (5120, 5120), (24, 4200),
                            (2048, 256)]:
        assert ad_t.resolve_d(in_dim, out_dim) == \
            ad_j.resolve_d(in_dim, out_dim)


# ----------------------------------------------------------------- epilogue
@pytest.mark.parametrize("act", ["none", "relu", "gelu", "silu"])
def test_apply_epilogue_matches(act):
    rng = np.random.default_rng(7)
    y = rng.standard_normal((3, 5, 8)).astype(np.float32) * 3
    bias = rng.standard_normal(8).astype(np.float32)
    res = rng.standard_normal((3, 5, 8)).astype(np.float32)
    kw = dict(act=act, bias=True, residual=True)
    got = t_ep.apply_epilogue(_t(y), t_ep.Epilogue(**kw), _t(bias), _t(res))
    want = j_ep.apply_epilogue(jnp.asarray(y), j_ep.Epilogue(**kw),
                               jnp.asarray(bias), jnp.asarray(res))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    with pytest.raises(ValueError):
        t_ep.Epilogue(act="tanh")


# ---------------------------------------------------------------------- lut
def test_paper_running_example():
    """§3.2: M(0,:) = {2,4,3,5}  =>  y(0) = L(0010,0100,0) + L(0011,0101,1)."""
    x = torch.tensor([1.5, -2.0, 0.25, 3.0])
    codes = t_pack.b_hat(torch.tensor([[2, 4, 3, 5]]))
    table = t_lut.produce(x[:, None], d=2)
    y = table[0b0010_0100, 0, 0] + table[0b0011_0101, 1, 0]
    expected = 2 * 1.5 + 4 * -2.0 + 3 * 0.25 + 5 * 3.0
    assert float(y) == expected
    assert t_lut.msgemm(codes, x, d=2).tolist() == [expected]


@pytest.mark.parametrize("d", [1, 2, 3])
@pytest.mark.parametrize("m,k,b", [(3, 6, 1), (16, 12, 4), (9, 13, 2)])
def test_lut_msgemm_matches_dense_and_reference(d, m, k, b):
    rng = np.random.default_rng(d + m + k)
    codes = _codes(rng, m, k)
    x = rng.standard_normal((k, b)).astype(np.float32)
    sc = (np.abs(rng.standard_normal((m, -(-k // (6 * d))))) + 0.1) \
        .astype(np.float32)
    kw = dict(scales=sc, scale_block=6 * d)
    got = t_lut.msgemm(_t(codes), _t(x), d, scales=_t(sc), scale_block=6 * d)
    dense = t_lut.msgemm_reference(_t(codes), _t(x), d, scales=_t(sc),
                                   scale_block=6 * d)
    want = j_lut.msgemm(codes, jnp.asarray(x), d, **kw)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("chunk", [1, 2, 4])
def test_lut_msgemm_exact_on_integers(chunk):
    rng = np.random.default_rng(7)
    codes = _codes(rng, 32, 24)
    x = rng.integers(-50, 50, size=(24, 3)).astype(np.float32)
    got = t_lut.msgemm(_t(codes), _t(x), d=3, chunk=chunk)
    np.testing.assert_array_equal(
        got.numpy(), t_lut.msgemm_reference(_t(codes), _t(x), 3).numpy())
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(j_lut.msgemm_reference(codes,
                                                       jnp.asarray(x), 3)))


def test_tuple_basis_codebook():
    cb = np.linspace(0, 1.5, 16).astype(np.float32)
    np.testing.assert_array_equal(
        t_lut.tuple_basis(2, codebook=_t(cb)).numpy(),
        np.asarray(j_lut.tuple_basis(2, codebook=cb)))
    np.testing.assert_array_equal(t_lut.tuple_basis(3).numpy(),
                                  np.asarray(j_lut.tuple_basis(3)))


# ------------------------------------------------------------------- linear
@pytest.mark.parametrize("storage", ["packed_idx", "packed_u8"])
@pytest.mark.parametrize("codebook", ["none", "learned"])
def test_from_dense_leaves_identical(storage, codebook):
    w = np.random.default_rng(8).standard_normal((16, 26)).astype(np.float32)
    kw = dict(mode="msgemm", d=3, scale_block=12, storage=storage,
              codebook=codebook)
    got = t_linear.from_dense(_t(w), t_spec.QuantSpec(**kw))
    want = j_linear.from_dense(jnp.asarray(w), j_spec.QuantSpec(**kw))
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]))


@pytest.mark.parametrize("mode", ["bf16", "msgemm"])
@pytest.mark.parametrize("storage", ["packed_idx", "packed_u8"])
def test_linear_apply_matches(mode, storage):
    rng = np.random.default_rng(9)
    w = rng.standard_normal((16, 24)).astype(np.float32) * 24**-0.5
    x = rng.standard_normal((2, 5, 24)).astype(np.float32)
    kw = dict(mode=mode, d=3, scale_block=12, storage=storage)
    tp = t_linear.from_dense(_t(w), t_spec.QuantSpec(**kw))
    jp = j_linear.from_dense(jnp.asarray(w), j_spec.QuantSpec(**kw))
    got = t_linear.apply(t_linear.QLinear(tp), _t(x), t_spec.QuantSpec(**kw),
                         in_dim=24)
    want = j_linear.apply(jp, jnp.asarray(x), j_spec.QuantSpec(**kw),
                          in_dim=24)
    assert got.shape == (2, 5, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


# ----------------------------------------------------------------- dispatch
def test_dispatch_selects_and_rejects():
    from repro_torch import dispatch

    ms_spec = t_spec.QuantSpec(mode="msgemm", d=3, scale_block=12)
    assert dispatch.plan(ms_spec, 16, 24, 4).backend == "msgemm_cuda"
    assert dispatch.plan(t_spec.DENSE, 16, 24, 4).backend == "dense"
    i4_spec = t_spec.QuantSpec(mode="int4_dequant")
    assert dispatch.plan(i4_spec, 16, 24, 4).backend == "int4_cuda"
    # int4 with a learned codebook goes to the dequantize-then-matmul
    # backend (the int4 kernel takes the uniform grid only)
    assert dispatch.plan(t_spec.QuantSpec(mode="int4_dequant",
                                          codebook="learned"),
                         16, 24, 4).backend == "int4_torch"
    w = torch.randn(16, 24, generator=torch.Generator().manual_seed(0))
    p = t_linear.from_dense(w, ms_spec)
    x = torch.randn(2, 24)
    with pytest.raises(ValueError, match="bias"):
        dispatch.execute(p, x, ms_spec, bias=torch.zeros(16))
    with pytest.raises(ValueError, match="residual"):
        dispatch.execute(p, x, ms_spec, residual=torch.zeros(2, 16))
    with pytest.raises(ValueError, match="cannot execute"):
        dispatch.execute(p, x, ms_spec,
                         plan_override=dispatch.ExecPlan("dense"))
    # fused (msgemm_cuda) and unfused (dense) epilogues agree
    ep = t_ep.Epilogue(act="silu", bias=True, residual=True)
    b, r = torch.randn(16), torch.randn(2, 16)
    fused = dispatch.execute(p, x, ms_spec, epilogue=ep, bias=b, residual=r)
    plain = dispatch.execute(p, x, ms_spec)
    torch.testing.assert_close(fused, t_ep.apply_epilogue(plain, ep, b, r),
                               rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------- small parts
def test_serving_config_check_int4_and_activation_match():
    """linear.serving_config, packing.check_int4 and common.activation
    against the reference's on the same inputs."""
    from repro.models import common as j_common
    from repro_torch.models import common as t_common

    for mode in ("msgemm", "int4_dequant", "bf16"):
        spec = dict(d=3, scale_block=36, storage="packed_u8")
        got = t_linear.serving_config(t_spec.QuantSpec(**spec), mode)
        want = j_linear.serving_config(j_spec.QuantSpec(**spec), mode)
        assert isinstance(got, t_spec.QuantSpec)
        assert (got.mode, got.d, got.scale_block, got.storage,
                got.codebook) == (want.mode, want.d, want.scale_block,
                                  want.storage, want.codebook)
    for values in ([], [0], [-8, 7], [[3, -2], [7, -8]], [8], [-9, 0],
                   np.array([1, 2, 100])):
        outcomes = []
        for check in (t_pack.check_int4, j_pack.check_int4):
            try:
                check(values)
                outcomes.append("ok")
            except ValueError:
                outcomes.append("ValueError")
        assert outcomes[0] == outcomes[1], values
    x = np.linspace(-6, 6, 97).astype(np.float32)
    for name in ("gelu", "silu", "relu"):
        np.testing.assert_allclose(
            t_common.activation(name)(_t(x)).numpy(),
            np.asarray(j_common.activation(name)(jnp.asarray(x))),
            rtol=1e-6, atol=1e-6)
    for mod in (t_common, j_common):
        with pytest.raises(KeyError):
            mod.activation("tanh")


def test_registry_unregister_and_device_kind():
    """dispatch.unregister_backend and registry.device_kind as in the
    reference: a registered backend outranks the built-ins until it is
    dropped, and auto-selection without a device keys on device_kind
    ('cpu' here, as the reference's on the CPU)."""
    from repro import dispatch as j_dispatch
    from repro_torch import dispatch as t_dispatch

    assert t_dispatch.device_kind() == t_dispatch.registry.device_kind() \
        == j_dispatch.registry.device_kind() == "cpu"
    ms = t_spec.QuantSpec(mode="msgemm", d=3, scale_block=36)
    default = t_dispatch.select_backend(ms, 3).name
    assert default == t_dispatch.select_backend(ms, 3, "cpu").name
    try:
        t_dispatch.register_backend(
            "msgemm_custom", modes=("msgemm",), priority=999,
            run=lambda spec, plan, params, x, *, k: x)
        assert t_dispatch.select_backend(ms, 3).name == "msgemm_custom"
        assert t_dispatch.plan(ms, 16, 36, 2, device_type="cpu").backend \
            == "msgemm_custom"
    finally:
        t_dispatch.unregister_backend("msgemm_custom")
    assert "msgemm_custom" not in t_dispatch.backend_names()
    assert t_dispatch.select_backend(ms, 3).name == default
    assert t_dispatch.plan(ms, 16, 36, 2, device_type="cpu").backend \
        == default
    t_dispatch.unregister_backend("no_such_backend")  # a no-op
