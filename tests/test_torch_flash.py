"""Port parity, flash attention: the port's ``kernels.ops.flash_attention``
(on CPU tensors, the kernel's plain version) against the JAX package's
``repro.kernels.ops.flash_attention`` (its Pallas kernel in interpret
mode) and ``repro.kernels.ref.flash_attention_ref``, on the same numpy
inputs; the port's own oracles in ``repro_torch.kernels.ref`` against
their JAX twins.  The CUDA kernel is held against the plain version in
tests/test_torch_cuda.py.

Tolerances: rtol = atol = 2e-5 for attention, the reference's own
(tests/test_kernels.py): the port's tiles (64 x 64) rescale the online
softmax at other keys than the TPU tiles, and sums run in another order.
bf16 and f16 inputs take the kernel's tensor-core op order, held against
the f32 route within one ulp of the output type (rtol 2^-7, 2^-10).
3e-5 against the model's ``_sdpa``, as the reference allows its kernel.
The GeMM oracles: bit-identical on exact inputs (integers, power-of-two
scales), rtol = atol = 1e-5 on random floats.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_plan_isolation import (  # noqa: E402,F401  (autouse)
    isolated_plan_cache, isolated_plan_cache_module)
# one intra-op thread each: the suite runs in parallel workers
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.core import packing as j_packing  # noqa: E402
from repro.core.epilogue import Epilogue as JEpilogue  # noqa: E402
from repro.kernels import ops as j_ops  # noqa: E402
from repro.kernels import ref as j_ref  # noqa: E402
from repro.kernels.flash_attention import flash_attention_pallas  # noqa: E402
from repro_torch.core import packing  # noqa: E402
from repro_torch.core.epilogue import Epilogue  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-5)


def _qkv(seed, B, Sq, Skv, H, Hk, dh):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((B, Sq, H, dh), (B, Skv, Hk, dh),
                           (B, Skv, Hk, dh)))


def _both(q, k, v, **kw):
    """(port, JAX) ops.flash_attention on the same numpy inputs."""
    got = ops.flash_attention(*map(torch.from_numpy, (q, k, v)), **kw)
    want = j_ops.flash_attention(*map(jnp.asarray, (q, k, v)), **kw)
    return got.numpy(), np.asarray(want)


def _oracle(q, k, v, **kw):
    """JAX's ref.flash_attention_ref in the public (B, S, H, dh) layout."""
    B, Sq, H, dh = q.shape
    g = H // k.shape[2]
    flat = lambda t: np.moveaxis(np.repeat(t, H // t.shape[2], axis=2), 2, 1) \
        .reshape(B * H, t.shape[1], dh)  # noqa: E731
    assert g >= 1
    out = j_ref.flash_attention_ref(*(jnp.asarray(flat(t)) for t in (q, k, v)),
                                    **kw)
    return np.moveaxis(np.asarray(out).reshape(B, H, Sq, dh), 1, 2)


# the reference's own grid (tests/test_kernels.py)
@pytest.mark.parametrize("Sq,Skv,H,Hk,dh", [(32, 32, 4, 4, 16),
                                            (48, 48, 4, 2, 16),
                                            (40, 40, 2, 1, 8)])
@pytest.mark.parametrize("kwargs", [dict(causal=True),
                                    dict(causal=True, window=16),
                                    dict(causal=True, softcap=30.0)],
                         ids=["causal", "window", "softcap"])
def test_flash_matches_jax_and_ref(Sq, Skv, H, Hk, dh, kwargs):
    q, k, v = _qkv(Sq + H, 2, Sq, Skv, H, Hk, dh)
    got, want = _both(q, k, v, **kwargs)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, _oracle(q, k, v, **kwargs), **TOL)


@pytest.mark.parametrize("Sq,Skv,H,Hk,dh,kwargs", [
    (24, 40, 4, 2, 16, dict(causal=True)),                # Sq < Skv
    (40, 24, 4, 2, 16, dict(causal=True, window=8)),      # Sq > Skv
    (61, 19, 4, 1, 8, dict(causal=True, softcap=5.0)),    # zero-pad keys
    (37, 37, 6, 3, 12, dict(causal=True, window=10)),     # ragged
    (133, 133, 2, 1, 8, dict(causal=True, window=70)),    # past one tile
    (130, 70, 2, 2, 8, dict(causal=True, window=64, softcap=20.0)),
    (40, 40, 4, 2, 16, dict(causal=False)),
    (24, 128, 2, 1, 8, dict(causal=False, window=20)),
], ids=["sq<skv", "sq>skv", "pad-keys", "ragged", "two-tiles",
        "sq>skv-ragged", "noncausal", "noncausal-window"])
def test_flash_lengths_match_jax(Sq, Skv, H, Hk, dh, kwargs):
    """Ragged and unequal lengths: the port pads Sq and Skv to the
    reference's lengths, so queries past the last key see the same zero
    keys, and masks its own tiles' ragged edge."""
    q, k, v = _qkv(Sq * 7 + Skv, 1, Sq, Skv, H, Hk, dh)
    got, want = _both(q, k, v, **kwargs)
    np.testing.assert_allclose(got, want, **TOL)
    if Sq <= Skv:  # no zero-pad key is visible: the unpadded oracle holds
        np.testing.assert_allclose(got, _oracle(q, k, v, **kwargs), **TOL)


def test_flash_rows_that_see_no_key():
    """A query past the last key by more than the window sees no key.  The
    reference then averages the values of the keys its TPU tiles visited
    (every logit is -1e30); the port averages those its own tiles visit.
    Every other row agrees."""
    q, k, v = _qkv(5, 1, 100, 10, 2, 1, 8)
    got, want = _both(q, k, v, causal=True, window=16)
    # tile 16 pads the keys to 16: rows from 16 + 16 - 1 on see none
    np.testing.assert_allclose(got[:, :31], want[:, :31], **TOL)
    assert np.isfinite(got).all()


@pytest.mark.parametrize("Skv", [32, 40, 30, 130, 256])
def test_noncausal_refused_where_reference_refuses(Skv):
    q, k, v = _qkv(Skv, 1, 16, Skv, 2, 1, 8)
    try:
        want = np.asarray(j_ops.flash_attention(
            *map(jnp.asarray, (q, k, v)), causal=False))
    except AssertionError:
        with pytest.raises(ValueError, match="non-causal"):
            ops.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                causal=False)
        assert Skv in (30, 130)
        return
    got = ops.flash_attention(*map(torch.from_numpy, (q, k, v)), causal=False)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert Skv in (32, 40, 256)


def test_flash_gqa_native_layout():
    """k/v in their native (B, Hk, Skv, dh) layout, no repeat, for every
    group size including MQA; at the TPU test's tiles (16) and the
    kernel's (64)."""
    B, S, dh = 2, 32, 16
    for H, Hk in [(4, 4), (4, 2), (4, 1), (6, 3)]:
        rng = np.random.default_rng(H * 10 + Hk)
        q = rng.standard_normal((B, H, S, dh)).astype(np.float32)
        k = rng.standard_normal((B, Hk, S, dh)).astype(np.float32)
        v = rng.standard_normal((B, Hk, S, dh)).astype(np.float32)
        want = np.asarray(flash_attention_pallas(
            *map(jnp.asarray, (q, k, v)), causal=True, tq=16, tk=16,
            interpret=True))
        rep = lambda t: np.repeat(t, H // Hk, axis=1).reshape(  # noqa: E731
            B * H, S, dh)
        oracle = np.asarray(j_ref.flash_attention_ref(
            jnp.asarray(q.reshape(B * H, S, dh)), jnp.asarray(rep(k)),
            jnp.asarray(rep(v)), causal=True)).reshape(B, H, S, dh)
        for tiles in ((16, 16), tuple(fa.flash_tiles(dh))):
            got = fa.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                     causal=True, tq=tiles[0], tk=tiles[1])
            np.testing.assert_allclose(got.numpy(), want, **TOL)
            np.testing.assert_allclose(got.numpy(), oracle, **TOL)


def test_flash_matches_model_sdpa():
    """The op agrees with the port's model attention (``layers._sdpa``)."""
    from repro_torch.models import layers
    from repro_torch.models.config import ModelConfig

    cfg = ModelConfig(num_layers=1, d_model=32, num_heads=4, num_kv_heads=2,
                      d_ff=64, vocab_size=97)
    B, S, dh = 2, 24, cfg.head_dim
    q, k, v = map(torch.from_numpy, _qkv(0, B, S, S, 4, 2, dh))
    want = layers._sdpa(cfg, q, k, v, layers.causal_mask(S, S))
    got = ops.flash_attention(q, k, v, causal=True).reshape(B, S, -1)
    torch.testing.assert_close(got, want, rtol=3e-5, atol=3e-5)


@pytest.mark.parametrize("Sq,Skv,window,softcap", [
    (200, 200, 70, 0.0), (150, 260, 64, 50.0), (256, 256, 1, 0.0),
    (300, 300, 130, 10.0)])
def test_window_skip_changes_no_bit(Sq, Skv, window, softcap):
    """Skipping the key tiles below a query tile's window leaves every bit
    of the plain version as visiting them would (each row sees a key)."""
    q, k, v = (torch.from_numpy(t).transpose(1, 2).contiguous()
               for t in _qkv(Sq + window, 1, Sq, Skv, 4, 2, 256))
    for tq, tk in ((64, 64), (16, 32)):
        kw = dict(causal=True, window=window, softcap=softcap, tq=tq, tk=tk)
        skip = fa.flash_attention_plain(q, k, v, **kw)
        full = fa.flash_attention_plain(q, k, v, skip_below_window=False,
                                        **kw)
        assert torch.equal(skip, full)
    lo, hi = fa.key_tiles(-(-Sq // 64), -(-Skv // 64), tq=64, tk=64,
                          causal=True, window=window)
    assert sum(lo) > 0  # some tiles were really skipped


def test_flash_bf16_in_bf16_out():
    q, k, v = (torch.from_numpy(t).to(torch.bfloat16)
               for t in _qkv(3, 1, 40, 40, 4, 2, 16))
    got = ops.flash_attention(q, k, v, causal=True, window=12, softcap=30.0)
    assert got.dtype == torch.bfloat16
    want = ops.flash_attention(q.float(), k.float(), v.float(), causal=True,
                               window=12, softcap=30.0)
    torch.testing.assert_close(got.float(), want, rtol=2**-7, atol=1e-5)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("S,dh,kw", [
    (70, 128, dict(causal=True, window=30, softcap=20.0)),
    (150, 128, dict(causal=True)),
    (40, 256, dict(causal=True, softcap=50.0)),
    (140, 256, dict(causal=True, window=100)),
], ids=["dh128-window-softcap", "dh128-two-tiles", "dh256-softcap",
        "dh256-window"])
def test_flash_tensor_core_route_matches_f32_route(S, dh, kw, dtype):
    """The tensor-core route's op order (the scale after the dot, a
    scale that is not a power of two at dh = 128; p split into hi and
    lo halves for p·v) within one ulp of the output type of the f32
    route on the same values, through the op's public layout."""
    dt = getattr(torch, dtype)
    ulp = 2**-7 if dt == torch.bfloat16 else 2**-10
    q, k, v = (torch.from_numpy(t).to(dt)
               for t in _qkv(S + dh, 1, S, S, 4, 2, dh))
    assert fa.tensor_core_dtype(*(t.transpose(1, 2) for t in (q, k, v))) \
        == dt
    got = ops.flash_attention(q, k, v, **kw)
    assert got.dtype == dt
    want = ops.flash_attention(q.float(), k.float(), v.float(), **kw)
    torch.testing.assert_close(got.float(), want, rtol=ulp, atol=1e-5)


def test_flash_routes_and_tiles():
    """bf16 or f16 q, k and v all of one type take the tensor-core route
    and its tiles per head-dim class; f32 or mixed types the FMA route's
    64 x 64, unchanged; every class has a compiled variant of both
    types."""
    bf, f32 = torch.bfloat16, torch.float32
    t = {d: torch.zeros(1, dtype=d) for d in (bf, f32)}
    assert fa.tensor_core_dtype(t[bf], t[bf], t[bf]) == bf
    assert fa.tensor_core_dtype(t[bf], t[f32], t[bf]) is None
    assert fa.tensor_core_dtype(t[f32], t[f32], t[f32]) is None
    assert tuple(fa.flash_tiles(256)) == (64, 64, 1)
    assert [fa.dh_class(d) for d in (8, 16, 17, 64, 65, 200, 256)] == \
        [16, 16, 32, 64, 128, 256, 256]
    for dc in (16, 32, 64, 128, 256):
        tiles = fa.flash_tiles(dc, bf)
        for dt in fa.TENSOR_CORE_TYPES:
            assert (dt, dc, *tiles) in fa.MMA_VARIANTS
    # the plain version takes the route's tiles by default
    q, k, v = (torch.from_numpy(x).transpose(1, 2).contiguous().to(bf)
               for x in _qkv(9, 1, 200, 200, 2, 1, 64))
    tq, tk, _ = fa.flash_tiles(64, bf)
    assert torch.equal(fa.flash_attention_plain(q, k, v),
                       fa.flash_attention_plain(q, k, v, tq=tq, tk=tk))


def test_wrapper_routes_by_device_without_fallback():
    q, k, v = (torch.from_numpy(t).transpose(1, 2).contiguous()
               for t in _qkv(1, 1, 16, 16, 2, 1, 8))
    before = fa.launches
    fa.flash_attention(q, k, v)  # CPU: the plain version, no launch
    assert fa.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_cuda(q, k, v)
    with pytest.raises(ValueError, match="unsupported device"):
        fa.flash_attention(*(t.to("meta") for t in (q, k, v)))
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_tiles(512)


# ------------------------------------------------- the port's oracles
def _gemm_inputs(seed, m, k, b, sb, exact):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 16, size=(m, k)).astype(np.uint8)
    if exact:
        x = rng.integers(-4, 5, size=(k, b)).astype(np.float32)
        sc = 2.0 ** rng.integers(-2, 3, size=(m, -(-k // sb)))
    else:
        x = rng.standard_normal((k, b)).astype(np.float32)
        sc = np.abs(rng.standard_normal((m, -(-k // sb)))) + 0.1
    return codes, x, sc.astype(np.float32)


def _close(got, want, exact):
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "float"])
@pytest.mark.parametrize("d,sb,m,k,b", [(3, 12, 20, 50, 3), (2, 8, 9, 33, 1),
                                        (1, 4, 5, 17, 2)])
def test_msgemm_ref_matches_jax(d, sb, m, k, b, exact):
    codes, x, sc = _gemm_inputs(d * 100 + m, m, k, b, sb, exact)
    idx = packing.pack_indices(torch.from_numpy(codes), d)
    got = ref.msgemm_ref(idx, torch.from_numpy(x), torch.from_numpy(sc), d=d,
                         scale_block=sb)
    want = j_ref.msgemm_ref(j_packing.pack_indices(jnp.asarray(codes), d),
                            jnp.asarray(x), jnp.asarray(sc), d=d,
                            scale_block=sb)
    _close(got.numpy(), np.asarray(want), exact)


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "float"])
@pytest.mark.parametrize("ep", [dict(), dict(act="gelu", bias=True),
                                dict(act="relu", residual=True,
                                     out_dtype="bfloat16")],
                         ids=["none", "gelu-bias", "relu-res-bf16"])
def test_msgemm_tiled_ref_matches_jax(ep, exact):
    d, sb, m, k, b = 3, 12, 20, 70, 5
    codes, x, sc = _gemm_inputs(7, m, k, b, sb, exact)
    rng = np.random.default_rng(8)
    bias = rng.integers(-3, 4, size=(m,)).astype(np.float32)
    res = rng.integers(-3, 4, size=(m, b)).astype(np.float32)
    tiles = dict(tm=8, tj=8, tb=2)
    kw = lambda mod: dict(  # noqa: E731
        bias=mod(bias) if ep.get("bias") else None,
        residual=mod(res) if ep.get("residual") else None)
    got = ref.msgemm_tiled_ref(
        torch.from_numpy(codes), torch.from_numpy(x), torch.from_numpy(sc),
        d=d, scale_block=sb, epilogue=Epilogue(**ep), **tiles,
        **kw(torch.from_numpy))
    want = j_ref.msgemm_tiled_ref(
        jnp.asarray(codes), jnp.asarray(x), jnp.asarray(sc), d=d,
        scale_block=sb, epilogue=JEpilogue(**ep), **tiles,
        **kw(jnp.asarray))
    want = np.asarray(want.astype(jnp.float32))
    if ep.get("act") == "gelu":  # tanh differs in the last ulps
        np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-5,
                                   atol=1e-5)
    else:
        _close(got.float().numpy(), want, exact)


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "float"])
@pytest.mark.parametrize("sb,m,k,b", [(36, 12, 90, 4), (8, 7, 33, 1)])
def test_int4_matmul_ref_matches_jax(sb, m, k, b, exact):
    codes, x, sc = _gemm_inputs(m + k, m, k, b, sb, exact)
    got = ref.int4_matmul_ref(packing.pack_storage(torch.from_numpy(codes)),
                              torch.from_numpy(sc), torch.from_numpy(x),
                              scale_block=sb)
    want = j_ref.int4_matmul_ref(j_packing.pack_storage(jnp.asarray(codes)),
                                 jnp.asarray(sc), jnp.asarray(x),
                                 scale_block=sb)
    _close(got.numpy(), np.asarray(want), exact)


@pytest.mark.parametrize("kw", [dict(causal=True), dict(causal=False),
                                dict(causal=True, window=5, softcap=7.0)],
                         ids=["causal", "full", "window-softcap"])
def test_flash_attention_ref_matches_jax(kw):
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((3, S, 8)).astype(np.float32)
               for S in (20, 26, 26))
    got = ref.flash_attention_ref(*map(torch.from_numpy, (q, k, v)), **kw)
    want = j_ref.flash_attention_ref(*map(jnp.asarray, (q, k, v)), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
