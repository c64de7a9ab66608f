"""Port parity, int4 weights: the int4 GeMM kernel's plain PyTorch version
(what the wrapper runs on CPU tensors) against the JAX package's Pallas
kernel in interpret mode (``repro.kernels.ops.int4_matmul``, fused grid
with each epilogue and legacy grid with the identity) and its oracle
(``repro.kernels.ref.int4_matmul_ref``); then a gemma model and the
continuous engine in ``int4_dequant`` mode against the JAX model and
engine on the same weights.  The CUDA kernel itself is held against the
plain version in tests/test_torch_cuda.py.

Tolerances: on exactly representable inputs (integer activations,
power-of-two scales) every sum is exact, so results are bit-identical
whatever the op order; on random floats the plain version sums per lane
in the kernel's interleave and scales once per segment (a lane's codes
inside one scale block) while the Pallas kernel scales each weight and
dots whole k tiles, so they agree within rtol = atol = 1e-5.  Logits: rtol = atol = 1e-4, as
tests/test_torch_model.py allows (the JAX model runs ``int4_jnp``, a
dequantize-then-matmul in XLA's order).
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

from repro.core import linear as j_linear  # noqa: E402
from repro.core import packing as j_packing  # noqa: E402
from repro.core.epilogue import Epilogue as JEpilogue  # noqa: E402
from repro.core.spec import QuantSpec as JSpec  # noqa: E402
from repro.kernels import ops as j_ops  # noqa: E402
from repro.kernels import ref as j_ref  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.config import ModelConfig as JConfig  # noqa: E402
from repro.quant import quantize_model as j_quantize  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro_torch import convert, dispatch  # noqa: E402
from repro_torch.core import linear as t_linear  # noqa: E402
from repro_torch.core.epilogue import Epilogue  # noqa: E402
from repro_torch.core.spec import QuantSpec  # noqa: E402
from repro_torch.device import generator  # noqa: E402
from repro_torch.kernels import int4_matmul as i4  # noqa: E402
from repro_torch.kernels import msgemm as ms  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.runtime import serve as TSV  # noqa: E402
from repro_torch.serving import Engine, Request  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
QSPEC = dict(mode="int4_dequant", d=3, scale_block=36)


def _mk(rng, m, k, b, sb, exact):
    """Packed codes (m, ceil(k/2)), x (k, b), scales (m, ceil(k/sb)).
    Random scales carry the initializer's k**-0.5, as a model's weights
    do, so outputs are O(1) and 1e-5 measures the sum order, not the
    size of partial sums that grow with k."""
    codes = rng.integers(0, 16, size=(m, k)).astype(np.uint8)
    u8 = np.array(j_packing.pack_storage(jnp.asarray(codes)))
    nsb = -(-k // sb)
    if exact:
        x = rng.integers(-4, 5, size=(k, b))
        sc = 2.0 ** rng.integers(-2, 3, size=(m, nsb))
    else:
        x = rng.standard_normal((k, b))
        sc = (np.abs(rng.standard_normal((m, nsb))) + 0.1) * k**-0.5
    return u8, x.astype(np.float32), sc.astype(np.float32)


def _f32(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else a,
                      np.float32)


# (scale_block, m, k, b): k a multiple of neither the block nor 256, a
# last scale block shorter than the rest, b = 1 decode, b > 8 (two column
# blocks), k past one 256-code step and past one x tile
SHAPES = [
    (36, 24, 90, 4),
    (8, 16, 64, 1),
    (12, 7, 130, 3),
    (36, 40, 300, 9),
    (32, 9, 1100, 2),
]


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "float"])
@pytest.mark.parametrize("sb,m,k,b", SHAPES)
def test_plain_vs_pallas_fused_legacy_and_ref(sb, m, k, b, exact):
    rng = np.random.default_rng(sb + m + k + b + exact)
    u8, x, sc = _mk(rng, m, k, b, sb, exact)
    got = _f32(ops.int4_matmul(torch.from_numpy(u8), torch.from_numpy(sc),
                               torch.from_numpy(x), scale_block=sb))
    ja = (jnp.asarray(u8), jnp.asarray(sc), jnp.asarray(x))
    fused = j_ops.int4_matmul(*ja, scale_block=sb)
    legacy = j_ops.int4_matmul(*ja, scale_block=sb, acc_in_vmem=False)
    ref = j_ref.int4_matmul_ref(*ja, scale_block=sb)
    for want in (fused, legacy, ref):
        if exact:
            np.testing.assert_array_equal(got, _f32(want))
        else:
            np.testing.assert_allclose(got, _f32(want), **TOL)


EPILOGUES = [
    dict(act="relu"),
    dict(act="gelu"),
    dict(act="silu"),
    dict(bias=True),
    dict(act="relu", bias=True, residual=True),
    dict(residual=True, out_dtype="bfloat16"),
    dict(act="gelu", bias=True, residual=True),
    dict(act="silu", residual=True, out_dtype="bfloat16"),
]


@pytest.mark.parametrize("epk", EPILOGUES, ids=lambda e: "-".join(
    f"{k}={v}" for k, v in e.items()))
def test_plain_fused_epilogues_vs_pallas(epk):
    sb, m, k, b = 12, 20, 100, 5
    rng = np.random.default_rng(EPILOGUES.index(epk))
    u8, x, sc = _mk(rng, m, k, b, sb, exact=True)
    bias = (rng.integers(-3, 4, size=m).astype(np.float32)
            if epk.get("bias") else None)
    res = (rng.integers(-3, 4, size=(m, b)).astype(np.float32)
           if epk.get("residual") else None)
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    got = ops.int4_matmul(t(u8), t(sc), t(x), scale_block=sb,
                          epilogue=Epilogue(**epk), bias=t(bias),
                          residual=t(res))
    want = j_ops.int4_matmul(j(u8), j(sc), j(x), scale_block=sb,
                             epilogue=JEpilogue(**epk), bias=j(bias),
                             residual=j(res))
    assert str(got.dtype).removeprefix("torch.") == \
        (epk.get("out_dtype") or "float32")
    if epk.get("act", "none") in ("none", "relu"):
        np.testing.assert_array_equal(_f32(got), _f32(want))
    else:  # tanh/exp: the same formula, last-ulp differences allowed
        np.testing.assert_allclose(_f32(got), _f32(want), **TOL)


@pytest.mark.parametrize("k", [1, 35, 37, 257])
def test_odd_k_vs_ref(k):
    """An odd k: the last byte holds one code and a pad nibble, which
    neither the kernel nor its plain version reads."""
    sb, m, b = 36, 11, 3
    rng = np.random.default_rng(k)
    u8, x, sc = _mk(rng, m, k, b, sb, exact=True)
    u8[:, -1] |= 0x0F if k % 2 else 0  # garbage in the pad nibble
    got = ops.int4_matmul(torch.from_numpy(u8), torch.from_numpy(sc),
                          torch.from_numpy(x), scale_block=sb)
    want = j_ref.int4_matmul_ref(jnp.asarray(u8), jnp.asarray(sc),
                                 jnp.asarray(x), scale_block=sb)
    np.testing.assert_array_equal(_f32(got), _f32(want))


def test_vector_x_and_strided_operands():
    """(k,) x squeezes; transposed (engine-layout) operands change no bit."""
    sb, m, k, b = 36, 33, 520, 6
    rng = np.random.default_rng(3)
    u8, x, sc = _mk(rng, m, k, b, sb, exact=False)
    args = (torch.from_numpy(u8), torch.from_numpy(sc))
    v = ops.int4_matmul(*args, torch.from_numpy(x[:, 0]), scale_block=sb)
    assert v.shape == (m,)
    want = j_ops.int4_matmul(jnp.asarray(u8), jnp.asarray(sc),
                             jnp.asarray(x[:, 0]), scale_block=sb)
    np.testing.assert_allclose(v.numpy(), np.asarray(want), **TOL)
    xt = torch.from_numpy(np.ascontiguousarray(x.T)).t()  # (k, b) view
    res = torch.from_numpy(rng.standard_normal((b, m)).astype(np.float32))
    ep = Epilogue(residual=True)
    base = ops.int4_matmul(*args, torch.from_numpy(x), scale_block=sb,
                           epilogue=ep, residual=res.t().contiguous())
    got = ops.int4_matmul(*args, xt, scale_block=sb, epilogue=ep,
                          residual=res.t())
    assert torch.equal(got, base)


def test_hopper_tiles():
    """The picker at the engine's shapes: the batch as tb, the split count
    whose blocks end soonest on the card (the fastest, or within a few
    per cent, in the card's sweep), x tiles of a split's range at most
    32 KiB, shortened where small scale blocks' scales need the room."""
    assert ops.int4_tiles(16384, 2048, 4) == i4.Int4Tiles(4, 2048, 1)
    assert ops.int4_tiles(2048, 16384, 1) == i4.Int4Tiles(1, 4096, 4)
    assert ops.int4_tiles(256000, 2048, 8) == i4.Int4Tiles(8, 1024, 1)
    # gemma-2b down, wq/wo and wk/wv at b = 4
    assert ops.int4_tiles(2048, 16384, 4) == i4.Int4Tiles(4, 2048, 4)
    assert ops.int4_tiles(2048, 2048, 4) == i4.Int4Tiles(4, 512, 4)
    assert ops.int4_tiles(256, 2048, 4) == i4.Int4Tiles(4, 256, 8)
    # gemma2-9b's gate/up and down at b = 4
    assert ops.int4_tiles(14336, 3584, 4).nsplit == 2
    assert ops.int4_tiles(3584, 14336, 4).nsplit == 7
    t = ops.int4_tiles(24, 90, 3)
    assert t == i4.Int4Tiles(4, 256, 1)
    for m, k, b in ((2048, 16384, 4), (256, 2048, 1), (14336, 3584, 8)):
        t = ops.int4_tiles(m, k, b)
        per, n = i4.split_steps(k, t.nsplit)
        assert n == t.nsplit and t.tk <= per * i4.STEP
        assert t.tb * t.tk * 4 <= 32 * 1024
    # the staged tile: x and the tile's scales within SMEM_BLOCK bytes
    assert i4.stage_codes(i4.Int4Tiles(4, 2048, 1), 36) == 2048
    assert i4.stage_codes(i4.Int4Tiles(1, 8192, 1), 36) == 6400
    assert i4.stage_codes(i4.Int4Tiles(4, 2048, 1), 1) == 256
    for tiles, sb in ((i4.Int4Tiles(1, 8192, 1), 36),
                      (i4.Int4Tiles(8, 1024, 1), 2)):
        tk = i4.stage_codes(tiles, sb)
        assert i4.smem_bytes(tiles.tb, tk, sb) <= i4.SMEM_BLOCK


# (scale_block, m, k, b): several 256-code steps; a scale block longer
# than a step (a lane's segment spans steps and is cut where a split ends)
SPLIT_SHAPES = [(36, 9, 1100, 2), (12, 7, 1300, 3), (300, 5, 1000, 2)]


@pytest.mark.parametrize("nsplit", [2, 3, 5])
@pytest.mark.parametrize("sb,m,k,b", SPLIT_SHAPES)
def test_plain_split_counts(sb, m, k, b, nsplit):
    """Every split count gives the same bits on exact inputs (and the
    reference's); on floats, split s's sum is the one-split sum of the
    codes in its range (x zeroed elsewhere adds exact zeros to the same
    segments), and the splits are added in order."""
    rng = np.random.default_rng(sb + m + k + b + nsplit)
    tiles = lambda n: i4.Int4Tiles(tb=4, tk=256, nsplit=n)  # noqa: E731
    for exact in (True, False):
        u8, x, sc = _mk(rng, m, k, b, sb, exact)
        args = (torch.from_numpy(u8), torch.from_numpy(sc))
        got = i4.int4_matmul_plain(*args, torch.from_numpy(x),
                                   scale_block=sb, tiles=tiles(nsplit))
        if exact:
            one = i4.int4_matmul_plain(*args, torch.from_numpy(x),
                                       scale_block=sb, tiles=tiles(1))
            assert torch.equal(got, one)
            want = j_ref.int4_matmul_ref(jnp.asarray(u8), jnp.asarray(sc),
                                         jnp.asarray(x), scale_block=sb)
            np.testing.assert_array_equal(got.numpy(), _f32(want))
            continue
        per, n = i4.split_steps(k, nsplit)
        total = None
        for s in range(n):
            xs = np.zeros_like(x)
            lo, hi = s * per * i4.STEP, (s + 1) * per * i4.STEP
            xs[lo:hi] = x[lo:hi]
            part = i4.int4_matmul_plain(*args, torch.from_numpy(xs),
                                        scale_block=sb, tiles=tiles(1))
            total = part if total is None else total + part
        assert torch.equal(got, total)
        assert not torch.equal(got, i4.int4_matmul_plain(
            *args, torch.from_numpy(x), scale_block=sb, tiles=tiles(1)))


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("sb,m,k,b", SHAPES[:2] + SPLIT_SHAPES[:1])
def test_plain_half_x_vs_pallas(sb, m, k, b, dtype):
    """bf16/f16 x and residual (the engine's activations) give the bits
    of the same values in f32, and agree with the Pallas kernel on them
    (exactly on exact inputs, within TOL on floats)."""
    rng = np.random.default_rng(sb + m + k + b)
    dt = getattr(torch, dtype)
    for exact in (True, False):
        u8, x, sc = _mk(rng, m, k, b, sb, exact)
        xh = torch.from_numpy(x).to(dt)
        res = torch.from_numpy(rng.standard_normal((m, b))
                               .astype(np.float32)).to(dt)
        ep = Epilogue(residual=True)
        args = (torch.from_numpy(u8), torch.from_numpy(sc))
        got = ops.int4_matmul(*args, xh, scale_block=sb, epilogue=ep,
                              residual=res)
        same = ops.int4_matmul(*args, xh.float(), scale_block=sb,
                               epilogue=ep, residual=res.float())
        assert torch.equal(got, same)
        want = j_ops.int4_matmul(
            jnp.asarray(u8), jnp.asarray(sc), jnp.asarray(xh.float().numpy()),
            scale_block=sb, epilogue=JEpilogue(residual=True),
            residual=jnp.asarray(res.float().numpy()))
        if exact:
            np.testing.assert_array_equal(got.numpy(), _f32(want))
        else:
            np.testing.assert_allclose(got.numpy(), _f32(want), **TOL)


def test_wrapper_passes_half_x_and_residual_unconverted(monkeypatch):
    """ops.int4_matmul hands bf16 x and residual to the kernel function as
    they are (no widening copy); other types are widened to f32."""
    seen = []
    real = i4.int4_matmul

    def spy(u8, scales, x, **kw):
        seen.append((x, kw["residual"]))
        return real(u8, scales, x, **kw)

    monkeypatch.setattr(i4, "int4_matmul", spy)
    rng = np.random.default_rng(5)
    u8, x, sc = _mk(rng, 8, 40, 3, 12, exact=True)
    args = (torch.from_numpy(u8), torch.from_numpy(sc))
    xb = torch.from_numpy(x).to(torch.bfloat16).t().contiguous().t()
    res = torch.ones((3, 8), dtype=torch.bfloat16).t()
    ops.int4_matmul(*args, xb, scale_block=12,
                    epilogue=Epilogue(residual=True), residual=res)
    assert seen[-1][0] is xb and seen[-1][1] is res
    ops.int4_matmul(*args, xb.to(torch.float64), scale_block=12)
    assert seen[-1][0].dtype == torch.float32


def test_wrapper_routes_by_device_without_fallback():
    rng = np.random.default_rng(2)
    u8, x, sc = _mk(rng, 8, 12, 2, 6, exact=True)
    args = (torch.from_numpy(u8), torch.from_numpy(sc), torch.from_numpy(x))
    kw = dict(scale_block=6, tiles=ops.int4_tiles(8, 12, 2))
    before = i4.launches
    i4.int4_matmul(*args, **kw)  # CPU tensors: the plain version
    assert i4.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        i4.int4_matmul_cuda(*args, **kw)
    with pytest.raises(ValueError, match="unsupported device"):
        i4.int4_matmul(*(a.to("meta") for a in args), **kw)
    with pytest.raises(ValueError, match="scales"):
        i4.int4_matmul_plain(args[0], args[1][:, :1], args[2], **kw)
    with pytest.raises(ValueError, match="bytes a row"):
        i4.int4_matmul_plain(args[0], args[1], args[2][:4], **kw)
    with pytest.raises(ValueError, match="epilogue"):
        ops.int4_matmul(*args, scale_block=6, bias=torch.zeros(8))


# ----------------------------------------------------------------- dispatch
@pytest.mark.parametrize("storage", ["packed_idx", "packed_u8"])
def test_linear_apply_and_dispatch(storage):
    rng = np.random.default_rng(9)
    w = rng.standard_normal((16, 50)).astype(np.float32) * 50**-0.5
    x = rng.standard_normal((2, 5, 50)).astype(np.float32)
    kw = dict(QSPEC, scale_block=12, storage=storage)
    spec = QuantSpec(**kw)
    assert dispatch.plan(spec, 16, 50, 10).backend == "int4_cuda"
    tp = t_linear.from_dense(torch.from_numpy(w), spec)
    jp = j_linear.from_dense(jnp.asarray(w), JSpec(**kw))
    for name in jp:
        np.testing.assert_array_equal(tp[name].numpy(), np.asarray(jp[name]))
    got = t_linear.apply(tp, torch.from_numpy(x), spec, in_dim=50)
    want = j_linear.apply(jp, jnp.asarray(x), JSpec(**kw), in_dim=50)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the fused epilogue equals the same ops after the product
    ep = Epilogue(act="silu", bias=True, residual=True)
    b, r = torch.randn(16), torch.randn(2, 5, 16)
    fused = t_linear.apply(tp, torch.from_numpy(x), spec, in_dim=50,
                           epilogue=ep, bias=b, residual=r)
    torch.testing.assert_close(
        fused, torch.nn.functional.silu(got + b) + r, rtol=1e-6, atol=1e-6)
    # int4 with a learned codebook goes to the dequantize-then-matmul
    # backend (the kernel takes the uniform grid only)
    assert dispatch.plan(QuantSpec(**dict(kw, codebook="learned")),
                         16, 50, 10).backend == "int4_torch"


# ------------------------------------------------------------ model / engine
CFG = JConfig(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
              d_ff=128, vocab_size=211, max_seq_len=128,
              block_pattern=("attn", "local"), sliding_window=5)


@pytest.fixture(scope="module")
def pair():
    """(jax params, jax cfg, port model, port cfg): the same int4 weights."""
    spec = JSpec(**QSPEC, storage="packed_u8")
    jp = j_quantize(JT.init_params(jax.random.PRNGKey(0), CFG), CFG, spec)
    jcfg = CFG.replace(quant=spec)
    tcfg = convert.config_from_jax(jcfg)
    return jp, jcfg, convert.params_from_jax(jax.tree.map(np.asarray, jp),
                                             tcfg, device="cpu"), tcfg


def test_model_logits_match_jax(pair):
    jp, jcfg, model, tcfg = pair
    toks = np.random.default_rng(1).integers(0, jcfg.vocab_size,
                                             size=(2, 9)).astype(np.int32)
    want, _ = JT.forward(jp, jcfg, {"tokens": jnp.asarray(toks)})
    before = i4.launches, ms.launches
    with torch.no_grad():
        got = TT.forward(model, tcfg, torch.from_numpy(toks)).numpy()
    assert (i4.launches, ms.launches) == before
    np.testing.assert_allclose(got, np.asarray(want), **LOGIT_TOL)


def _serve(engine_cls, req_cls, params, cfg, prompts, new, **kw):
    kw.setdefault("max_slots", 3)
    kw.setdefault("block_size", 4)
    kw.setdefault("prefill_chunk", 4)
    kw.setdefault("max_model_len", 64)
    eng = engine_cls(params, cfg, **kw)
    res = eng.run([req_cls(rid=i, prompt=p, max_new_tokens=new)
                   for i, p in enumerate(prompts)])
    return eng, [res[i].generated for i in range(len(prompts))]


@pytest.mark.parametrize("lens,new,kw", [
    ((5, 9, 3), 5, {}),
    ((6, 6), 10, dict(max_slots=2, prefill_chunk=8, max_model_len=16,
                      num_blocks=7)),  # pool too small: preemption
], ids=["mixed", "preempt"])
def test_engine_tokens_match_jax_engine_and_static(pair, lens, new, kw):
    jp, jcfg, model, tcfg = pair
    rng = np.random.default_rng(sum(lens))
    prompts = [tuple(int(t) for t in rng.integers(0, CFG.vocab_size, size=L))
               for L in lens]
    eng, got = _serve(Engine, Request, model, tcfg, prompts, new, **kw)
    _, want = _serve(JEngine, JRequest, jp, jcfg, prompts, new, **kw)
    assert got == want
    for prompt, toks in zip(prompts, got):
        out = TSV.generate(model, tcfg,
                           torch.tensor([prompt], dtype=torch.int32),
                           max_new_tokens=new)
        assert toks == [int(t) for t in out[0]]
    if "num_blocks" in kw:
        assert eng.scheduler.num_preemptions > 0
    assert eng.pool.free_blocks == eng.pool.capacity


def test_init_params_int4_builds_and_serves():
    """The port's own initializer quantizes block by block to int4 and the
    engine serves the result (static generate agrees)."""
    spec = QuantSpec(**QSPEC, storage="packed_u8")
    tcfg = convert.config_from_jax(CFG).replace(quant=spec)
    model = TT.init_params(tcfg, generator=generator(0, "cpu"), device="cpu",
                           quant=spec)
    wq = model.blocks[0].attn.wq.params()
    assert sorted(wq) == ["scales", "u8"] and wq["u8"].dtype == torch.uint8
    assert tuple(wq["u8"].shape) == (CFG.num_heads * CFG.head_dim,
                                     CFG.d_model // 2)
    prompts = [(3, 1, 4, 1, 5), (9, 2, 6)]
    _, got = _serve(Engine, Request, model, tcfg, prompts, 5)
    for prompt, toks in zip(prompts, got):
        out = TSV.generate(model, tcfg,
                           torch.tensor([prompt], dtype=torch.int32),
                           max_new_tokens=5)
        assert toks == [int(t) for t in out[0]]
