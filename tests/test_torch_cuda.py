"""The CUDA kernels (msGeMM, int4 GeMM, paged attention, flash attention)
against their plain PyTorch versions, on the card.

Marked ``cuda``: skips without a GPU.  Imports torch only (the machine
with the card has no JAX); run there with
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py``.

The GeMM kernels and their plain versions share one op order, so results
are bit-exact with the identity epilogue (on random floats too) and
within rtol = atol = 1e-5 with gelu, whose tanh differs in the last ulps.
Paged attention sums each dot product in another order than its plain
version (a shuffle tree against torch's einsum), over the same chunks of
the view and with the same combine: rtol = atol = 2e-5 on f32 outputs,
the tolerance tests/test_kvq.py allows the reference's two routes, and
one bf16 ulp (rtol = 2^-7) on bf16 outputs.  Flash attention likewise
(2e-5 is tests/test_kernels.py's own; on the tensor cores the mma's sums
against torch's, with p split into the same hi and lo halves), its tanh
and exp differing from torch's in the last ulps besides; one f16 ulp
(rtol = 2^-10) on f16 outputs.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_plan_isolation import (  # noqa: E402,F401  (autouse)
    isolated_plan_cache, isolated_plan_cache_module)

from repro_torch.core import packing  # noqa: E402
from repro_torch.kernels import msgemm as ms  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

SHAPES = [  # (d, scale_block, m, k, b)
    (1, 6, 13, 30, 5),
    (2, 4, 16, 24, 8),
    (3, 12, 64, 258, 1),
    (3, 9, 7, 129, 2),
    (4, 8, 24, 140, 4),
    (3, 36, 2048, 2048, 4),
    (3, 36, 600, 16384, 8),
]


@pytest.mark.cuda
@pytest.mark.parametrize("d,sb,m,k,b", SHAPES)
def test_cuda_kernel_matches_plain(d, sb, m, k, b):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    rng = np.random.default_rng(m + k)
    for exact in (True, False):
        codes = rng.integers(0, 16, size=(m, k)).astype(np.uint8)
        nsb = -(-k // sb)
        x = (rng.integers(-4, 5, size=(k, b)) if exact
             else rng.standard_normal((k, b))).astype(np.float32)
        sc = (2.0 ** rng.integers(-2, 3, size=(m, nsb)) if exact
              else np.abs(rng.standard_normal((m, nsb))) + 0.1) \
            .astype(np.float32)
        idx = packing.pack_indices(torch.from_numpy(codes), d).cuda()
        xt, st = torch.from_numpy(x).cuda(), torch.from_numpy(sc).cuda()
        res = torch.from_numpy(rng.standard_normal((m, b)).astype(np.float32)) \
            .cuda()
        tiles = ops.msgemm_tiles(m, idx.shape[1], b, d, sb)
        for act in ("none", "gelu"):
            kw = dict(d=d, scale_block=sb, tiles=tiles, act=act, residual=res)
            vals = packing.b_values(device="cuda")
            got = ms.msgemm_cuda(idx, xt, st, vals, **kw)
            want = ms.msgemm_plain(idx, xt, st, vals, **kw)
            torch.cuda.synchronize()
            if act == "none":
                assert torch.equal(got, want)
            else:
                torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


# (name, d, scale_block, m, k, b, tiles or None for the picker's, x and
# residual dtype, engine layout): the variants and edges of the kernel
VARIANTS = [
    ("bf16-engine-gate", 3, 36, 16384, 2048, 4, None, "bfloat16", True),
    ("bf16-engine-down-b1", 3, 36, 2048, 16384, 1, None, "bfloat16", True),
    ("bf16-engine-wk-b8", 3, 36, 256, 2048, 8, None, "bfloat16", True),
    ("m-ragged-rows1024", 3, 36, 2348, 2048, 4,
     ms.Tiles(tb=4, rows=1024, stage=8, tj=96), "float32", False),
    ("m-ragged-rows512-bf16", 3, 12, 1300, 300, 3,
     ms.Tiles(tb=4, rows=512, stage=16, tj=20), "bfloat16", True),
    ("kc-below-stage", 3, 6, 600, 30, 4,
     ms.Tiles(tb=4, rows=512, stage=16, tj=10), "float32", False),
    ("single-split", 3, 36, 1000, 900, 4,
     ms.Tiles(tb=4, rows=1024, stage=8, tj=300), "float32", False),
    ("many-splits", 3, 36, 2048, 2048, 4,
     ms.Tiles(tb=4, rows=512, stage=16, tj=12), "bfloat16", True),
    ("d1", 1, 6, 300, 100, 5, None, "float32", False),
    ("d2-tb1", 2, 8, 300, 130, 1, None, "bfloat16", True),
    ("d4-tb1", 4, 8, 200, 90, 3, None, "float32", False),
    ("d3-tb1-rows2048", 3, 12, 5000, 301, 2,
     ms.Tiles(tb=1, rows=2048, stage=4, tj=40), "float32", False),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", VARIANTS, ids=lambda c: c[0])
def test_cuda_kernel_variants_match_plain(case):
    """bf16 operands in the engine's transposed layout, m that is not a
    multiple of a block's rows, kc below one index stage, one split and
    many, d = 1, 2, 4 and TB = 1: each bit-exact against the plain version
    with the identity epilogue (random floats), within 1e-5 with gelu."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    _, d, sb, m, k, b, tiles, xdt, engine = case
    xdt = getattr(torch, xdt)
    rng = np.random.default_rng(m * 7 + k + b)
    codes = rng.integers(0, 16, size=(m, k)).astype(np.uint8)
    nsb = -(-k // sb)
    idx = packing.pack_indices(torch.from_numpy(codes), d).cuda()
    kc = idx.shape[1]
    tiles = tiles or ops.msgemm_tiles(m, kc, b, d, sb)

    def cols(rows):  # (rows, b) in xdt, transposed view when engine
        a = rng.standard_normal((b, rows) if engine else (rows, b))
        t = torch.from_numpy(a.astype(np.float32)).cuda().to(xdt)
        return t.t() if engine else t

    x, res = cols(k), cols(m)
    st = torch.from_numpy((np.abs(rng.standard_normal((m, nsb))) + 0.1)
                          .astype(np.float32)).cuda()
    vals = packing.b_values(device="cuda")
    for act in ("none", "gelu"):
        kw = dict(d=d, scale_block=sb, tiles=tiles, act=act, residual=res,
                  out_dtype=torch.bfloat16 if engine else torch.float32)
        got = ms.msgemm_cuda(idx, x, st, vals, **kw)
        want = ms.msgemm_plain(idx, x, st, vals, **kw)
        torch.cuda.synchronize()
        if act == "none":
            assert torch.equal(got, want)
        else:
            torch.testing.assert_close(got.float(), want.float(), rtol=1e-5,
                                       atol=1e-5)


@pytest.mark.cuda
def test_cuda_smem_formula_matches_kernel():
    """msgemm.smem_bytes mirrors csrc/msgemm.cu's formula."""
    import ctypes

    from repro_torch.kernels import nvcc

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    fn = nvcc.load("msgemm", "msgemm_smem_bytes", [ctypes.c_int] * 4)
    fn.restype = ctypes.c_longlong
    for d in (1, 2, 3, 4):
        for tb in (1, 4):
            for rows in (512, 1024, 2048):
                for stage in (4, 8, 16, 32):
                    assert fn(d, tb, rows, stage) == \
                        ms.smem_bytes(d, tb, rows, stage)


# ------------------------------------------------------------- int4 GeMM
I4_SHAPES = [  # (scale_block, m, k, b)
    (36, 24, 90, 4),
    (12, 7, 131, 3),
    (36, 40, 300, 9),
    (32, 9, 1100, 2),
    (36, 16384, 2048, 4),  # gemma-2b gate/up
    (36, 2048, 16384, 1),  # gemma-2b down
    (36, 2048, 16384, 4),  # gemma-2b down at b = 4: 5 splits
    (36, 256, 2048, 4),  # gemma-2b wk/wv at b = 4: 8 splits
    (300, 33, 2000, 5),  # scale blocks longer than a 256-code step
    (36, 100, 4100, 4),  # rows of 2050 bytes: byte-wise loads
]


@pytest.mark.cuda
@pytest.mark.parametrize("sb,m,k,b", I4_SHAPES)
def test_int4_kernel_matches_plain(sb, m, k, b):
    from repro_torch.kernels import int4_matmul as i4

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    rng = np.random.default_rng(m + k + b)
    codes = torch.from_numpy(rng.integers(0, 16, size=(m, k)).astype(np.uint8))
    u8 = packing.pack_storage(codes).contiguous().cuda()
    nsb = -(-k // sb)
    for exact in (True, False):
        x = (rng.integers(-4, 5, size=(b, k)) if exact
             else rng.standard_normal((b, k))).astype(np.float32)
        sc = (2.0 ** rng.integers(-2, 3, size=(m, nsb)) if exact
              else (np.abs(rng.standard_normal((m, nsb))) + 0.1) * k**-0.5)
        # x and the residual as the engine passes them: (k, b) and (m, b)
        # transposed views of row-major activations
        xt = torch.from_numpy(x).cuda().t()
        st = torch.from_numpy(sc.astype(np.float32)).cuda()
        res = torch.from_numpy(rng.integers(-3, 4, size=(b, m))
                               .astype(np.float32)).cuda().t()
        tiles = ops.int4_tiles(m, k, b)
        for act, out_dtype in (("none", torch.float32),
                               ("gelu", torch.float32),
                               ("none", torch.bfloat16)):
            kw = dict(scale_block=sb, tiles=tiles, act=act, residual=res,
                      out_dtype=out_dtype)
            got = i4.int4_matmul_cuda(u8, st, xt, **kw)
            want = i4.int4_matmul_plain(u8, st, xt, **kw)
            torch.cuda.synchronize()
            assert got.dtype == out_dtype
            if act == "none":  # one op order: bit-exact
                assert torch.equal(got, want)
            else:
                torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_int4_smem_formula_matches_kernel():
    """int4_matmul.smem_bytes mirrors csrc/int4_matmul.cu's formula."""
    import ctypes

    from repro_torch.kernels import int4_matmul as i4
    from repro_torch.kernels import nvcc

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    fn = nvcc.load("int4_matmul", "int4_smem_bytes", [ctypes.c_int] * 3)
    fn.restype = ctypes.c_longlong
    for tb in (1, 2, 4, 8):
        for tk in (256, 1024, 8192):
            for sb in (1, 12, 36, 300):
                assert fn(tb, tk, tk // sb + 2) == i4.smem_bytes(tb, tk, sb)


I4_HALF_SHAPES = [  # (scale_block, m, k, b)
    (36, 2048, 16384, 4),  # gemma-2b down
    (36, 256, 2048, 4),  # gemma-2b wk/wv
    (36, 2048, 2048, 8),  # gemma-2b wq/wo
    (12, 7, 1300, 3),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("sb,m,k,b", I4_HALF_SHAPES)
def test_int4_kernel_half_x_matches_plain(sb, m, k, b, dtype):
    """bf16/f16 x and residual as the engine passes them, read by the
    kernel in their own type: bit-exact against the plain version on
    random floats (none and relu epilogues) at the picked split and at
    one, two and as many splits as 256-code steps."""
    from repro_torch.kernels import int4_matmul as i4

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(m + k + b)
    codes = torch.randint(0, 16, (m, k), generator=g, device="cuda",
                          dtype=torch.uint8)
    u8 = packing.pack_storage(codes).contiguous()
    nsb = -(-k // sb)
    sc = (torch.rand((m, nsb), generator=g, device="cuda") + 0.1) * k**-0.5
    xt = torch.randn((b, k), generator=g, device="cuda").to(dt).t()
    res = torch.randn((b, m), generator=g, device="cuda").to(dt).t()
    picked = ops.int4_tiles(m, k, b)
    steps = -(-k // i4.STEP)
    for n in sorted({picked.nsplit, 1, 2, steps}):
        tiles = picked._replace(nsplit=n)
        for act, out_dtype in (("none", torch.bfloat16),
                               ("relu", torch.float32),
                               ("gelu", torch.bfloat16)):
            kw = dict(scale_block=sb, tiles=tiles, act=act, residual=res,
                      out_dtype=out_dtype)
            got = i4.int4_matmul_cuda(u8, sc, xt, **kw)
            want = i4.int4_matmul_plain(u8, sc, xt, **kw)
            torch.cuda.synchronize()
            if act in ("none", "relu"):
                assert torch.equal(got, want), (n, act)
            else:
                torch.testing.assert_close(got.float(), want.float(),
                                           rtol=2**-7, atol=1e-5)


# ------------------------------------------------------- paged attention
PA_CASES = [  # (B, C, H, Hk, Dh, bs, nseq, kv spec, softcap, window)
    (2, 4, 4, 2, 16, 8, 3, dict(bits=8), 0.0, 0),
    (2, 3, 4, 2, 17, 4, 5, dict(bits=4), 5.0, 0),
    (3, 1, 6, 3, 32, 8, 4, dict(bits=4, codebook=True), 0.0, 7),
    (4, 1, 8, 1, 256, 8, 4, dict(bits=8), 0.0, 0),  # gemma-2b decode
    (1, 8, 8, 1, 256, 8, 4, dict(bits=4), 0.0, 0),  # gemma-2b prefill
    (2, 1, 16, 8, 256, 8, 8, dict(bits=8), 50.0, 24),  # gemma2-9b shape
    (2, 1, 8, 1, 256, 8, 512, dict(bits=8), 0.0, 0),  # W = 4096
    (2, 1, 16, 8, 256, 8, 512, dict(bits=4), 50.0, 1000),  # W = 4096
    (2, 2, 4, 2, 64, 1, 257, dict(bits=8), 5.0, 0),  # two chunks + 1 slot
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,C,H,hk,dh,bs,nseq,kv,softcap,window", PA_CASES)
def test_paged_attention_kernel_matches_plain(B, C, H, hk, dh, bs, nseq, kv,
                                              softcap, window):
    from repro_torch import kvq
    from repro_torch.kernels import paged_attention as pa

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    rng = np.random.default_rng(B * 100 + H + dh)
    cb = None
    if kv.get("codebook"):
        cb = tuple([0.0] + sorted(rng.normal(size=15).tolist()))
    spec = kvq.KVQuantSpec(kv["bits"], codebook=cb)
    nb = 1 + B * nseq
    pool = {}
    for name in ("k", "v"):
        vals = torch.from_numpy(rng.standard_normal((nb, bs, hk, dh))
                                .astype(np.float32)).cuda()
        pool[name], pool[f"{name}_scale"] = kvq.kv_quantize(vals, spec)
    tables = torch.from_numpy(rng.permutation(np.arange(1, nb))
                              .reshape(B, nseq).astype(np.int32)).cuda()
    pos = torch.from_numpy(rng.integers(0, nseq * bs, size=(B, C))
                           .astype(np.int32)).cuda()
    q32 = torch.from_numpy(rng.standard_normal((B, C, H, dh))
                           .astype(np.float32)).cuda()
    kw = dict(bits=spec.bits, block_size=bs, window=window, softcap=softcap,
              codebook=None if cb is None else torch.tensor(cb).cuda())
    args = (pool["k"], pool["k_scale"], pool["v"], pool["v_scale"], tables,
            pos)
    for q, tol in ((q32, dict(rtol=2e-5, atol=2e-5)),
                   (q32.to(torch.bfloat16), dict(rtol=2**-7, atol=1e-5))):
        got = pa.paged_attention_cuda(q, *args, **kw)
        want = pa.paged_attention_plain(q, *args, **kw)
        torch.cuda.synchronize()
        assert got.dtype == q.dtype
        torch.testing.assert_close(got.float(), want.float(), **tol)


# ------------------------------------------------------- flash attention
FA_CASES = [  # (B, Sq, Skv, H, Hk, dh, causal, window, softcap)
    (2, 37, 37, 4, 2, 16, True, 0, 0.0),
    (1, 130, 70, 6, 3, 12, True, 64, 20.0),
    (2, 64, 128, 4, 1, 8, False, 20, 0.0),
    (1, 200, 200, 2, 2, 17, True, 70, 0.0),
    (1, 1024, 1024, 8, 1, 256, True, 0, 0.0),  # gemma-2b prefill
    (1, 1024, 1024, 16, 8, 256, True, 512, 50.0),  # gemma2-9b local layer
    (2, 256, 256, 4, 2, 64, True, 0, 0.0),
    (1, 512, 512, 8, 2, 128, True, 0, 10.0),
    (1, 777, 777, 4, 2, 256, True, 300, 0.0),  # ragged Sq, many tiles
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,Sq,Skv,H,hk,dh,causal,window,softcap", FA_CASES)
def test_flash_attention_kernel_matches_plain(B, Sq, Skv, H, hk, dh, causal,
                                              window, softcap):
    from repro_torch.kernels import flash_attention as fa

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    rng = np.random.default_rng(Sq + H + dh)
    q32, k32, v32 = (torch.from_numpy(rng.standard_normal(s)
                                      .astype(np.float32)).cuda()
                     for s in ((B, H, Sq, dh), (B, hk, Skv, dh),
                               (B, hk, Skv, dh)))
    kw = dict(causal=causal, window=window, softcap=softcap)
    for dtype, tol in ((torch.float32, dict(rtol=2e-5, atol=2e-5)),
                       (torch.bfloat16, dict(rtol=2**-7, atol=1e-5))):
        q, k, v = (t.to(dtype) for t in (q32, k32, v32))
        before = fa.launches
        got = fa.flash_attention(q, k, v, **kw)
        want = fa.flash_attention_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        assert fa.launches == before + 1 and got.dtype == dtype
        torch.testing.assert_close(got.float(), want.float(), **tol)
        # the public layout: (B, S, H, dh), padded as the reference pads
        if causal or Skv % 8 == 0:
            pub = [t.transpose(1, 2) for t in (q, k, v)]
            got = ops.flash_attention(*pub, **kw)
            want = ops.flash_attention(*pub, kernel=fa.flash_attention_plain,
                                       **kw)
            torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_flash_tensor_core_variants_match_plain(dtype):
    """Every compiled tensor-core variant of its type (head-dim classes,
    tiles and ring depths) against the plain version at the same tiles,
    within one ulp of the type; the launch fails for a variant that is
    not compiled."""
    from repro_torch.kernels import flash_attention as fa

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    dt = getattr(torch, dtype)
    tol = dict(rtol=2**-7 if dt == torch.bfloat16 else 2**-10, atol=1e-5)
    rng = np.random.default_rng(11)
    for _, dc, tq, tk, st in (v for v in fa.MMA_VARIANTS if v[0] == dt):
        dh = dc if dc < 256 else 200 + (tq + tk + st) % 56
        q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                   .cuda().to(dt)
                   for s in ((1, 4, 300, dh), (1, 2, 300, dh),
                             (1, 2, 300, dh)))
        kw = dict(causal=True, window=130, softcap=20.0, tq=tq, tk=tk)
        got = fa.flash_attention_cuda(q, k, v, stages=st, **kw)
        want = fa.flash_attention_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), **tol,
                                   msg=lambda m: f"{dc} {tq} {tk} {st}: {m}")
    with pytest.raises(ValueError, match="no tensor-core variant"):
        fa.flash_attention_cuda(q, k, v, tq=32, tk=32)


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [16, 64, 256])
def test_paged_attention_chunk_lengths_match_plain(chunk):
    """The kernel at other chunk lengths and rows per block against the
    plain version at the same chunk: views of many chunks, a row whose
    window starts past its first chunks, a row whose later chunks are
    empty."""
    from repro_torch import kvq
    from repro_torch.kernels import paged_attention as pa

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    rng = np.random.default_rng(chunk)
    B, C, H, hk, dh, bs, nseq = 3, 2, 8, 2, 128, 8, 80
    spec = kvq.KVQuantSpec(8)
    nb = 1 + B * nseq
    pool = {}
    for name in ("k", "v"):
        vals = torch.from_numpy(rng.standard_normal((nb, bs, hk, dh))
                                .astype(np.float32)).cuda()
        pool[name], pool[f"{name}_scale"] = kvq.kv_quantize(vals, spec)
    tables = torch.from_numpy(rng.permutation(np.arange(1, nb))
                              .reshape(B, nseq).astype(np.int32)).cuda()
    pos = torch.tensor([[600, 639], [5, 40], [300, 301]], dtype=torch.int32,
                       device="cuda")
    q = torch.from_numpy(rng.standard_normal((B, C, H, dh))
                         .astype(np.float32)).cuda().to(torch.bfloat16)
    args = (q, pool["k"], pool["k_scale"], pool["v"], pool["v_scale"],
            tables, pos)
    for window, rows in ((0, None), (100, None), (100, 1), (0, 8)):
        kw = dict(bits=8, block_size=bs, window=window, softcap=30.0,
                  chunk=chunk)
        got = pa.paged_attention_cuda(*args, rows=rows, **kw)
        want = pa.paged_attention_plain(*args, **kw)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), rtol=2**-7,
                                   atol=1e-5)


@pytest.mark.cuda
def test_paged_smem_formula_matches_kernel():
    """paged_attention.smem_bytes mirrors csrc/paged_attention.cu's."""
    import ctypes

    from repro_torch.kernels import nvcc
    from repro_torch.kernels import paged_attention as pa

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    fn = nvcc.load("paged_attention", "paged_attention_smem_bytes",
                   [ctypes.c_int] * 4)
    fn.restype = ctypes.c_longlong
    for dhp in (8, 9, 16, 128, 256):
        for bits in (8, 4):
            for chunk in (16, 128, 256):
                for rb in (1, 2, 4, 8):
                    assert fn(dhp, bits, chunk, rb) == \
                        pa.smem_bytes(dhp, bits, chunk, rb)


# ----------------------------------------- the engine's step as a CUDA graph
def _small_engine_model(mode):
    """The gemma-2b smoke config (2 layers, d_model 64) from seed 0 on the
    card, with msgemm or int4 weights; kv8 is msgemm weights on a kv8
    pool, kv4-torch on a kv4 pool read through the torch route (a
    gather and dequantize through the uniform grid's table, which the
    capture must find on the card).  Returns (params, cfg, engine
    kwargs)."""
    from repro_torch import configs
    from repro_torch.core.spec import QuantSpec
    from repro_torch.device import generator
    from repro_torch.kvq import KVQuantSpec
    from repro_torch.models import transformer

    spec = (QuantSpec(mode="int4_dequant", d=3, scale_block=36,
                      storage="packed_u8") if mode == "int4"
            else QuantSpec(mode="msgemm", d=3, scale_block=36))
    cfg = configs.get_smoke("gemma_2b")
    params = transformer.init_params(cfg, generator=generator(0, "cuda"),
                                     device="cuda", quant=spec)
    kw = {"kv8": dict(kv_quant=KVQuantSpec(8)),
          "kv4-torch": dict(kv_quant=KVQuantSpec(
              4, backend="paged_attn_torch"))}.get(mode, {})
    return params, cfg.replace(quant=spec), kw


def _small_engine(params, cfg, cuda_graph, **kw):
    from repro_torch.serving import Engine

    return Engine(params, cfg, max_slots=4, block_size=8, prefill_chunk=8,
                  max_model_len=24, cuda_graph=cuda_graph, **kw)


def _serve_small(params, cfg, cuda_graph, eng=None, **kw):
    """Six requests through the engine (``eng``, else one built here);
    the launch counts are set to 0 after the engine (and its graphs) were
    built."""
    from repro_torch.kernels.ops import KERNELS, launch_counts
    from repro_torch.serving import poisson_stream

    reqs = poisson_stream(6, cfg.vocab_size, max_new_tokens=8, rate=0.0,
                          min_prompt=3, max_prompt=16, seed=0)
    eng = eng or _small_engine(params, cfg, cuda_graph, **kw)
    for mod in KERNELS.values():
        mod.launches = 0
    res = eng.run(reqs, wait_for_arrivals=False)
    torch.cuda.synchronize()
    return ({rid: s.generated for rid, s in res.items()}, launch_counts(),
            eng)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["msgemm", "kv8", "kv4-torch", "int4"])
def test_engine_graph_route_matches_eager_route(mode):
    """Graph replays give the eager route's tokens, and the launch counts
    added per replay equal the eager route's launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    params, cfg, kw = _small_engine_model(mode)
    g_toks, g_launches, g_eng = _serve_small(params, cfg, None, **kw)
    e_toks, e_launches, e_eng = _serve_small(params, cfg, False, **kw)
    assert g_eng.runner.cuda_graph and not e_eng.runner.cuda_graph
    assert g_toks == e_toks
    assert g_eng.num_steps == e_eng.num_steps
    assert g_launches == e_launches
    gemms = 7 * cfg.num_layers
    weight = "int4_matmul" if mode == "int4" else "msgemm"
    assert g_launches[weight] == gemms * g_eng.num_steps
    assert g_launches["paged_attention"] == (
        cfg.num_layers * g_eng.num_steps if mode == "kv8" else 0)


@pytest.mark.cuda
def test_capture_survives_a_dropped_engine_in_a_cycle(monkeypatch):
    """An engine held only by a reference cycle becomes garbage while the
    next engine captures its graphs, and the collector's youngest
    generation would run: it is not collected during the capture
    (freeing its graphs there would invalidate the capture), and the new
    engine gives the eager route's tokens."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    import gc

    from repro_torch.runtime import serve as SV

    params, cfg, kw = _small_engine_model("msgemm")
    holder = [_small_engine(params, cfg, None)]
    real = SV.paged_step

    def step(*args, **kwargs):
        if holder and torch.cuda.is_current_stream_capturing():
            box = [holder.pop()]  # the old engine, held by a young cycle
            box.append(box)
            del box
            junk = [[] for _ in range(1000)]  # allocations: collections
            del junk
        return real(*args, **kwargs)

    monkeypatch.setattr(SV, "paged_step", step)
    threshold = gc.get_threshold()
    gc.set_threshold(1)
    try:
        g_toks, _, g_eng = _serve_small(params, cfg, None)
    finally:
        gc.set_threshold(*threshold)
    assert not holder and g_eng.runner.cuda_graph
    e_toks, _, _ = _serve_small(params, cfg, False)
    assert g_toks == e_toks


# (E, sb, m, k, b, act): expert stacks, the last scale block ragged
# (k = 1408), a split contraction, b past one column tile
I4_EXPERT_SHAPES = [
    (3, 36, 40, 1408, 4, "none"),
    (4, 36, 24, 600, 9, "silu"),
    (60, 36, 1408, 2048, 16, "none"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("E,sb,m,k,b,act", I4_EXPERT_SHAPES)
def test_int4_expert_stack_matches_plain(E, sb, m, k, b, act):
    """One launch over the stack, bit-exact against the plain version (a
    per-expert loop) with bf16 x in the dispatch's layout, at the
    picker's split and at two splits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    from repro_torch.kernels import int4_matmul as i4

    rng = np.random.default_rng(E + m + k + b)
    codes = torch.from_numpy(rng.integers(0, 16, size=(E, m, k))
                             .astype(np.uint8))
    u8 = packing.pack_storage(codes).contiguous().cuda()
    sc = torch.from_numpy((np.abs(rng.standard_normal(
        (E, m, -(-k // sb)))) + 0.1).astype(np.float32)).cuda()
    x = torch.from_numpy(rng.standard_normal((E, b, k)).astype(np.float32)) \
        .cuda().to(torch.bfloat16).transpose(1, 2)
    base = ops.int4_tiles(m, k, b, E)
    for tiles in {base, base._replace(nsplit=2)}:
        kw = dict(scale_block=sb, tiles=tiles, act=act,
                  out_dtype=torch.bfloat16)
        before = i4.launches
        got = i4.int4_matmul_cuda(u8, sc, x, **kw)
        assert i4.launches == before + 1
        want = i4.int4_matmul_plain(u8, sc, x, **kw)
        torch.cuda.synchronize()
        if act == "none":
            assert torch.equal(got, want)
        else:
            torch.testing.assert_close(got.float(), want.float(),
                                       rtol=2**-7, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen2_moe", "llama4_maverick"])
def test_moe_engine_graph_route_matches_eager_route(arch):
    """A MoE model's dispatch captures: graph replays give the eager
    route's tokens and launches, the expert stacks one int4 launch a
    projection and MoE layer."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    from repro_torch import configs
    from repro_torch.core.spec import QuantSpec
    from repro_torch.device import generator
    from repro_torch.models import transformer

    spec = QuantSpec(mode="msgemm", d=3, scale_block=36)
    cfg = configs.get_smoke(arch)
    params = transformer.init_params(cfg, generator=generator(0, "cuda"),
                                     device="cuda", quant=spec)
    cfg = cfg.replace(quant=spec)
    g_toks, g_launches, g_eng = _serve_small(params, cfg, None)
    e_toks, e_launches, e_eng = _serve_small(params, cfg, False)
    assert g_eng.runner.cuda_graph and not e_eng.runner.cuda_graph
    assert g_toks == e_toks and g_launches == e_launches
    moe_layers = sum(cfg.kind(i) == "moe" for i in range(cfg.num_layers))
    assert g_launches["int4_matmul"] == 3 * moe_layers * g_eng.num_steps


@pytest.mark.cuda
def test_traced_capture_times_gemms_inside_a_replay():
    """Tracing on at capture: every replay records the gemm marks, which
    resolve into device-lane events whose durations sum to no more than
    the replay's wall time, and into kernel_gemm_s."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    import time

    from repro_torch import obs
    from repro_torch.obs import trace as TR
    from repro_torch.serving import Engine
    from repro_torch.serving.engine import STEP_INPUTS

    params, cfg, _ = _small_engine_model("msgemm")
    obs.enable_tracing(clear=True)
    try:
        eng = Engine(params, cfg, max_slots=4, block_size=8, prefill_chunk=8,
                     max_model_len=24)
        shape = eng.runner.shapes["decode"]
        assert len(shape.marks) == 7 * cfg.num_layers
        idle = [shape.host[k].numpy().copy() for k in STEP_INPUTS]
        obs.registry().reset(prefix="kernel_")
        for _ in range(3):
            obs.tracer().clear()
            t0 = time.perf_counter()
            eng.runner("decode", *idle)
            wall_us = (time.perf_counter() - t0) * 1e6
            gemms = [e for e in obs.tracer().events()
                     if e["name"].startswith("gemm.")]
            assert len(gemms) == 7 * cfg.num_layers
            assert all(e["tid"] == TR.TID_DEVICE and e["dur"] > 0
                       for e in gemms)
            assert sum(e["dur"] for e in gemms) <= wall_us
        hists = [s for s in obs.registry().series("histogram")
                 if s.name == "kernel_gemm_s"]
        assert sum(h.count for h in hists) == 3 * 7 * cfg.num_layers
    finally:
        obs.disable_tracing()
        obs.tracer().clear()


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["msgemm", "int4"])
def test_engine_autotune_on_the_card(mode, tmp_path):
    """``Engine(autotune=True)`` times the kernels' tile choices at build,
    before the capture, which then resolves every GeMM from the warm
    cache; the first steps on each route add no plan-cache miss (the
    eager engine built with no plan memoized), the routes give the same
    tokens, and a rebuild from the reloaded cache times nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    from repro_torch import dispatch, obs
    from repro_torch.dispatch import autotune as at
    from repro_torch.dispatch.plan import invalidate

    def misses():
        return obs.registry().value("counter", "dispatch_plan_cache_total",
                                    result="miss") or 0

    params, cfg, kw = _small_engine_model(mode)
    dispatch.set_cache_path(tmp_path / "plans.json")
    try:
        obs.registry().reset(prefix="dispatch_")
        at.num_timed_candidates = 0
        g_eng = _small_engine(params, cfg, None, autotune=True, **kw)
        timed = at.num_timed_candidates
        tuned = [p for p in g_eng.exec_plans.values() if p.tiles is not None]
        assert timed > 0 and tuned and g_eng.runner.cuda_graph
        assert all(p.source == "autotuned" for p in tuned)
        assert misses() == 0  # the capture found every plan in the cache
        g_toks, _, _ = _serve_small(params, cfg, None, eng=g_eng)
        assert misses() == 0 and at.num_timed_candidates == timed
        invalidate()  # the eager engine's steps resolve afresh
        e_eng = _small_engine(params, cfg, False, autotune=True, **kw)
        assert at.num_timed_candidates == timed  # all cached
        e_toks, _, _ = _serve_small(params, cfg, False, eng=e_eng)
        assert misses() == 0 and at.num_timed_candidates == timed
        assert g_toks == e_toks and e_eng.exec_plans == g_eng.exec_plans
        dispatch.set_cache_path(tmp_path / "plans.json")
        at.num_timed_candidates = 0
        r_toks, _, r_eng = _serve_small(params, cfg, None, autotune=True,
                                        **kw)
        assert at.num_timed_candidates == 0 and r_toks == g_toks
        assert r_eng.exec_plans == g_eng.exec_plans
    finally:
        dispatch.set_cache_path(None)


def _calibrate_small(device):
    """The gemma-2b SMOKE model from seed 0 on the CPU, moved to
    ``device``, calibrated there (msgemm, d=3, learned per-layer tables)."""
    from repro_torch import calib, configs
    from repro_torch.core.spec import QuantSpec
    from repro_torch.data.pipeline import DataConfig, SyntheticStream
    from repro_torch.device import generator
    from repro_torch.models import transformer

    cfg = configs.get_smoke("gemma_2b")
    model = transformer.init_params(cfg, generator=generator(0, "cpu"),
                                    device="cpu").to(device)
    stream = SyntheticStream(DataConfig(vocab_size=cfg.vocab_size,
                                        seq_len=33, global_batch=4))
    return calib.calibrate(model, cfg, stream,
                           calib.Recipe(calib_steps=2, kmeans_iters=10),
                           quant=QuantSpec(mode="msgemm", d=3,
                                           scale_block=36),
                           device=device), cfg


@pytest.mark.cuda
def test_calibrate_on_the_card_matches_the_cpu():
    """Stats, Lloyd and the nearest-code searches on the card (float64
    there) give the CPU's codebooks within 1e-6 and the same codes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    cpu, _ = _calibrate_small("cpu")
    gpu, _ = _calibrate_small("cuda")
    assert set(gpu.codebooks) == set(cpu.codebooks)
    for path, cb in cpu.codebooks.items():
        assert gpu.codebooks[path].device.type == "cuda"
        np.testing.assert_allclose(gpu.codebooks[path].cpu().numpy(),
                                   cb.numpy(), rtol=1e-6, atol=1e-6)
    agg_c, agg_g = cpu.report["aggregate"], gpu.report["aggregate"]
    assert agg_g["learned_weighted_err"] < agg_g["uniform_weighted_err"]
    np.testing.assert_allclose(agg_g["learned_weighted_err"],
                               agg_c["learned_weighted_err"], rtol=1e-5)


@pytest.mark.cuda
def test_learned_msgemm_graph_route_matches_eager_route():
    """The msGeMM kernel with each linear's learned table as its basis:
    a captured step gives the eager route's tokens and launches, 7 per
    layer and step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    res, cfg = _calibrate_small("cuda")
    qcfg = cfg.replace(quant=res.quant)
    for path, cb in res.codebooks.items():
        assert not torch.equal(cb.cpu(), packing.b_values()), path
    g_toks, g_launches, g_eng = _serve_small(res.params, qcfg, None)
    e_toks, e_launches, e_eng = _serve_small(res.params, qcfg, False)
    assert g_eng.runner.cuda_graph and not e_eng.runner.cuda_graph
    assert g_toks == e_toks and g_launches == e_launches
    assert g_launches["msgemm"] == 7 * cfg.num_layers * g_eng.num_steps


@pytest.mark.cuda
def test_observer_refuses_a_capture():
    """A host-side accumulation cannot sit inside a CUDA graph: record()
    raises while the stream is captured."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    from repro_torch.calib import StatsCollector

    col = StatsCollector()
    x = torch.ones(2, 8, device="cuda")
    col.record("wq", x)  # eager: fine
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="capture"):
        with torch.cuda.graph(graph):
            col.record("wq", x * 2)
    assert col.get("wq", 8).count == 2


@pytest.mark.cuda
def test_finite_flag_comes_from_the_graph():
    """The per-row finite flag is computed inside the captured step and
    comes back with the tokens in one (2, B) buffer: a replay over a
    poisoned norm flags every row, a replay after the repair none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    from repro_torch.serving.engine import STEP_INPUTS

    params, cfg, _ = _small_engine_model("msgemm")
    eng = _small_engine(params, cfg, None)
    shape = eng.runner.shapes["decode"]
    assert shape.graph is not None and tuple(shape.out.shape) == (2, 4)
    idle = [shape.host[k].numpy().copy() for k in STEP_INPUTS]
    assert eng.runner("decode", *idle)[1].tolist() == [1] * 4
    scale = params.final_norm.scale
    saved = scale.clone()
    scale.fill_(float("nan"))  # the graph reads the buffer in place
    try:
        _, ok, logits = eng.runner("decode", *idle)
        assert ok.tolist() == [0] * 4
        assert not torch.isfinite(logits).any()
    finally:
        scale.copy_(saved)
    assert eng.runner("decode", *idle)[1].tolist() == [1] * 4


@pytest.mark.cuda
def test_nan_replan_recaptures_onto_the_torch_rung():
    """Two injected NaN rows quarantine their sequences and then the
    kernel's backend: the engine captures both step shapes again on
    msgemm_torch, so msGeMM launches go from 7 a layer each step to 0,
    and every request ends (ok or quarantined)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    from repro_torch import dispatch, faults
    from repro_torch.kernels.ops import KERNELS
    from repro_torch.serving import poisson_stream

    params, cfg, _ = _small_engine_model("msgemm")
    eng = _small_engine(params, cfg, None)
    assert eng.runner.captures == 2
    launches = []
    run_step = eng._run_step

    def counted(name, *arrays):
        before = KERNELS["msgemm"].launches
        out = run_step(name, *arrays)
        launches.append(KERNELS["msgemm"].launches - before)
        return out

    eng._run_step = counted
    reqs = poisson_stream(6, cfg.vocab_size, max_new_tokens=8, rate=0.0,
                          min_prompt=3, max_prompt=16, seed=0)
    faults.arm("nan_logits:p=1.0,after=3,max=2")
    try:
        res = eng.run(reqs, wait_for_arrivals=False)
        faults.disarm()
        assert eng.num_replans == 1 and eng.runner.captures == 4
        assert dispatch.is_quarantined("msgemm_cuda")
        assert {p.backend for p in eng.exec_plans.values()} == \
            {"msgemm_torch"}
        k = launches.index(0)
        assert k > 0 and launches[:k] == [7 * cfg.num_layers] * k
        assert set(launches[k:]) == {0}
        statuses = [res[rid].status for rid in range(len(reqs))]
        assert statuses.count("quarantined") == 2
        assert set(statuses) == {"ok", "quarantined"}
    finally:
        faults.disarm()
        dispatch.clear_quarantine()


@pytest.mark.cuda
def test_time_call_retimes_a_window_the_host_stalled():
    """A host stall longer than the card's sleep leaves the card idle
    inside the timed window; ``time_call`` sees the sleep over before the
    last call was queued and times the window again, so the stall does
    not reach the result."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    import time

    dev = torch.device("cuda")
    a = torch.randn(1024, 1024, device=dev)
    reps = 20
    clean = ops.time_call([lambda: a @ a], dev, reps)
    calls = [0]

    def stalling():
        calls[0] += 1
        if calls[0] == 2 + reps // 2:  # mid-window of the first timing
            time.sleep(reps * 1e-3)  # five times the window's sleep
        return a @ a

    before = ops.time_call_retries
    stalled = ops.time_call([stalling], dev, reps)
    assert ops.time_call_retries > before
    assert stalled < 1.5 * clean, (stalled, clean)


@pytest.mark.cuda
def test_time_call_keeps_the_launch_queue_short():
    """512 calls of three launches each: queued as one window they would
    fill the launch queue, and the host would wait there until the sleep
    ended, which reads as a stall; in windows of ``CALLS_PER_WINDOW`` the
    host stays ahead of every sleep and nothing is timed again."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    a = torch.zeros(256, device="cuda")
    before = ops.time_call_retries
    ops.time_call([lambda: (a + 1).mul_(2).sub_(2)], torch.device("cuda"),
                  512)
    assert ops.time_call_retries == before
