"""Port parity, quantized KV pool: ``repro_torch.kvq`` against
``repro.kvq`` on the same numpy inputs (mirrors tests/test_kvq.py).

* spec validation, codes and scales (bit-identical), pool layout and the
  capacity arithmetic equal the reference's;
* the paged-attention kernel's plain version (what the wrapper runs on CPU
  tensors) and the torch gather-and-dequantize backend each match the
  JAX Pallas kernel (interpret mode) and its jnp reference within
  rtol = atol = 2e-5, the tolerance tests/test_kvq.py allows the
  reference's two routes (the sums inside a dot product run in another
  order), also over views of several chunks, whose partial softmaxes the
  plain version merges as the kernel does;
* the port's engine with ``kv_quant`` gives the JAX engine's greedy tokens
  on the same weights, through either port backend, with preemption too.
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

from repro import kvq as jkvq  # noqa: E402
from repro.kvq import attention as j_attn  # noqa: E402
from repro.kvq.spec import KVQuantSpec as JKVSpec  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.config import ModelConfig as JConfig  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro_torch import convert, kvq  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.kvq import attention as t_attn  # noqa: E402
from repro_torch.kvq.spec import KVQuantSpec  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.serving import Engine, Request  # noqa: E402

CFG = JConfig(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
              d_ff=128, vocab_size=211, max_seq_len=128)
TOL = dict(rtol=2e-5, atol=2e-5)


def _codebook(seed=0):
    rng = np.random.default_rng(seed)
    return tuple([0.0] + sorted(rng.normal(size=15).tolist()))


SPECS = {"kv8": dict(bits=8), "kv4": dict(bits=4),
         "kv4-codebook": dict(bits=4, codebook=_codebook(4))}


@pytest.fixture(scope="module")
def pair():
    jp = JT.init_params(jax.random.PRNGKey(0), CFG)
    tcfg = convert.config_from_jax(CFG)
    return jp, convert.params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                                       device="cpu"), tcfg


# ------------------------------------------------------------ spec
@pytest.mark.parametrize("kw", [
    dict(bits=8), dict(bits=4), dict(bits=4, codebook=_codebook()),
    dict(bits=16), dict(bits=8, codebook=_codebook()),
    dict(bits=4, codebook=(0.0,) * 15),
    dict(bits=4, codebook=(0.5,) + (0.0,) * 15),
], ids=["8", "4", "4cb", "16", "8cb", "short", "entry0"])
def test_spec_validation_matches(kw):
    try:
        want = JKVSpec(**kw)
    except ValueError:
        with pytest.raises(ValueError):
            KVQuantSpec(**kw)
        return
    got = KVQuantSpec(**kw)
    for dh in (32, 33):
        assert got.packed_dim(dh) == want.packed_dim(dh)
    assert (got.qmax, got.codebook_kind, got.codes_per_byte, got.codebook,
            got.describe()) == (want.qmax, want.codebook_kind,
                                want.codes_per_byte, want.codebook,
                                want.describe())
    assert hash(got) == hash(KVQuantSpec(**kw))


# ------------------------------------------------------ codes and scales
@pytest.mark.parametrize("name", list(SPECS))
def test_kv_quantize_bit_identical(name):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 5, 2, 17)).astype(np.float32)
    x[0, 0, 0] = 0.0  # an all-zero row: scale 1
    x[1, 2, 1, :4] = [0.5, -0.5, 1.5, 2.5]  # round-half-even candidates
    codes, scales = kvq.kv_quantize(torch.from_numpy(x),
                                    KVQuantSpec(**SPECS[name]))
    jc, js = jkvq.kv_quantize(jnp.asarray(x), JKVSpec(**SPECS[name]))
    assert codes.dtype == torch.uint8 and scales.dtype == torch.float32
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(scales.numpy(), np.asarray(js))
    back = kvq.kv_dequantize(codes, scales, KVQuantSpec(**SPECS[name]), 17)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jkvq.kv_dequantize(
            jc, js, JKVSpec(**SPECS[name]), 17)))


@pytest.mark.parametrize("bits", [8, 4])
def test_round_trip_exact_on_representable(bits):
    spec = KVQuantSpec(bits)
    rng = np.random.default_rng(1)
    g = rng.integers(-spec.qmax, spec.qmax + 1, size=(4, 6, 2, 8))
    g[..., 0] = spec.qmax  # every row's amax pinned: scale = 0.5 exactly
    x = torch.from_numpy((g * 0.5).astype(np.float32))
    codes, scales = kvq.kv_quantize(x, spec)
    assert torch.equal(kvq.kv_dequantize(codes, scales, spec, 8), x)


@pytest.mark.parametrize("bits", [8, 4])
def test_pack_unpack_bit_identical(bits):
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 16 if bits == 4 else 256,
                         size=(3, 5, 2, 7)).astype(np.uint8)
    packed = kvq.pack_codes(torch.from_numpy(codes), bits)
    np.testing.assert_array_equal(
        packed.numpy(), np.asarray(jkvq.pack_codes(jnp.asarray(codes), bits)))
    np.testing.assert_array_equal(
        kvq.unpack_codes(packed, bits, 7).numpy(), codes)


# ------------------------------------------------------- pool / capacity
def test_pool_layout_and_capacity_match():
    tcfg = convert.config_from_jax(CFG)
    for spec_kw in (None, *SPECS.values()):
        t = None if spec_kw is None else KVQuantSpec(**spec_kw)
        j = None if spec_kw is None else JKVSpec(**spec_kw)
        for tdt, jdt in ((torch.float32, jnp.float32),
                         (torch.bfloat16, jnp.bfloat16)):
            assert kvq.bytes_per_token(tcfg, t, tdt) == \
                jkvq.bytes_per_token(CFG, j, jdt)
            assert kvq.pool_bytes(tcfg, 7, 8, t, tdt) == \
                jkvq.pool_bytes(CFG, 7, 8, j, jdt)
            for budget in (1, 5000, 123457, 10**7):
                assert kvq.blocks_for_bytes(tcfg, budget, 8, t, tdt) == \
                    jkvq.blocks_for_bytes(CFG, budget, 8, j, jdt)
        if t is not None:
            got = kvq.init_kv_pool(t, 5, 8, 2, 17, device="cpu")
            want = jkvq.init_kv_pool(j, 5, 8, 2, 17)
            for name in ("k", "k_scale", "v", "v_scale"):
                assert tuple(got[name].shape) == want[name].shape
                assert str(got[name].dtype).removeprefix("torch.") == \
                    str(want[name].dtype)
    assert kvq.capacity_table(tcfg, 8) == jkvq.capacity_table(CFG, 8)
    pool = TT.init_paged_cache(tcfg.replace(kv_quant=KVQuantSpec(4)), 5, 8,
                               device="cpu")
    want = JT.init_paged_cache(CFG.replace(kv_quant=JKVSpec(4)), 5, 8)
    for layer in range(CFG.num_layers):
        for name in ("k", "k_scale", "v", "v_scale"):
            assert tuple(pool[layer][name].shape) == \
                want["0:attn"][name].shape[1:]


# ----------------------------------------------- paged-attention kernel
def _attn_case(spec_kw, softcap, window, seed=5):
    """The pool, q and views of tests/test_kvq.py's kernel-parity case."""
    B, C, H, hk, dh, bs, nseq = 2, 4, 4, 2, 16, 8, 3
    nb = 1 + B * nseq
    rng = np.random.default_rng(seed)
    jspec = JKVSpec(**spec_kw)
    kc, ks = jkvq.kv_quantize(jnp.asarray(rng.normal(size=(nb, bs, hk, dh)),
                                          jnp.float32), jspec)
    vc, vs = jkvq.kv_quantize(jnp.asarray(rng.normal(size=(nb, bs, hk, dh)),
                                          jnp.float32), jspec)
    pool = {"k": kc, "k_scale": ks, "v": vc, "v_scale": vs}
    q = rng.normal(size=(B, C, H, dh)).astype(np.float32)
    blocks = np.arange(1, nb).reshape(B, nseq)
    vslots = (blocks[:, :, None] * bs + np.arange(bs)).reshape(B, -1) \
        .astype(np.int32)
    positions = rng.integers(0, nseq * bs, size=(B, C)).astype(np.int32)

    class Cfg:
        num_heads, num_kv_heads, head_dim = H, hk, dh
        attn_logit_softcap = softcap

    tpool = {n: torch.from_numpy(np.array(a)) for n, a in pool.items()}
    return (Cfg, jspec, pool, q, vslots, positions, tpool, blocks)


@pytest.mark.parametrize("name", list(SPECS))
@pytest.mark.parametrize("softcap,window", [(0.0, 0), (5.0, 0), (0.0, 7)])
def test_plain_and_torch_backend_match_pallas_and_jnp(name, softcap,
                                                      window):
    Cfg, jspec, pool, q, vslots, positions, tpool, blocks = _attn_case(
        SPECS[name], softcap, window)
    args = (jnp.asarray(q), pool, jnp.asarray(vslots),
            jnp.asarray(positions))
    pallas = np.asarray(j_attn.run_pallas(jspec, Cfg, *args, window=window))
    ref = np.asarray(j_attn.run_jnp(jspec, Cfg, *args, window=window))
    spec = KVQuantSpec(**SPECS[name])
    targs = (torch.from_numpy(q), tpool, torch.from_numpy(vslots),
             torch.from_numpy(positions))
    before = pa.launches
    via_kernel_backend = t_attn.run_cuda(spec, Cfg, *targs, window=window)
    torch_backend = t_attn.run_torch(spec, Cfg, *targs, window=window)
    assert pa.launches == before  # CPU tensors: the plain version
    cb = None if spec.codebook is None else torch.tensor(spec.codebook)
    plain = pa.paged_attention_plain(
        torch.from_numpy(q), tpool["k"], tpool["k_scale"], tpool["v"],
        tpool["v_scale"], torch.from_numpy(blocks.astype(np.int32)),
        torch.from_numpy(positions), bits=spec.bits, codebook=cb,
        block_size=8, window=window, softcap=softcap)
    B, C, H, dh = q.shape
    assert torch.equal(plain.reshape(B, C, H * dh), via_kernel_backend)
    for got in (via_kernel_backend, torch_backend):
        np.testing.assert_allclose(got.numpy(), pallas, **TOL)
        np.testing.assert_allclose(got.numpy(), ref, **TOL)


def test_plain_bf16_q_and_early_end():
    """bf16 queries give bf16 output; blocks past every query position
    change nothing (the walk's early end is exact)."""
    Cfg, jspec, pool, q, vslots, positions, tpool, blocks = _attn_case(
        SPECS["kv8"], 0.0, 0, seed=9)
    spec = KVQuantSpec(8)
    positions = np.minimum(positions, 9)  # only blocks 0 and 1 reachable
    kw = dict(bits=8, block_size=8)
    qb = torch.from_numpy(q).to(torch.bfloat16)
    pargs = (tpool["k"], tpool["k_scale"], tpool["v"], tpool["v_scale"])
    full = pa.paged_attention_plain(
        qb, *pargs, torch.from_numpy(blocks.astype(np.int32)),
        torch.from_numpy(positions), **kw)
    short = pa.paged_attention_plain(
        qb, *pargs, torch.from_numpy(blocks[:, :2].astype(np.int32)),
        torch.from_numpy(positions), **kw)
    assert full.dtype == torch.bfloat16 and torch.equal(full, short)
    want = j_attn.run_jnp(jspec, Cfg, jnp.asarray(qb.float().numpy(),
                                                  jnp.bfloat16),
                          pool, jnp.asarray(vslots), jnp.asarray(positions))
    np.testing.assert_allclose(
        full.float().numpy().reshape(want.shape),
        np.asarray(want.astype(jnp.float32)), rtol=2**-7, atol=2**-7)


# views split into chunks of the kernel's fixed length (pa.CHUNK = 128
# view slots, and 16): (name, window, positions of the two rows)
CHUNK_CASES = [
    ("straddle", 0, [[120, 135, 159], [3, 70, 140]]),
    ("window-past-chunk-0", 20, [[150, 155, 159], [140, 141, 158]]),
    ("later-chunks-empty", 0, [[2, 9, 15], [100, 130, 159]]),
]


@pytest.mark.parametrize("name,window,positions", CHUNK_CASES,
                         ids=[c[0] for c in CHUNK_CASES])
def test_plain_chunks_match_pallas_and_jnp(name, window, positions):
    """The plain version's chunked softmax and combine against the JAX
    package's Pallas kernel (interpret mode) and its jnp reference over a
    160-slot view: across a chunk boundary, with a row whose window starts
    past chunk 0 (so that chunk is skipped), and with a row whose later
    chunks are empty; at the default chunk and at 16 slots."""
    B, C, H, hk, dh, bs, nseq = 2, 3, 4, 2, 16, 8, 20
    nb = 1 + B * nseq
    rng = np.random.default_rng(len(name))
    jspec = JKVSpec(8)
    kc, ks = jkvq.kv_quantize(jnp.asarray(rng.normal(size=(nb, bs, hk, dh)),
                                          jnp.float32), jspec)
    vc, vs = jkvq.kv_quantize(jnp.asarray(rng.normal(size=(nb, bs, hk, dh)),
                                          jnp.float32), jspec)
    pool = {"k": kc, "k_scale": ks, "v": vc, "v_scale": vs}
    q = rng.normal(size=(B, C, H, dh)).astype(np.float32)
    blocks = rng.permutation(np.arange(1, nb)).reshape(B, nseq)
    vslots = (blocks[:, :, None] * bs + np.arange(bs)).reshape(B, -1) \
        .astype(np.int32)
    pos = np.asarray(positions, dtype=np.int32)

    class Cfg:
        num_heads, num_kv_heads, head_dim = H, hk, dh
        attn_logit_softcap = 10.0

    args = (jnp.asarray(q), pool, jnp.asarray(vslots), jnp.asarray(pos))
    pallas = np.asarray(j_attn.run_pallas(jspec, Cfg, *args, window=window))
    ref = np.asarray(j_attn.run_jnp(jspec, Cfg, *args, window=window))
    tpool = {n: torch.from_numpy(np.array(a)) for n, a in pool.items()}
    targs = (torch.from_numpy(q), tpool["k"], tpool["k_scale"], tpool["v"],
             tpool["v_scale"], torch.from_numpy(blocks.astype(np.int32)),
             torch.from_numpy(pos))
    lo, hi, _ = pa.live_chunks(torch.from_numpy(pos), block_size=bs,
                               nseq=nseq, window=window, chunk=16)
    if name == "window-past-chunk-0":
        assert int(lo.min()) > 0
    if name == "later-chunks-empty":
        assert int(hi[0]) == 1 and int(hi[1]) == 10
    for chunk in (pa.CHUNK, 16):
        got = pa.paged_attention_plain(
            *targs, bits=8, block_size=bs, window=window, softcap=10.0,
            chunk=chunk).reshape(B, C, H * dh).numpy()
        np.testing.assert_allclose(got, pallas, **TOL)
        np.testing.assert_allclose(got, ref, **TOL)


def test_chunk_partials_and_rows_per_block():
    """A chunk a row does not need adds exactly 0: cutting the block table
    to the blocks the positions reach gives the same bits at chunk 16 as
    the full table; the kernel's rows per block fill the card where the
    grid allows and fit its shared memory."""
    Cfg, jspec, pool, q, vslots, positions, tpool, blocks = _attn_case(
        SPECS["kv4"], 5.0, 0, seed=3)
    positions = np.minimum(positions, 15)  # chunk 0 (blocks 0, 1) only
    kw = dict(bits=4, block_size=8, chunk=16, softcap=5.0)
    pargs = (tpool["k"], tpool["k_scale"], tpool["v"], tpool["v_scale"])
    qt = torch.from_numpy(q)
    full = pa.paged_attention_plain(
        qt, *pargs, torch.from_numpy(blocks.astype(np.int32)),
        torch.from_numpy(positions), **kw)
    short = pa.paged_attention_plain(
        qt, *pargs, torch.from_numpy(blocks[:, :2].astype(np.int32)),
        torch.from_numpy(positions), **kw)
    assert torch.equal(full, short)
    with pytest.raises(ValueError, match="multiple of 16"):
        pa.paged_attention_plain(qt, *pargs,
                                 torch.from_numpy(blocks.astype(np.int32)),
                                 torch.from_numpy(positions), bits=4,
                                 block_size=8, chunk=24)
    # gemma-2b decode (8 heads on 1, 4 rows, 1 chunk): one row a block;
    # 8 rows of a 4096-slot view (32 chunks): 8 rows a block
    assert pa.rows_per_block(8, 1 * 1 * 4) == 1
    assert pa.rows_per_block(8, 32 * 1 * 8) == 8
    assert pa.rows_per_block(2, 32 * 8 * 4) == 2
    assert pa.rows_per_block(3, 10**4) == 4
    for bits, dhp in ((8, 256), (4, 128)):
        for rb in (1, 2, 4, 8):
            assert pa.smem_bytes(dhp, bits, pa.CHUNK, rb) <= pa.MAX_SMEM


def test_wrapper_routes_by_device_without_fallback():
    Cfg, jspec, pool, q, vslots, positions, tpool, blocks = _attn_case(
        SPECS["kv8"], 0.0, 0)
    args = (torch.from_numpy(q), tpool["k"], tpool["k_scale"], tpool["v"],
            tpool["v_scale"], torch.from_numpy(blocks.astype(np.int32)),
            torch.from_numpy(positions))
    kw = dict(bits=8, block_size=8)
    with pytest.raises(ValueError, match="CUDA"):
        pa.paged_attention_cuda(*args, **kw)
    with pytest.raises(ValueError, match="unsupported device"):
        pa.paged_attention(*(a.to("meta") for a in args), **kw)
    with pytest.raises(ValueError, match="block size"):
        pa.paged_attention_plain(*args, bits=8, block_size=4)
    with pytest.raises(ValueError, match="packed head dim"):
        pa.paged_attention_plain(*args, bits=4, block_size=8)


def test_backend_selection_and_dequant_bytes():
    assert t_attn.select(KVQuantSpec(8), "cpu") == "paged_attn_torch"
    assert t_attn.select(KVQuantSpec(8), "cuda") == "paged_attn_cuda"
    assert t_attn.select(KVQuantSpec(4, codebook=_codebook()), "cuda") == \
        "paged_attn_cuda"
    assert t_attn.select(KVQuantSpec(8, backend="paged_attn_cuda"),
                         "cpu") == "paged_attn_cuda"
    with pytest.raises(ValueError):
        t_attn.select(KVQuantSpec(8, backend="msgemm_cuda"))
    tcfg = convert.config_from_jax(CFG)
    assert t_attn.dequant_hbm_bytes(KVQuantSpec(8), tcfg, 4, 64) == 0
    assert t_attn.dequant_hbm_bytes(KVQuantSpec(8), tcfg, 4, 64, "cpu") == \
        j_attn.dequant_hbm_bytes(JKVSpec(8, backend="paged_attn_jnp"),
                                 CFG, 4, 64)
    # the config bridge carries kv_quant and maps the backend names
    got = convert.config_from_jax(CFG.replace(kv_quant=JKVSpec(
        4, codebook=_codebook(), backend="paged_attn_pallas"))).kv_quant
    assert got == KVQuantSpec(4, codebook=_codebook(),
                              backend="paged_attn_cuda")


# ------------------------------------------------------ model and engine
def test_forward_paged_quantized_matches_jax(pair):
    """A prefill chunk then a decode step: logits and the in-place pool's
    codes and scales match the reference's scattered copies."""
    jp, model, tcfg = pair
    spec = SPECS["kv4"]
    jcfg = CFG.replace(kv_quant=JKVSpec(**spec))
    tcfg = tcfg.replace(kv_quant=KVQuantSpec(**spec))
    nb, bs, W = 5, 4, 8
    jpool = JT.init_paged_cache(jcfg, nb, bs)
    tpool = TT.init_paged_cache(tcfg, nb, bs, device="cpu")
    view = (np.array([2, 1])[:, None] * bs + np.arange(bs)).reshape(1, W) \
        .astype(np.int32)
    toks = np.random.default_rng(2).integers(0, CFG.vocab_size,
                                             size=(1, 6)).astype(np.int32)
    for start, chunk in ((0, toks), (6, toks[:, -1:])):
        pos = (start + np.arange(chunk.shape[1], dtype=np.int32))[None]
        args = (chunk, pos, view[:, pos[0]], view)
        want, jpool = JT.forward_paged(jp, jcfg, *map(jnp.asarray, args[:1]),
                                       jpool, *map(jnp.asarray, args[1:]))
        with torch.no_grad():
            got, tpool = TT.forward_paged(model, tcfg,
                                          torch.from_numpy(chunk), tpool,
                                          *map(torch.from_numpy, args[1:]))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-4)
    for name in ("k", "v", "k_scale", "v_scale"):
        w = np.asarray(jpool["0:attn"][name])
        for layer in range(CFG.num_layers):
            g = tpool[layer][name].numpy()
            if name.endswith("scale"):
                np.testing.assert_allclose(g, w[layer], rtol=1e-5)
            else:  # codes: at most one grid step apart (f32 rounding)
                assert np.mean(g == w[layer]) > 0.97


def _prompts(lens, seed):
    rng = np.random.default_rng(seed)
    return [tuple(int(t) for t in rng.integers(0, CFG.vocab_size, size=L))
            for L in lens]


def _serve(engine_cls, req_cls, params, cfg, prompts, new=6, **kw):
    kw.setdefault("max_slots", 3)
    kw.setdefault("block_size", 4)
    kw.setdefault("prefill_chunk", 4)
    kw.setdefault("max_model_len", 64)
    eng = engine_cls(params, cfg, **kw)
    res = eng.run([req_cls(rid=i, prompt=p, max_new_tokens=new)
                   for i, p in enumerate(prompts)])
    return eng, [res[i].generated for i in range(len(prompts))]


@pytest.mark.parametrize("name,backend,lens,kw", [
    ("kv8", None, (5, 11, 3, 8), {}),
    ("kv8", "paged_attn_cuda", (5, 11, 3, 8), {}),
    ("kv4", None, (7, 12), {}),
    ("kv4", "paged_attn_cuda", (7, 12), {}),
    ("kv4-codebook", "paged_attn_cuda", (6, 9), {}),
    ("kv8", "paged_attn_cuda", (6, 6),
     dict(new=10, max_slots=2, prefill_chunk=8, max_model_len=16,
          num_blocks=7)),
], ids=["kv8-torch", "kv8-kernel-plain", "kv4-torch", "kv4-kernel-plain",
        "kv4cb-kernel-plain", "kv8-preempt"])
def test_engine_tokens_match_jax_engine(pair, name, backend, lens, kw):
    jp, model, tcfg = pair
    kw = dict(kw)
    prompts = _prompts(lens, seed=sum(lens))
    spec = KVQuantSpec(**SPECS[name], backend=backend)
    before = pa.launches
    eng, got = _serve(Engine, Request, model, tcfg, prompts,
                      kv_quant=spec, **kw)
    _, want = _serve(JEngine, JRequest, jp, CFG, prompts,
                     kv_quant=JKVSpec(**SPECS[name]), **kw)
    assert got == want
    assert pa.launches == before  # CPU: no kernel launch
    assert eng.cfg.kv_quant == spec and "k_scale" in eng.kv[0]
    if "num_blocks" in kw:
        assert eng.scheduler.num_preemptions > 0
    assert eng.pool.free_blocks == eng.pool.capacity


def test_kv_pool_bytes_gives_jax_block_count(pair):
    jp, model, tcfg = pair
    budget = 16 * 4 * jkvq.bytes_per_token(CFG, None)
    for spec_kw in (None, SPECS["kv8"], SPECS["kv4"]):
        t = None if spec_kw is None else KVQuantSpec(**spec_kw)
        j = None if spec_kw is None else JKVSpec(**spec_kw)
        eng = Engine(model, tcfg, block_size=4, max_model_len=64,
                     kv_quant=t, kv_pool_bytes=budget)
        want = jkvq.blocks_for_bytes(CFG, budget, 4, j)
        assert eng.pool.num_blocks == want
    assert want >= 2 * jkvq.blocks_for_bytes(CFG, budget, 4, None)
