"""Port parity, the encoder-decoder and the stub frontends: whisper-medium
(an encoder of non-causal blocks over precomputed frames, a cross
attention in every decoder block, learned decoder positions) and
phi-3-vision-4.2b (patch embeddings prepended to the text), held against
the JAX package on the reference's SMOKE weights (through ``convert``)
and numpy inputs.

* ``_sinusoidal`` within 1e-6 (S = 12 and 1500 at d = 1024);
  ``causal_mask(offset=)`` is the reference's ``_chunk_mask``;
* ``encode`` within 1e-5, dense and msgemm; ``cross_kv`` and
  ``cross_attn_apply`` within 1e-5;
* ``convert`` maps every reference leaf, and ``port_path`` the encoder's;
* both SMOKE models: ``forward`` logits, ``prefill`` + ``decode_step``
  logits within 1e-4 of the reference's and of the port's own
  ``forward``, static ``generate``'s greedy tokens equal to the
  reference's (msgemm and int4_dequant weights); the cross cache at the
  frames' length; a decoder position past ``max_seq_len`` raises;
* ``SyntheticStream.host_batch`` equals the reference's for both
  frontends; the paged pool and the serve CLI's continuous engine refuse
  both models; the CLI's static engine serves both on the CPU.
"""

import functools

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
from repro.data.pipeline import DataConfig as JDataConfig  # noqa: E402
from repro.data.pipeline import SyntheticStream as JStream  # noqa: E402
from repro.models import layers as j_layers  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.quant import quantize_model as j_quantize  # noqa: E402
from repro.runtime import serve as JSV  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticStream  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.runtime import serve as TSV  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
SPECS = {"msgemm": dict(mode="msgemm", d=3, scale_block=36),
         "int4_dequant": dict(mode="int4_dequant", d=3, scale_block=36,
                              storage="packed_u8")}
ARCHS = ["whisper_medium", "phi3_vision"]
SRC = 12  # frames of the whisper batches (SMOKE's max_source_len is 32)


@functools.lru_cache(maxsize=None)
def _pair(arch, quant="msgemm"):
    """The reference's SMOKE params (quantized unless ``quant`` is None),
    the port's model converted from them, and both configs."""
    jcfg = j_configs.get_smoke(arch)
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    if quant is not None:
        spec = JSpec(**SPECS[quant])
        jp = jax.jit(lambda p: j_quantize(p, jcfg, spec))(jp)
        jcfg = jcfg.replace(quant=spec)
    tcfg = convert.config_from_jax(jcfg)
    model = convert.params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                                    device="cpu")
    return jp, jcfg, model, tcfg


def _batch(cfg, B, T, seed=1):
    """numpy inputs: tokens (B, T), and the frontend's embeddings."""
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab_size,
                                size=(B, T)).astype(np.int32)}
    if cfg.is_encdec:
        b["frames"] = rng.normal(size=(B, SRC, cfg.d_model)).astype(
            np.float32)
    elif cfg.frontend == "image_patches":
        b["patch_embeds"] = rng.normal(
            size=(B, cfg.num_patches, cfg.d_model)).astype(np.float32)
    return b


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _extra(cfg):
    return cfg.num_patches if cfg.frontend == "image_patches" else 0


# ---------------------------------------------------------- encoder pieces
@pytest.mark.parametrize("S", [12, 1500])
def test_sinusoidal_matches_reference(S):
    """Within 1e-6 wherever the two packages' f32 ``exp`` round a column
    pair's rate alike.  XLA's CPU ``exp`` is one ulp off the correctly
    rounded value at 54 of the 512 rates (torch's at 3), so there the
    angles pos x rate differ by pos x one ulp (1.2e-4 rad at pos 1499)
    before their own rounding, and the table by no more than twice
    that."""
    d = 1024
    got = TT._sinusoidal(S, d).numpy()
    want = np.asarray(JT._sinusoidal(S, d))
    assert got.dtype == np.float32 and got.shape == (S, d)
    x = np.asarray(jnp.arange(0, d, 2) * (-jnp.log(10000.0) / (d // 2 - 1)))
    j_rate = np.asarray(jnp.exp(jnp.asarray(x)))
    t_rate = torch.exp(torch.from_numpy(x.copy())).numpy()
    same = np.repeat(j_rate == t_rate, 2)
    np.testing.assert_allclose(got[:, same], want[:, same], rtol=1e-6,
                               atol=1e-6)
    assert np.abs(j_rate - t_rate).max() <= np.spacing(j_rate).max()
    bound = 2 * (S - 1) * np.repeat(np.spacing(j_rate), 2)[~same] + 1e-6
    assert (np.abs(got - want)[:, ~same] <= bound).all()


@pytest.mark.parametrize("window", [0, 5])
def test_causal_mask_offset_is_chunk_mask(window):
    for C, Skv, off in ((4, 16, 0), (4, 16, 8), (3, 9, 6)):
        want = np.asarray(j_layers._chunk_mask(C, Skv, window, off))
        got = layers.causal_mask(C, Skv, window=window, offset=off)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("quant", [None, "msgemm"], ids=["dense", "msgemm"])
def test_encode_matches_reference(quant):
    jp, jcfg, model, tcfg = _pair("whisper_medium", quant)
    frames = _batch(tcfg, 2, 1)["frames"]
    want = JT.encode(jp, jcfg, jnp.asarray(frames))
    got = TT.encode(model, tcfg, torch.from_numpy(frames))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_cross_kv_and_cross_attention_match_reference():
    jp, jcfg, model, tcfg = _pair("whisper_medium")
    rng = np.random.default_rng(3)
    enc = rng.normal(size=(2, SRC, tcfg.d_model)).astype(np.float32)
    x = rng.normal(size=(2, 5, tcfg.d_model)).astype(np.float32)
    res = rng.normal(size=(2, 5, tcfg.d_model)).astype(np.float32)
    jc = jax.tree.map(lambda a: a[1], jp["blocks"]["0:attn"]["cross"])
    tc = model.blocks[1].cross
    wk, wv = j_layers.cross_kv(jc, jcfg, jnp.asarray(enc))
    gk, gv = layers.cross_kv(tc, tcfg, torch.from_numpy(enc))
    for g, w in ((gk, wk), (gv, wv)):
        assert tuple(g.shape) == (2, SRC, tcfg.num_kv_heads, tcfg.head_dim)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    positions = jnp.broadcast_to(jnp.arange(5), (2, 5))
    want = j_layers.cross_attn_apply(jc, jcfg, jnp.asarray(x), wk, wv,
                                     positions, residual=jnp.asarray(res))
    got = layers.cross_attn_apply(tc, tcfg, torch.from_numpy(x), gk, gv,
                                  residual=torch.from_numpy(res))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ------------------------------------------------------------------ convert
def _leaves(tree):
    """(path, array) of every reference leaf, path '/'-joined."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [("/".join(str(k.key) for k in path), leaf)
            for path, leaf in flat]


@pytest.mark.parametrize("quant", [None, "msgemm"], ids=["dense", "msgemm"])
@pytest.mark.parametrize("arch", ARCHS)
def test_convert_maps_every_leaf(arch, quant):
    """Every leaf of the reference's tree (each slice of a stacked one)
    lands on a buffer of the port's model with its values, through
    ``port_path``, and the port has no other buffer."""
    jp, jcfg, model, tcfg = _pair(arch, quant)
    bufs = dict(model.named_buffers())
    seen = set()
    for path, leaf in _leaves(jp):
        stacked = "blocks" in path.split("/")[:2]
        for g in range(leaf.shape[0] if stacked else 1):
            mod, _, name = path.rpartition("/")
            key = ".".join([convert.port_path(mod, g, tcfg), name] if mod
                           else [name])
            assert key in bufs, key
            np.testing.assert_array_equal(
                bufs[key].numpy(), np.asarray(leaf[g] if stacked else leaf))
            seen.add(key)
    assert seen == set(bufs)
    if tcfg.is_encdec:
        assert convert.port_path("encoder/blocks/0:attn/attn/wq", 1,
                                 tcfg) == "encoder.blocks.1.attn.wq"
        assert len(model.encoder.blocks) == tcfg.encoder_layers


# --------------------------------------------------------- the SMOKE models
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_reference(arch):
    jp, jcfg, model, tcfg = _pair(arch)
    b = _batch(tcfg, 2, 7)
    want, _ = JT.forward(jp, jcfg, _j(b))
    got = TT.forward(model, tcfg, _t(b))
    assert tuple(got.shape) == (2, 7 + _extra(tcfg), tcfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_logits_match_reference_and_forward(arch):
    """A 6-token prefill and 3 decode steps: the logits of each within
    1e-4 of the reference's and of the port's own ``forward`` over the 9
    tokens (the patches ahead of them shift every position by P)."""
    jp, jcfg, model, tcfg = _pair(arch)
    B, S, T, P = 2, 6, 9, _extra(tcfg)
    b = _batch(tcfg, B, T)
    full = TT.forward(model, tcfg, _t(b))
    pb = dict(b, tokens=b["tokens"][:, :S])
    jcache = JT.init_cache(jcfg, B, P + T)
    jl, jcache = JT.prefill(jp, jcfg, _j(pb), jcache)
    cache = TSV.init_cache(tcfg, B, P + T, device="cpu")
    logits, cache = TSV.prefill_step(model, tcfg, _t(pb), cache)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **LOGIT_TOL)
    np.testing.assert_allclose(logits.numpy(), full[:, P + S - 1].numpy(),
                               **LOGIT_TOL)
    if tcfg.is_encdec:  # prefill replaced the cross K/V by the source's
        assert cache[0]["cross_k"].shape[1] == SRC
        assert jcache["0:attn"]["cross_k"].shape[2] == SRC
    for t in range(S, T):
        tok = b["tokens"][:, t]
        pos = np.full((B,), P + t, np.int32)
        jl, jcache = JT.decode_step(jp, jcfg, jnp.asarray(tok), jcache,
                                    jnp.asarray(pos))
        logits, cache = TSV.decode_step(model, tcfg, torch.from_numpy(tok),
                                        cache, torch.from_numpy(pos))
        np.testing.assert_allclose(logits.numpy(), np.asarray(jl),
                                   **LOGIT_TOL)
        np.testing.assert_allclose(logits.numpy(), full[:, P + t].numpy(),
                                   **LOGIT_TOL)


@pytest.mark.parametrize("quant", ["msgemm", "int4_dequant"])
@pytest.mark.parametrize("arch", ARCHS)
def test_generate_tokens_match_reference(arch, quant):
    jp, jcfg, model, tcfg = _pair(arch, quant)
    b = _batch(tcfg, 2, 5, seed=2)
    want = JSV.generate(jp, jcfg, _j(b), max_new_tokens=6)
    got = TSV.generate(model, tcfg, _t(b), max_new_tokens=6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_generate_sizes_the_cross_cache_at_the_source(monkeypatch):
    """``generate`` allocates the cross K/V at the frames' length, not at
    ``max_source_len`` (the reference's 32 at SMOKE, 32768 at full
    width), and the tokens are the reference's."""
    jp, jcfg, model, tcfg = _pair("whisper_medium")
    assert tcfg.max_source_len == 32
    made = []
    init = TSV.init_cache

    def spy(cfg, *a, **kw):
        cache = init(cfg, *a, **kw)
        made.append(cache)
        return cache

    monkeypatch.setattr(TSV, "init_cache", spy)
    b = _batch(tcfg, 2, 4)
    got = TSV.generate(model, tcfg, _t(b), max_new_tokens=3)
    assert len(made) == 1 and len(made[0]) == tcfg.num_layers
    for layer in made[0]:
        assert tuple(layer["cross_k"].shape) == (
            2, SRC, tcfg.num_kv_heads, tcfg.head_dim)
        assert tuple(layer["k"].shape)[1] == 4 + 3
    want = JSV.generate(jp, jcfg, _j(b), max_new_tokens=3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", ARCHS)
def test_static_cache_sizes_and_first_position(arch):
    """``static_cache``, the one place the static path sizes its cache:
    the first decode position counts the patches, the self cache holds
    prompt, patches and new tokens, and the cross K/V hold the frames."""
    _, _, _, tcfg = _pair(arch)
    b = _t(_batch(tcfg, 2, 5))
    cache, pos0 = TSV.static_cache(tcfg, b, 3)
    assert pos0 == 5 + _extra(tcfg)
    assert len(cache) == tcfg.num_layers
    for layer in cache:
        assert tuple(layer["k"].shape)[:2] == (2, pos0 + 3)
        if tcfg.is_encdec:
            assert tuple(layer["cross_k"].shape)[:2] == (2, SRC)
        else:
            assert "cross_k" not in layer


def test_decoder_positions_past_max_seq_len_raise():
    """whisper SMOKE has 64 learned decoder positions: decoding at 64 with
    host positions, or a forward or generate that would reach it, raises
    ValueError (the reference reads NaN rows there).  ``generate`` checks
    its last decode position once, before the prefill, so a generation
    whose last decode position is 63 runs."""
    jp, jcfg, model, tcfg = _pair("whisper_medium")
    L = tcfg.max_seq_len
    b = _t(_batch(tcfg, 1, L))
    cache = TSV.init_cache(tcfg, 1, L + 1, device="cpu")
    TSV.prefill_step(model, tcfg, b, cache)  # positions 0..L-1: fine
    with pytest.raises(ValueError, match="past the 64 learned positions"):
        TSV.decode_step(model, tcfg, b["tokens"][:, 0], cache,
                        torch.tensor([L]))
    long = _t(_batch(tcfg, 1, L + 1))
    with pytest.raises(ValueError, match="learned positions"):
        TT.forward(model, tcfg, long)
    with pytest.raises(ValueError, match="past the 64 learned positions"):
        TSV.generate(model, tcfg, b, max_new_tokens=2)
    with pytest.raises(ValueError, match="position 64 past"):
        TSV.static_cache(tcfg, b, 2)
    short = _t(_batch(tcfg, 1, L - 1))
    assert tuple(TSV.generate(model, tcfg, short,
                              max_new_tokens=2).shape) == (1, 2)


# --------------------------------------------------- data, refusals, the CLI
@pytest.mark.parametrize("frontend", ["audio_frames", "image_patches"])
def test_host_batch_matches_reference(frontend):
    kw = dict(vocab_size=512, seq_len=9, global_batch=3, seed=4,
              frontend=frontend, d_model=16, num_frames=5, num_patches=4)
    want = JStream(JDataConfig(**kw)).host_batch(2)
    got = SyntheticStream(DataConfig(**kw)).host_batch(2)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_serving_refused(arch):
    jp, jcfg, model, tcfg = _pair(arch)
    with pytest.raises(NotImplementedError, match="decoder-only"):
        JT.init_paged_cache(jcfg, 4, 8)
    with pytest.raises(NotImplementedError, match="decoder-only"):
        TT.init_paged_cache(tcfg, 4, 8, device="cpu")
    with pytest.raises(NotImplementedError, match="decoder-only"):
        serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                    "--engine", "continuous"])


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_static(arch):
    """The serve CLI's static engine on a SMOKE model: ``generate``'s
    tokens on the CLI's own inputs (prompts, then the stub frames or
    patches from the same seed), no kernel launched on the CPU."""
    out = serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                      "--engine", "static", "--batch", "2",
                      "--prompt-len", "6", "--new-tokens", "4"])
    cfg, batch = out["cfg"], out["batch"]
    if cfg.is_encdec:
        assert tuple(batch["frames"].shape) == (2, 16, cfg.d_model)
    else:
        assert tuple(batch["patch_embeds"].shape) == (
            2, cfg.num_patches, cfg.d_model)
    assert tuple(out["tokens"].shape) == (2, 4)
    ref = TSV.generate(out["params"], cfg, batch, max_new_tokens=4)
    assert torch.equal(out["tokens"], ref)
    assert all(n == 0 for n in out["launches"].values())
