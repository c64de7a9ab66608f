"""Port parity, calibration: ``repro_torch.calib`` (codebooks, statistics,
fitting, ``calibrate``, the quality harness), the synthetic stream and
the loss it needs, the calibration observer's tags, and the torch
dequantize and produce/consume backends — against ``repro.calib`` and
the reference's ``int4_jnp`` / ``msgemm_jnp`` on the same numpy inputs,
at the reference's own calibration config (2 layers, d_model 64, vocab
211, ``tests/test_calib.py``).

Tolerances, each stated where it is used: codes and round trips are
bit-exact; fitted codebooks and scales within 1e-6 (the port fits in
torch float64, the reference in numpy float64: sums in another order,
then cast to float32); moments and Hessians within 1e-5 relative (each
call's float32 sums are taken in another order); weighted errors within
1e-5 relative (float32 reductions); logits within 1e-4 (as
``tests/test_torch_model.py``).
"""

import dataclasses
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

from repro import calib as jcalib  # noqa: E402
from repro import dispatch as jdispatch  # noqa: E402
from repro.calib.codebook import Codebook as JCodebook  # noqa: E402
from repro.core import linear as jlinear  # noqa: E402
from repro.core import scales as jscales  # noqa: E402
from repro.core.spec import QuantSpec as JSpec  # noqa: E402
from repro.data.pipeline import DataConfig as JDataConfig  # noqa: E402
from repro.data.pipeline import SyntheticStream as JStream  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.config import ModelConfig as JModelConfig  # noqa: E402
from repro.runtime.train import cross_entropy as j_ce  # noqa: E402
from repro_torch import calib, convert, dispatch  # noqa: E402
from repro_torch.calib.codebook import Codebook, uniform_values  # noqa: E402
from repro_torch.core import linear as tlinear  # noqa: E402
from repro_torch.core import scales as tscales  # noqa: E402
from repro_torch.core.spec import QuantSpec as TSpec  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticStream  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.runtime import serve as TSV  # noqa: E402
from repro_torch.runtime.train import IGNORE, cross_entropy  # noqa: E402
from repro_torch.serving import Engine, Request  # noqa: E402

FIT_TOL = dict(rtol=1e-6, atol=1e-6)
MOMENT_TOL = dict(rtol=1e-5, atol=0)
ERR_TOL = dict(rtol=1e-5, atol=0)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
QUANT = dict(mode="msgemm", d=3, scale_block=36)

CFG = JModelConfig(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                   d_ff=128, vocab_size=211, max_seq_len=128)
# a two-kind pattern, two groups: model-scope pooling must stack layers
# i, i+2 of each kind as the reference's scan groups do
CFG2 = CFG.replace(num_layers=4, block_pattern=("local", "attn"),
                   sliding_window=8)
DATA = dict(vocab_size=211, seq_len=32, global_batch=4)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


def _rand_codebook(rng):
    return np.concatenate([[0.0], np.sort(rng.standard_normal(15) * 5)]) \
        .astype(np.float32)


def _pair(jcfg, seed=0):
    """(reference params, port model, port cfg) from one seed."""
    jp = JT.init_params(jax.random.PRNGKey(seed), jcfg)
    tcfg = convert.config_from_jax(jcfg)
    return jp, convert.params_from_jax(_np_tree(jp), tcfg, device="cpu"), \
        tcfg


@pytest.fixture(scope="module")
def dense():
    return _pair(CFG)


# ------------------------------------------------------------- data, loss
@pytest.mark.parametrize("mode", ["lcg", "uniform"])
def test_synthetic_stream_matches_reference(mode):
    """Pure numpy on both sides: the same tokens and labels, bit-exact."""
    want = JStream(JDataConfig(**DATA, seed=3, mode=mode))
    got = SyntheticStream(DataConfig(**DATA, seed=3, mode=mode))
    for step in (0, 5):
        a, b = want.host_batch(step), got.host_batch(step)
        assert a.keys() >= b.keys() == {"tokens", "labels"}
        for key in b:
            assert b[key].dtype == a[key].dtype
            np.testing.assert_array_equal(b[key], a[key])


def test_cross_entropy_matches_reference():
    """Masked CE and z-loss, IGNORE labels excluded: within 1e-6."""
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((2, 5, 11)) * 3).astype(np.float32)
    labels = rng.integers(0, 11, (2, 5)).astype(np.int32)
    labels[0, 1] = labels[1, 4] = IGNORE
    want = j_ce(jnp.asarray(logits), jnp.asarray(labels))
    got = cross_entropy(_t(logits), _t(labels))
    for w, g in zip(want, got):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-6)


# ------------------------------------------------------------- codebook
def test_uniform_codebook_is_degenerate_case():
    """quantize_codebook on the uniform table == quantize_int4 == the
    reference's codes, bit-exact."""
    w = np.random.default_rng(0).standard_normal((9, 24)).astype(np.float32)
    qa = tscales.quantize_int4(_t(w), 12)
    qb = tscales.quantize_codebook(_t(w), uniform_values(), 12)
    assert torch.equal(qa.codes, qb.codes)
    assert torch.equal(tscales.dequantize(qa), tscales.dequantize(qb))
    np.testing.assert_array_equal(uniform_values().numpy(),
                                  jcalib.uniform_values())
    want = jscales.quantize_int4(jnp.asarray(w), 12)
    np.testing.assert_array_equal(qa.codes.numpy(), np.asarray(want.codes))
    assert Codebook.uniform_int4().is_uniform


def test_codebook_round_trips_match_reference():
    """encode(decode(codes)) == codes; from_centroids pins 0 and sorts as
    the reference; basis is the reference's; check refuses a table
    without a zero at code 0.  All bit-exact."""
    rng = np.random.default_rng(1)
    vals = _rand_codebook(rng)
    cb = Codebook(values=_t(vals)).check()
    codes = rng.integers(0, 16, size=(7, 13)).astype(np.uint8)
    assert torch.equal(cb.encode(cb.decode(_t(codes))), _t(codes))
    z = rng.standard_normal((5, 6)).astype(np.float32) * 6
    jcb = JCodebook(values=vals)
    np.testing.assert_array_equal(cb.encode(_t(z)).numpy(),
                                  np.asarray(jcb.encode(jnp.asarray(z))))
    np.testing.assert_array_equal(cb.basis(2).numpy(),
                                  np.asarray(jcb.basis(2)))
    cents = [1.5, -2.0, 0.0, 3.0]
    got = Codebook.from_centroids(cents).check()
    np.testing.assert_array_equal(
        got.values.numpy(), JCodebook.from_centroids(cents).values)
    assert float(got.values[0]) == 0.0
    with pytest.raises(ValueError):
        Codebook(values=torch.ones(16)).check()
    with pytest.raises(ValueError):
        Codebook.from_centroids(np.arange(1, 17))


# ------------------------------------------------------------- fitting
@pytest.mark.parametrize("limit", [1 << 20, 1000],
                         ids=["all-samples", "subsampled"])
def test_fit_codebook_matches_reference(limit):
    """Weighted Lloyd from the uniform grid, with and without the seeded
    subsample: values within 1e-6, entry 0 pinned."""
    rng = np.random.default_rng(3)
    z = rng.standard_normal(4096) * 3
    wts = 1 + rng.random(4096)
    want = jcalib.fit_codebook(z, wts, iters=20, sample_limit=limit, seed=5)
    got = calib.fit_codebook(z, wts, iters=20, sample_limit=limit, seed=5,
                             device="cpu")
    assert got.dtype == torch.float32 and float(got[0]) == 0.0
    np.testing.assert_allclose(got.numpy(), want, **FIT_TOL)


@pytest.mark.parametrize("candidates", [0, 1, 4])
def test_fit_block_scales_matches_reference(candidates):
    """Bounding-box scales and the shrink search, activation-weighted on a
    ragged k: scales within 1e-6, padded blocks exact."""
    rng = np.random.default_rng(4)
    w = rng.standard_normal((6, 40))
    cw = 0.5 + rng.random(40)
    vals = _rand_codebook(rng) / 2
    want = jcalib.fit_block_scales(w, vals, 12, cw, candidates=candidates)
    got = calib.fit_block_scales(w, vals, 12, cw, candidates=candidates,
                                 device="cpu")
    np.testing.assert_allclose(got[0].numpy(), want[0], **FIT_TOL)
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    np.testing.assert_array_equal(got[2].numpy(), want[2])


@pytest.mark.parametrize("rounding", ["nearest", "gptq"])
def test_quantize_slice_matches_reference(rounding):
    """One slice onto the reference's learned codebook: codes identical,
    scales within 1e-6, the codebook carried as float32."""
    rng = np.random.default_rng(5)
    w = rng.standard_normal((12, 48))
    X = rng.standard_normal((64, 48)) * (1 + rng.random(48))
    H = X.T @ X / 64
    vals = jcalib.fit_codebook(
        (w / np.abs(w).max() * 7).reshape(-1), iters=5)
    recipe = jcalib.Recipe(rounding=rounding, scale_search=3)
    spec = JSpec(**QUANT)
    want = jcalib.quantize_slice(w, spec, vals, col_weights=np.diag(H),
                                 H=H, recipe=recipe)
    got = calib.quantize_slice(
        _t(w), TSpec(**QUANT), _t(vals), col_weights=_t(np.diag(H)),
        H=_t(H), recipe=calib.Recipe(rounding=rounding, scale_search=3))
    np.testing.assert_array_equal(got.codes.numpy(), np.asarray(want.codes))
    np.testing.assert_allclose(got.scales.numpy(), np.asarray(want.scales),
                               **FIT_TOL)
    np.testing.assert_array_equal(got.codebook.numpy(),
                                  np.asarray(want.codebook))


def test_gptq_codes_match_reference_and_lower_the_objective():
    """GPTQ-lite at tests/test_calib.py's shape: codes identical, the
    output-MSE objective equal within 1e-9 relative and below nearest
    rounding's."""
    rng = np.random.default_rng(4)
    m, k, blk = 12, 32, 16
    w = rng.standard_normal((m, k))
    X = rng.standard_normal((256, k)) * (1 + 2 * rng.random(k))
    H = X.T @ X / X.shape[0]
    vals = np.asarray(jcalib.uniform_values(), np.float64)
    s, wb, _ = jcalib.fit_block_scales(w, vals, blk)
    want = jcalib.gptq_codes(w, H, vals, s, blk)
    got = calib.gptq_codes(_t(w), _t(H), _t(vals), _t(s), blk).numpy()
    np.testing.assert_array_equal(got, want)
    sfull = np.repeat(s, blk, 1)[:, :k]

    def out_mse(codes):
        E = w - vals[codes] * sfull
        return np.mean(np.einsum("ik,kl,il->i", E, H, E))

    nearest = np.argmin(np.abs((wb / s[..., None])[..., None] - vals), -1)
    np.testing.assert_allclose(out_mse(got), out_mse(want), rtol=1e-9)
    assert out_mse(got) < out_mse(nearest.reshape(m, -1)[:, :k])


def test_quantization_errors_match_reference():
    """quantization_error and weighted_quantization_error (with and
    without column weights) on a learned codebook: within 1e-6."""
    rng = np.random.default_rng(6)
    w = rng.standard_normal((10, 30)).astype(np.float32)
    cw = (0.1 + rng.random(30)).astype(np.float32)
    vals = _rand_codebook(rng)
    jq = jscales.quantize_codebook(jnp.asarray(w), jnp.asarray(vals), 12)
    tq = tscales.quantize_codebook(_t(w), _t(vals), 12)
    np.testing.assert_allclose(
        float(tscales.quantization_error(_t(w), tq)),
        float(jscales.quantization_error(jnp.asarray(w), jq)), rtol=1e-6)
    for col in (None, cw):
        want = jscales.weighted_quantization_error(jnp.asarray(w), jq, col)
        got = tscales.weighted_quantization_error(
            _t(w), tq, None if col is None else _t(col))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# ------------------------------------------------------------- stats
def _tags(cfg, tied):
    k_ff = cfg.d_ff
    out = {("wq", cfg.d_model), ("wk", cfg.d_model), ("wv", cfg.d_model),
           ("wo", cfg.num_heads * cfg.head_dim), ("up", cfg.d_model),
           ("gate", cfg.d_model), ("down", k_ff)}
    return out if tied else out | {("lm_head", cfg.d_model)}


@pytest.mark.parametrize("mode", ["diag", "full"])
def test_stats_collector_matches_reference(dense, mode):
    """Two stream batches through the dense model: the reference's (tag,
    k) keys and counts; moments and Hessians within 1e-5 relative."""
    jp, model, tcfg = dense
    stream = JStream(JDataConfig(**DATA))
    batches = [stream.host_batch(s) for s in range(2)]
    want = jcalib.collect(jp, CFG, [{k: jnp.asarray(v) for k, v in b.items()}
                                    for b in batches], mode=mode)
    got = calib.collect(model, tcfg, batches, mode=mode, device="cpu")
    assert set(got.stats) == set(want.stats) == _tags(CFG, tied=False)
    for key, e in want.stats.items():
        g = got.stats[key]
        assert g.count == e.count == 2 * 4 * 31 * CFG.num_layers \
            ** (key[0] != "lm_head")
        np.testing.assert_allclose(g.second_moment.numpy(),
                                   e.second_moment, **MOMENT_TOL)
        if mode == "full":
            np.testing.assert_allclose(g.hessian.numpy(), e.hessian,
                                       rtol=1e-5, atol=1e-7)
        else:
            assert g.hessian is None
    # the observer is gone after collect: a forward records nothing
    n = got.get("wq", 64).count
    with torch.no_grad():
        TT.forward(model, tcfg, torch.zeros((1, 4), dtype=torch.int32))
    assert got.get("wq", 64).count == n


def test_tags_do_not_change_the_computation(dense):
    """A tagged linear reports its input to the observer (before the GeMM)
    and returns what an untagged one does."""
    _, model, tcfg = dense
    seen = []

    class Spy:
        def record(self, tag, x):
            seen.append((tag, tuple(x.shape)))

    lin = model.blocks[0].attn.wq
    x = torch.randn(2, 3, 64, generator=torch.Generator().manual_seed(0))
    plain = tlinear.apply(lin, x, tcfg.quant, in_dim=64)
    with calib.observing(Spy()):
        tagged = tlinear.apply(lin, x, tcfg.quant, in_dim=64, tag="wq")
        tlinear.apply(lin, x, tcfg.quant, in_dim=64)  # untagged: silent
    assert torch.equal(plain, tagged) and seen == [("wq", (2, 3, 64))]


# ------------------------------------------------------------- calibrate
RECIPES = {
    "default": (CFG, dict()),
    "gptq": (CFG, dict(rounding="gptq")),
    "model": (CFG, dict(scope="model")),
    "uniform": (CFG, dict(method="uniform")),
    # pooled and subsampled per stacked leaf over a two-kind pattern
    "model-2kinds": (CFG2, dict(scope="model", sample_limit=1 << 15)),
}


@functools.lru_cache(maxsize=None)
def _calibrated(name):
    """(reference result, port result, dense port model, port cfg) of one
    recipe, computed once for the module."""
    jcfg, kw = RECIPES[name]
    jp, model, tcfg = _pair(jcfg)
    want = jcalib.calibrate(
        jp, jcfg, JStream(JDataConfig(**DATA)),
        jcalib.Recipe(calib_steps=2, kmeans_iters=10, **kw),
        quant=JSpec(**QUANT))
    got = calib.calibrate(
        model, tcfg, SyntheticStream(DataConfig(**DATA)),
        calib.Recipe(calib_steps=2, kmeans_iters=10, **kw),
        quant=TSpec(**QUANT), device="cpu")
    return want, got, model, tcfg


@pytest.mark.parametrize("name", sorted(RECIPES))
def test_calibrate_matches_reference(name):
    """calibrate() end to end against the reference's: per-layer codebooks
    within 1e-5 through the path mapping, report errors within 1e-5
    relative, the calibrated model's logits within 1e-4 of the reference's
    calibrated tree, engine tokens == static generate, and the dense
    model left as it was."""
    jcfg, kw = RECIPES[name]
    want, got, dense_model, tcfg = _calibrated(name)
    assert got.quant == convert.config_from_jax(
        jcfg.replace(quant=want.quant)).quant
    assert got.quant.codebook == "learned"
    n_layer_leaves = 0
    for path, cb in want.codebooks.items():
        cb = np.asarray(cb).reshape(-1, 16)
        rep = want.report[path]
        for key in ("uniform_weighted_err", "learned_weighted_err"):
            mean = np.mean([got.report[convert.port_path(path, g, tcfg)][key]
                            for g in range(cb.shape[0])])
            np.testing.assert_allclose(mean, rep[key], **ERR_TOL)
        for g in range(cb.shape[0]):
            ppath = convert.port_path(path, g, tcfg)
            np.testing.assert_allclose(got.codebooks[ppath].numpy(), cb[g],
                                       rtol=1e-5, atol=1e-5)
            n_layer_leaves += 1
    assert len(got.codebooks) == n_layer_leaves
    for key, val in want.report["aggregate"].items():
        np.testing.assert_allclose(got.report["aggregate"][key], val,
                                   **ERR_TOL)
    agg = got.report["aggregate"]
    if kw.get("method") == "uniform":
        assert agg["learned_weighted_err"] == agg["uniform_weighted_err"]
    elif kw.get("rounding") != "gptq":
        assert agg["learned_weighted_err"] < agg["uniform_weighted_err"]
    # the model: every linear's table is its codebook; logits
    qcfg = tcfg.replace(quant=got.quant)
    for path, mod in got.params.named_modules():
        if path in got.codebooks:
            assert set(mod.params()) == {"idx", "scales", "codebook"}
            assert torch.equal(mod.params()["codebook"], got.codebooks[path])
    assert "w" in dense_model.blocks[0].attn.wq.params()
    toks = np.random.default_rng(0).integers(0, 211, (2, 9)).astype(np.int32)
    ref, _ = JT.forward(want.params, jcfg.replace(quant=want.quant),
                        {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        logits = TT.forward(got.params, qcfg, _t(toks))
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref), **LOGIT_TOL)
    # serving: the continuous engine == static generate
    prompt = tuple(int(t) for t in
                   np.random.default_rng(1).integers(0, 211, 7))
    eng = Engine(got.params, qcfg, max_slots=2, block_size=4,
                 prefill_chunk=4, max_model_len=64)
    res = eng.run([Request(rid=0, prompt=prompt, max_new_tokens=6)])
    static = TSV.generate(got.params, qcfg, torch.tensor([prompt]),
                          max_new_tokens=6)
    assert res[0].generated == [int(t) for t in static[0]]


def test_calibrated_reference_tree_converts():
    """The reference's calibrated tree through convert: each layer gets its
    slice of the stacked (G, 16) codebook, and the port's forward gives
    the reference's logits within 1e-4."""
    jp = JT.init_params(jax.random.PRNGKey(0), CFG2)
    res = jcalib.calibrate(jp, CFG2, JStream(JDataConfig(**DATA)),
                           jcalib.Recipe(calib_steps=1, kmeans_iters=4),
                           quant=JSpec(**QUANT))
    jcfg = CFG2.replace(quant=res.quant)
    tcfg = convert.config_from_jax(jcfg)
    model = convert.params_from_jax(_np_tree(res.params), tcfg, device="cpu")
    mods = dict(model.named_modules())
    for path, cb in res.codebooks.items():
        cb = np.asarray(cb).reshape(-1, 16)
        for g in range(cb.shape[0]):
            np.testing.assert_array_equal(
                mods[convert.port_path(path, g, tcfg)].params()["codebook"]
                .numpy(), cb[g])
    assert convert.port_path("blocks/1:attn/mlp/up", 1, tcfg) == \
        "blocks.3.mlp.up"
    assert convert.port_path("lm_head", 0, tcfg) == "lm_head"
    toks = np.random.default_rng(2).integers(0, 211, (2, 9)).astype(np.int32)
    ref, _ = JT.forward(res.params, jcfg, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        got = TT.forward(model, tcfg, _t(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **LOGIT_TOL)


def test_calibration_defaults_to_the_card(dense):
    """Entry points run on the card unless asked: without a GPU they raise,
    with one a CPU model is refused rather than moved."""
    _, model, tcfg = dense
    stream = SyntheticStream(DataConfig(**DATA))
    err = ValueError if torch.cuda.is_available() else RuntimeError
    with pytest.raises(err):
        calib.calibrate(model, tcfg, stream)
    with pytest.raises(err):
        calib.collect(model, tcfg, [stream.host_batch(0)])
    with pytest.raises(err):
        calib.quality.perplexity(model, tcfg, stream)


# ------------------------------------------------------------- backends
def _leaf_pair(mode, storage, learned, rng):
    w = rng.standard_normal((20, 48)).astype(np.float32)
    cb = _rand_codebook(rng) if learned else None
    kw = dict(mode=mode, d=3, scale_block=12, storage=storage,
              codebook="learned" if learned else "none")
    jp = jlinear.from_dense(jnp.asarray(w), JSpec(**kw),
                            codebook=None if cb is None else jnp.asarray(cb))
    tp = tlinear.from_dense(_t(w), TSpec(**kw),
                            codebook=None if cb is None else _t(cb))
    return jp, tp, JSpec(**kw), TSpec(**kw)


@pytest.mark.parametrize("learned", [False, True], ids=["uniform", "learned"])
@pytest.mark.parametrize("storage", ["packed_idx", "packed_u8"])
@pytest.mark.parametrize("pair", [("int4_torch", "int4_jnp"),
                                  ("msgemm_torch", "msgemm_jnp")],
                         ids=["int4", "msgemm"])
def test_torch_backends_match_jnp(pair, storage, learned):
    """int4_torch against int4_jnp and msgemm_torch against msgemm_jnp on
    the same leaves: within 1e-5."""
    ours, theirs = pair
    mode = "int4_dequant" if ours == "int4_torch" else "msgemm"
    rng = np.random.default_rng(7)
    jp, tp, jspec, tspec = _leaf_pair(mode, storage, learned, rng)
    x = rng.standard_normal((2, 3, 48)).astype(np.float32)
    want = jdispatch.execute(jp, jnp.asarray(x), jspec, in_dim=48,
                             plan_override=jdispatch.ExecPlan(theirs))
    got = dispatch.execute(tp, _t(x), tspec, in_dim=48,
                           plan_override=dispatch.ExecPlan(ours))
    assert got.shape == (2, 3, 20) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_default_backends_keep_the_kernels():
    """Uniform weights keep the kernels on both devices; learned int4 goes
    to int4_torch (the reference's int4_pallas refuses codebooks too);
    learned msgemm keeps the msGeMM kernel."""
    for mode, learned, want in (("msgemm", False, "msgemm_cuda"),
                                ("msgemm", True, "msgemm_cuda"),
                                ("int4_dequant", False, "int4_cuda"),
                                ("int4_dequant", True, "int4_torch")):
        spec = TSpec(mode=mode, d=3, scale_block=12,
                     codebook="learned" if learned else "none")
        assert dispatch.plan(spec, 16, 24, 4).backend == want
        assert dispatch.select_backend(spec, 3, "cuda").name == want
    assert dispatch.get_backend("msgemm_torch").priority == 50
    assert dispatch.get_backend("int4_torch").priority == 50


def test_learned_int4_model_serves_on_int4_torch(dense):
    """An int4_dequant model calibrated to learned tables plans int4_torch
    for every linear, and its engine matches static generate."""
    _, model, tcfg = dense
    res = calib.calibrate(model, tcfg, SyntheticStream(DataConfig(**DATA)),
                          calib.Recipe(calib_steps=1, kmeans_iters=4),
                          quant=TSpec(mode="int4_dequant", d=3,
                                      scale_block=36, storage="packed_u8"),
                          device="cpu")
    qcfg = tcfg.replace(quant=res.quant)
    assert dataclasses.replace(res.quant, codebook="none") == TSpec(
        mode="int4_dequant", d=3, scale_block=36, storage="packed_u8")
    prompt = (5, 17, 3, 99, 140)
    eng = Engine(res.params, qcfg, max_slots=2, block_size=4,
                 prefill_chunk=4, max_model_len=32)
    out = eng.run([Request(rid=0, prompt=prompt, max_new_tokens=5)])
    with dispatch.collecting() as reqs:
        static = TSV.generate(res.params, qcfg, torch.tensor([prompt]),
                              max_new_tokens=5)
    assert len(reqs) > 0 and {r.backend for r in reqs} == {"int4_torch"}
    assert out[0].generated == [int(t) for t in static[0]]
