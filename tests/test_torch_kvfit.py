"""Port parity, the KV codebook fit and the quality harness:
``repro_torch.kvq.fit`` (samples, the fitted table, the reconstruction
error) and ``repro_torch.calib.quality`` (``compare`` over weight
recipes, ``compare_kv`` over pool storages) against the reference's on
the same weights and numpy tokens.

Tolerances: K/V samples within 1e-5 (scale-normalized values in
[-7, 7]; the two prefills round their float32 K/V differently), in the
same order; the fitted table within 1e-6; reconstruction errors within
1e-6; quality metrics within 1e-4.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_plan_isolation import (  # noqa: E402,F401  (autouse)
    isolated_plan_cache, isolated_plan_cache_module)
# one intra-op thread each: the suite runs in parallel workers
torch.set_num_threads(1)

import jax  # noqa: E402

from repro import calib as jcalib  # noqa: E402
from repro import configs as j_configs  # noqa: E402
from repro.core.spec import QuantSpec as JSpec  # noqa: E402
from repro.data.pipeline import DataConfig as JDataConfig  # noqa: E402
from repro.data.pipeline import SyntheticStream as JStream  # noqa: E402
from repro.kvq import KVQuantSpec as JKVSpec  # noqa: E402
from repro.kvq import fit as jfit  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.config import ModelConfig as JModelConfig  # noqa: E402
from repro.quant import quantize_model as j_quantize  # noqa: E402
from repro_torch import calib, convert, kvq  # noqa: E402
from repro_torch.core.spec import QuantSpec as TSpec  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticStream  # noqa: E402
from repro_torch.kvq import fit as tfit  # noqa: E402
from repro_torch.quant import quantize_model as t_quantize  # noqa: E402

SAMPLE_TOL = dict(rtol=0, atol=1e-5)
QUALITY_TOL = dict(rtol=1e-4, atol=1e-4)
# tests/test_calib.py's calibration config and stream
CFG = JModelConfig(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                   d_ff=128, vocab_size=211, max_seq_len=128)
DATA = dict(vocab_size=211, seq_len=32, global_batch=4)


def _pair(jcfg):
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    tcfg = convert.config_from_jax(jcfg)
    return jp, jcfg, convert.params_from_jax(
        jax.tree.map(np.asarray, jp), tcfg, device="cpu"), tcfg


@pytest.fixture(scope="module", params=["gemma_2b", "gemma2_9b"])
def smoke(request):
    """The reference's SMOKE model of one arch in both packages, and a
    (2, 24) token batch."""
    pair = _pair(j_configs.get_smoke(request.param))
    toks = np.random.default_rng(3).integers(
        0, pair[1].vocab_size, (2, 24)).astype(np.int32)
    return (*pair, [{"tokens": toks}])


@pytest.mark.parametrize("max_samples", [1 << 20, 5000],
                         ids=["all", "subsampled"])
def test_collect_kv_samples_matches_reference(smoke, max_samples):
    """Per pattern position, k then v over its layers: the reference's
    array, in its order (gemma2-9b's two kinds show a wrong order), and
    the same seeded subsample."""
    jp, jcfg, model, tcfg, batches = smoke
    want = jfit.collect_kv_samples(jp, jcfg, batches,
                                   max_samples=max_samples, seed=2)
    got = tfit.collect_kv_samples(model, tcfg, batches,
                                  max_samples=max_samples, seed=2,
                                  device="cpu")
    assert got.dtype == torch.float64 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **SAMPLE_TOL)


def test_fit_kv_codebook_and_errors_match_reference(smoke):
    """The table fitted from explicit tokens within 1e-6; the uniform,
    learned and kv8 reconstruction errors within 1e-6, learned <= uniform
    on the fitted samples."""
    jp, jcfg, model, tcfg, batches = smoke
    want = jfit.fit_kv_codebook(jp, jcfg, batches)
    got = kvq.fit_kv_codebook(model, tcfg, batches, device="cpu")
    assert isinstance(got, tuple) and len(got) == 16 and got[0] == 0.0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    errs = {}
    for name, bits, cb in (("uniform", 4, None), ("learned", 4, got),
                           ("kv8", 8, None)):
        e_want = jfit.kv_reconstruction_error(
            jp, jcfg, batches, JKVSpec(bits, codebook=cb))
        errs[name] = tfit.kv_reconstruction_error(
            model, tcfg, batches, kvq.KVQuantSpec(bits, codebook=cb),
            device="cpu")
        np.testing.assert_allclose(errs[name], e_want, rtol=0, atol=1e-6)
    assert errs["learned"] <= errs["uniform"]


def test_lazy_kv_reconstruction_error_matches_reference(smoke):
    """``kvq.kv_reconstruction_error``, the package's lazy re-export, gives
    the reference's ``repro.kvq.kv_reconstruction_error`` within 1e-6."""
    from repro import kvq as jkvq

    jp, jcfg, model, tcfg, batches = smoke
    for bits in (4, 8):
        got = kvq.kv_reconstruction_error(model, tcfg, batches,
                                          kvq.KVQuantSpec(bits),
                                          device="cpu")
        want = jkvq.kv_reconstruction_error(jp, jcfg, batches,
                                            JKVSpec(bits))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_fit_kv_codebook_draws_its_own_tokens():
    """Without batches or tokens the fit draws a (2, 32) batch from a
    torch.Generator seeded with ``seed`` (the reference's jax.random draw
    cannot be reproduced): the same seed gives the same table."""
    _, _, model, tcfg = _pair(j_configs.get_smoke("gemma_2b"))
    a = kvq.fit_kv_codebook(model, tcfg, seed=1, iters=5, device="cpu")
    b = tfit.fit_kv_codebook(model, tcfg, seed=1, iters=5, device="cpu")
    assert a == b and a[0] == 0.0 and len(a) == 16
    kvq.KVQuantSpec(4, codebook=a)  # a valid table


def test_compare_kv_matches_reference():
    """compare_kv over kv8, kv4 and kv4 with the fitted table against the
    reference's: metrics within 1e-4; the full-precision pool certifies
    the harness."""
    jp, jcfg, model, tcfg = _pair(j_configs.get_smoke("gemma2_9b"))
    toks = np.random.default_rng(3).integers(0, jcfg.vocab_size, (2, 24))
    data = [{"tokens": toks.astype(np.int32),
             "labels": toks.astype(np.int32)}]
    cb = jfit.fit_kv_codebook(jp, jcfg, data)
    want = jcalib.quality.compare_kv(
        jp, jcfg, {"kv8": JKVSpec(8), "kv4": JKVSpec(4),
                   "kv4_learned": JKVSpec(4, codebook=cb)}, data, steps=1)
    got = calib.quality.compare_kv(
        model, tcfg, {"kv8": kvq.KVQuantSpec(8), "kv4": kvq.KVQuantSpec(4),
                      "kv4_learned": kvq.KVQuantSpec(4, codebook=cb)},
        data, steps=1, device="cpu")
    assert set(got) == set(want)
    for name, metrics in want.items():
        for key, val in metrics.items():
            np.testing.assert_allclose(got[name][key], val, **QUALITY_TOL)
    assert got["bf16_kv"]["logit_mse"] <= 1e-9
    assert got["bf16_kv"]["top1_agree"] == 1.0


def test_quality_compare_matches_reference():
    """compare() over the dense, uniform msgemm and learned msgemm models
    (tests/test_calib.py's config): perplexity, logit MSE and top-1
    agreement within 1e-4 of the reference's, and the learned tables'
    logit MSE below uniform's, as the reference's test asserts."""
    jp, _, model, tcfg = _pair(CFG)
    recipe = dict(calib_steps=1, kmeans_iters=10)
    spec = dict(mode="msgemm", d=3, scale_block=36)
    jres = jcalib.calibrate(jp, CFG, JStream(JDataConfig(**DATA)),
                            jcalib.Recipe(**recipe), quant=JSpec(**spec))
    tres = calib.calibrate(model, tcfg, SyntheticStream(DataConfig(**DATA)),
                           calib.Recipe(**recipe), quant=TSpec(**spec),
                           device="cpu")
    jq = CFG.replace(quant=jres.quant)
    want = jcalib.quality.compare(
        jp, CFG, {"uniform": (j_quantize(jp, CFG, jres.quant), jq),
                  "learned": (jres.params, jq)},
        JStream(JDataConfig(**DATA)), steps=1)
    tq = tcfg.replace(quant=tres.quant)
    uniform = t_quantize(_pair(CFG)[2], tres.quant)
    got = calib.quality.compare(
        model, tcfg, {"uniform": (uniform, tq),
                      "learned": (tres.params, tq)},
        SyntheticStream(DataConfig(**DATA)), steps=1, device="cpu")
    assert set(got) == set(want) == {"bf16", "uniform", "learned"}
    for name, metrics in want.items():
        for key, val in metrics.items():
            np.testing.assert_allclose(got[name][key], val, **QUALITY_TOL)
    assert got["bf16"]["logit_mse"] == 0.0
    assert got["learned"]["logit_mse"] < got["uniform"]["logit_mse"]
    ppl = calib.quality.perplexity(model, tcfg, SyntheticStream(
        DataConfig(**DATA)), steps=1, device="cpu")
    assert ppl == pytest.approx(got["bf16"]["perplexity"], rel=1e-6)
