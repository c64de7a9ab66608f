"""Port parity, model layer: the reference's gemma weights converted with
``repro_torch.convert.params_from_jax`` give the same logits through the
port's forward / prefill+decode / paged paths as the JAX model, in f32 at
the SMOKE gemma config, for dense (bf16 mode, here f32) and msgemm
weights.

Tolerance: rtol = atol = 1e-4 on logits.  The two sides sum in different
orders (XLA's dot vs torch's matmul; for msgemm, the reference's jnp
consume multiplies each chunk by its scale while the port's kernel sums a
scale block first), so logits differ by float32 rounding only.
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

from repro.configs.gemma_2b import SMOKE as J_SMOKE  # noqa: E402
from repro.core.spec import QuantSpec as JSpec  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.quant import quantize_model as j_quantize  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core.spec import QuantSpec as TSpec  # noqa: E402
from repro_torch.device import generator, resolve  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.quant import quantize_model as t_quantize  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
QSPEC = dict(mode="msgemm", d=3, scale_block=36)


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module", params=["bf16", "msgemm"])
def pair(request):
    """(jax params, jax cfg, port model, port cfg) for one weight mode."""
    jcfg = J_SMOKE.replace(block_pattern=("attn", "local"),
                           sliding_window=5)
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    if request.param == "msgemm":
        spec = JSpec(**QSPEC)
        jp, jcfg = j_quantize(jp, jcfg, spec), jcfg.replace(quant=spec)
    tcfg = convert.config_from_jax(jcfg)
    return jp, jcfg, convert.params_from_jax(_np_tree(jp), tcfg,
                                             device="cpu"), tcfg


def _tokens(seed, B, S, vocab):
    return np.random.default_rng(seed).integers(0, vocab, size=(B, S)) \
        .astype(np.int32)


def test_forward_logits_match(pair):
    jp, jcfg, model, tcfg = pair
    toks = _tokens(0, 2, 9, jcfg.vocab_size)
    want, _ = JT.forward(jp, jcfg, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        got = TT.forward(model, tcfg, torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_prefill_decode_match(pair):
    jp, jcfg, model, tcfg = pair
    toks = _tokens(1, 2, 7, jcfg.vocab_size)
    jc = JT.init_cache(jcfg, 2, 10)
    tc = TT.init_cache(tcfg, 2, 10, device="cpu")
    want, jc = JT.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, jc)
    with torch.no_grad():
        got, tc = TT.prefill(model, tcfg, torch.from_numpy(toks), tc)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        tok = np.argmax(np.asarray(want), -1).astype(np.int32)
        pos = np.full((2,), 7, np.int32)
        want, _ = JT.decode_step(jp, jcfg, jnp.asarray(tok), jc,
                                 jnp.asarray(pos))
        got, _ = TT.decode_step(model, tcfg, torch.from_numpy(tok), tc,
                                torch.from_numpy(pos).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_forward_paged_match(pair):
    """A 6-token prefill chunk into blocks [2, 1], then one decode step."""
    jp, jcfg, model, tcfg = pair
    nb, bs, W = 5, 4, 8
    jpool = JT.init_paged_cache(jcfg, nb, bs)
    tpool = TT.init_paged_cache(tcfg, nb, bs, device="cpu")
    blocks = np.array([2, 1], np.int32)
    view = (blocks[:, None] * bs + np.arange(bs)).reshape(1, W) \
        .astype(np.int32)
    toks = _tokens(2, 1, 6, jcfg.vocab_size)
    for start, chunk in ((0, toks), (6, toks[:, -1:])):
        pos = (start + np.arange(chunk.shape[1], dtype=np.int32))[None]
        ws = view[:, pos[0]]
        args = (chunk, pos, ws, view)
        want, jpool = JT.forward_paged(jp, jcfg, jnp.asarray(chunk), jpool,
                                       *map(jnp.asarray, args[1:]))
        with torch.no_grad():
            got, tpool = TT.forward_paged(model, tcfg,
                                          torch.from_numpy(chunk), tpool,
                                          *map(torch.from_numpy, args[1:]))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(
        tpool[1]["k"].numpy(), np.asarray(jpool["1:local"]["k"][0]), **TOL)


def test_quantize_model_leaves_identical():
    """Port quantize_model on converted dense weights == the reference's
    quantize_model, leaf for leaf."""
    jcfg = J_SMOKE
    jp = JT.init_params(jax.random.PRNGKey(3), jcfg)
    tcfg = convert.config_from_jax(jcfg)
    model = convert.params_from_jax(_np_tree(jp), tcfg, device="cpu")
    t_quantize(model, TSpec(**QSPEC))
    want = _np_tree(j_quantize(jp, jcfg, JSpec(**QSPEC)))
    for layer, blk in enumerate(model.blocks):
        jb = want["blocks"]["0:attn"]
        for path, leaf in (("attn", "wq"), ("attn", "wo"), ("mlp", "gate"),
                           ("mlp", "down")):
            got = getattr(getattr(blk, path), leaf).params()
            ref = jb[path][leaf]
            assert sorted(got) == sorted(ref) == ["idx", "scales"]
            for name in ref:
                np.testing.assert_array_equal(got[name].numpy(),
                                              ref[name][layer])


def test_init_params_quantizes_block_by_block():
    tcfg = convert.config_from_jax(J_SMOKE)
    spec = TSpec(**QSPEC)
    model = TT.init_params(tcfg, generator=generator(0, "cpu"),
                           device="cpu", quant=spec)
    linears = [m for m in model.modules()
               if type(m).__name__ == "QLinear"]
    assert len(linears) == 7 * tcfg.num_layers
    assert all("w" not in m.params() and m.params()["idx"].dtype ==
               torch.int32 for m in linears)
    toks = torch.from_numpy(_tokens(4, 1, 5, tcfg.vocab_size))
    with torch.no_grad():
        logits = TT.forward(model, tcfg.replace(quant=spec), toks)
    assert logits.shape == (1, 5, tcfg.vocab_size)
    assert torch.isfinite(logits).all()


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        assert resolve(None).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        TT.init_cache(convert.config_from_jax(J_SMOKE), 1, 4)
    assert resolve("cpu").type == "cpu"
