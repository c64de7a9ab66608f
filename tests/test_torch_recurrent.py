"""Port parity, the recurrent blocks: ``repro_torch.models.mamba`` and
``repro_torch.models.xlstm`` against ``repro.models.mamba`` / ``xlstm`` on
the reference's weights (through ``convert``) and numpy inputs, and the
jamba-v0.1 and xlstm-1.3b SMOKE models end to end.

* ``common.chunked_scan`` against the reference's, and its contract;
* ``mamba_apply``, dense and msgemm, at L = 1, 7 and 20 with
  ``mamba_chunk`` 8 (20 ends in a ragged chunk, which the reference pads
  and the port does not), from the zero and from a carried state: output
  and final ``ssm``/``conv`` within 1e-5;
* the mLSTM's chunkwise-parallel form against its sequential one and the
  reference's, q, k and v drawn independently (a transposed memory C
  would pass with v = k), from the initial (m = -inf) and from a carried
  state;
* the sLSTM block against the reference's at L <= ``xlstm_chunk`` and at
  L a multiple of it; at a ragged L > ``xlstm_chunk`` the port's
  prefill + decode held to the reference's ``forward`` (the reference's
  own prefill pads, see :func:`test_slstm_ragged_prompt_state`);
* both SMOKE models with msgemm weights: ``forward`` logits,
  ``prefill`` + ``decode_step`` logits within 1e-4, static ``generate``'s
  greedy tokens equal to the reference's; the decode caches' layout and
  their size independent of ``max_len``; the paged pool, block and engine
  refuse both, as the reference's pool does.
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
from repro.models import common as j_common  # noqa: E402
from repro.models import mamba as j_mamba  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models import xlstm as j_xlstm  # noqa: E402
from repro.quant import quantize_model as j_quantize  # noqa: E402
from repro.runtime import serve as JSV  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.models import common, mamba, xlstm  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.runtime import serve as TSV  # noqa: E402
from repro_torch.serving import Engine  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
MSGEMM = dict(mode="msgemm", d=3, scale_block=36)
ARCHS = ["jamba_v01", "xlstm_1b3"]


@functools.lru_cache(maxsize=None)
def _dense(arch, pattern=None):
    """The reference's dense SMOKE params of ``arch`` (with ``pattern`` as
    its block pattern and period as its depth, when given)."""
    jcfg = j_configs.get_smoke(arch)
    if pattern is not None:
        jcfg = jcfg.replace(block_pattern=pattern, num_layers=len(pattern))
    return JT.init_params(jax.random.PRNGKey(0), jcfg), jcfg


@functools.lru_cache(maxsize=None)
def _pair(arch, quant=True, chunk=None, pattern=None):
    """The reference's SMOKE params (msgemm-quantized when ``quant``), the
    port's model converted from them, and both configs (``chunk``: the
    ``xlstm_chunk``, which shapes no weight)."""
    jp, jcfg = _dense(arch, pattern)
    if chunk is not None:
        jcfg = jcfg.replace(xlstm_chunk=chunk)
    if quant:
        spec = JSpec(**MSGEMM)
        jp = jax.jit(lambda p: j_quantize(p, jcfg, spec))(jp)
        jcfg = jcfg.replace(quant=spec)
    tcfg = convert.config_from_jax(jcfg)
    model = convert.params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                                    device="cpu")
    return jp, jcfg, model, tcfg


@functools.lru_cache(maxsize=None)
def _ref_steps(jcfg):
    """The reference's prefill and decode step, jitted for ``jcfg``."""
    prefill = jax.jit(lambda p, t, c: JT.prefill(p, jcfg, {"tokens": t}, c))
    decode = jax.jit(lambda p, t, c, pos: JT.decode_step(p, jcfg, t, c, pos))
    return prefill, decode


def _slice(tree, g=0):
    return jax.tree.map(lambda a: a[g], tree)


def _torch(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _tokens(cfg, B, L, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(B, L)).astype(np.int32)


# ------------------------------------------------------------ chunked scan
def test_chunked_scan_matches_reference():
    def step(c, x):
        return c * 0.5 + x[0], c * x[0]

    xs = np.random.default_rng(0).normal(size=(8, 3)).astype(np.float32)
    c0 = np.ones(3, np.float32)
    for T, chunk in ((8, 4), (8, 8), (3, 4)):
        want_c, want_y = j_common.chunked_scan(
            step, jnp.asarray(c0), (jnp.asarray(xs[:T]),), chunk=chunk)
        got_c, got_y = common.chunked_scan(
            step, torch.from_numpy(c0), (torch.from_numpy(xs[:T]),),
            chunk=chunk)
        np.testing.assert_allclose(got_c.numpy(), want_c, **TOL)
        np.testing.assert_allclose(got_y.numpy(), want_y, **TOL)
    with pytest.raises(ValueError, match="multiple"):
        common.chunked_scan(step, torch.from_numpy(c0),
                            (torch.from_numpy(xs[:6]),), chunk=4)


# ------------------------------------------------------------------ Mamba
@pytest.mark.parametrize("carried", [False, True], ids=["zero", "carried"])
@pytest.mark.parametrize("L", [1, 7, 20])
@pytest.mark.parametrize("quant", [False, True], ids=["dense", "msgemm"])
def test_mamba_apply_matches_reference(quant, L, carried):
    jp, jcfg, model, tcfg = _pair("jamba_v01", quant)
    assert tcfg.mamba_chunk == 8
    jm = _slice(jp["blocks"]["0:mamba"]["mamba"])
    pm = model.blocks[0].mamba
    rng = np.random.default_rng(L)
    x = rng.normal(size=(2, L, tcfg.d_model)).astype(np.float32)
    jstate = tstate = None
    if carried:  # the state after a 5-token prefix, from the reference
        prefix = rng.normal(size=(2, 5, tcfg.d_model)).astype(np.float32)
        _, jstate = j_mamba.mamba_apply(jm, jcfg, jnp.asarray(prefix))
        tstate = _torch(jstate)
    want, wstate = j_mamba.mamba_apply(jm, jcfg, jnp.asarray(x),
                                       state=jstate)
    got, gstate = mamba.mamba_apply(pm, tcfg, torch.from_numpy(x),
                                    state=tstate)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for k in ("ssm", "conv"):
        np.testing.assert_allclose(gstate[k].numpy(), np.asarray(wstate[k]),
                                   **TOL)


# ------------------------------------------------------------------ mLSTM
def _mlstm_inputs(B=2, L=37, H=3, dh=8, seed=7):
    """q, k and v drawn independently, i~ and log-sigmoid f~."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    ft = -np.logaddexp(0.0, -(f(B, L, H) + 2)).astype(np.float32)
    return f(B, L, H, dh), f(B, L, H, dh) * 0.5, f(B, L, H, dh), \
        f(B, L, H) * 2, ft


def _mlstm_init_state(B=2, H=3, dh=8):
    return (np.zeros((B, H, dh, dh), np.float32),
            np.zeros((B, H, dh), np.float32),
            np.full((B, H), -np.inf, np.float32))


def test_mlstm_forms_match_each_other_and_reference():
    ins = _mlstm_inputs()
    st = _mlstm_init_state()
    want_h, want_st = j_xlstm.mlstm_sequence(
        *map(jnp.asarray, ins), tuple(map(jnp.asarray, st)), chunk=64)
    tin = tuple(map(torch.from_numpy, ins))
    tst = tuple(map(torch.from_numpy, st))
    seq_h, seq_st = xlstm.mlstm_sequence(*tin, tst, chunk=64)
    np.testing.assert_allclose(seq_h.numpy(), np.asarray(want_h), **TOL)
    for g, w in zip(seq_st, want_st):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    for W in (4, 8, 37, 64):  # ragged last chunks at 4 and 8
        par_h, par_st = xlstm.mlstm_sequence_parallel(*tin, tst, chunk=W)
        np.testing.assert_allclose(par_h.numpy(), seq_h.numpy(),
                                   rtol=2e-4, atol=2e-4)
        for g, w in zip(par_st, seq_st):
            np.testing.assert_allclose(g.numpy(), w.numpy(),
                                       rtol=2e-5, atol=2e-5)
    # a carried state: 20 steps sequential, the rest in parallel chunks
    _, mid = xlstm.mlstm_sequence(*(t[:, :20] for t in tin), tst, chunk=64)
    cont_h, _ = xlstm.mlstm_sequence_parallel(*(t[:, 20:] for t in tin),
                                              mid, chunk=8)
    np.testing.assert_allclose(cont_h.numpy(), np.asarray(want_h)[:, 20:],
                               rtol=2e-4, atol=2e-4)
    assert all(torch.isfinite(t).all() for t in (seq_h, cont_h))


def test_mlstm_decode_steps_continue_the_parallel_prefill():
    """The block's two forms agree across the prefill/decode boundary: a
    parallel prefill of 6 tokens and 3 sequential decode steps give the
    logits of one parallel pass over all 9 (the twin of the reference's
    archs smoke test)."""
    jp, jcfg, model, tcfg = _pair("xlstm_1b3", chunk=4)
    toks = torch.from_numpy(_tokens(tcfg, 2, 9))
    full = TT.forward(model, tcfg, toks)
    cache = TSV.init_cache(tcfg, 2, 9, device="cpu")
    logits, cache = TSV.prefill_step(model, tcfg, toks[:, :6], cache)
    np.testing.assert_allclose(logits.numpy(), full[:, 5].numpy(),
                               **LOGIT_TOL)
    for t in range(6, 9):
        pos = torch.full((2,), t, dtype=torch.int64)
        logits, cache = TSV.decode_step(model, tcfg, toks[:, t], cache, pos)
        np.testing.assert_allclose(logits.numpy(), full[:, t].numpy(),
                                   **LOGIT_TOL)


# ------------------------------------------------------------------ sLSTM
@pytest.mark.parametrize("L", [3, 4, 8])
def test_slstm_block_matches_reference(L):
    """L <= xlstm_chunk (4) and L a multiple of it: the reference pads
    nothing, so block output and state agree."""
    jp, jcfg, model, tcfg = _pair("xlstm_1b3", chunk=4)
    assert tcfg.kind(7) == "slstm"
    x = np.random.default_rng(L).normal(
        size=(2, L, tcfg.d_model)).astype(np.float32)
    want, wstate = j_xlstm.slstm_block_apply(
        _slice(jp["blocks"]["7:slstm"]), jcfg, jnp.asarray(x))
    got, gstate = xlstm.slstm_block_apply(model.blocks[7], tcfg,
                                          torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for k in ("h", "c", "n", "m"):
        np.testing.assert_allclose(gstate[k].numpy(), np.asarray(wstate[k]),
                                   **TOL)


def test_slstm_ragged_prompt_state():
    """An sLSTM-only model, ``xlstm_chunk`` 4, a 6-token prompt: the port's
    prefill + decode logits equal the reference's ``forward`` over the 7
    tokens within 1e-4.  The reference's own prefill pads the time axis
    to 8 with zero inputs and returns the state after the padded steps,
    which the recurrent mixing has moved, so its prefill + decode misses
    its ``forward`` (by 0.86 at the SMOKE width; here asserted > 0.1, the
    proof that this case runs through the padding)."""
    jp, jcfg, model, tcfg = _pair("xlstm_1b3", chunk=4,
                                  pattern=("slstm", "slstm"))
    toks = _tokens(tcfg, 2, 7)
    want, _ = JT.forward(jp, jcfg, {"tokens": jnp.asarray(toks)})
    want = np.asarray(want)
    cache = TSV.init_cache(tcfg, 2, 7, device="cpu")
    first, cache = TSV.prefill_step(model, tcfg,
                                    torch.from_numpy(toks[:, :6]), cache)
    nxt, _ = TSV.decode_step(model, tcfg, torch.from_numpy(toks[:, 6]),
                             cache, torch.full((2,), 6, dtype=torch.int64))
    np.testing.assert_allclose(first.numpy(), want[:, 5], **LOGIT_TOL)
    np.testing.assert_allclose(nxt.numpy(), want[:, 6], **LOGIT_TOL)
    prefill, decode = _ref_steps(jcfg)
    _, jcache = prefill(jp, jnp.asarray(toks[:, :6]),
                        JT.init_cache(jcfg, 2, 7))
    ref_next, _ = decode(jp, jnp.asarray(toks[:, 6]), jcache,
                         jnp.full((2,), 6, jnp.int32))
    assert np.abs(np.asarray(ref_next) - want[:, 6]).max() > 0.1


# ------------------------------------------------------- the SMOKE models
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_reference(arch):
    jp, jcfg, model, tcfg = _pair(arch)
    toks = _tokens(tcfg, 2, 11)
    want, _ = JT.forward(jp, jcfg, {"tokens": jnp.asarray(toks)})
    got = TT.forward(model, tcfg, torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_logits_match_reference(arch):
    jp, jcfg, model, tcfg = _pair(arch)
    toks = _tokens(tcfg, 2, 12)
    S, n = 9, 3
    prefill, decode = _ref_steps(jcfg)
    want, jcache = prefill(jp, jnp.asarray(toks[:, :S]),
                           JT.init_cache(jcfg, 2, S + n))
    cache = TSV.init_cache(tcfg, 2, S + n, device="cpu")
    got, cache = TSV.prefill_step(model, tcfg, torch.from_numpy(toks[:, :S]),
                                  cache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    for t in range(S, S + n):
        want, jcache = decode(jp, jnp.asarray(toks[:, t]), jcache,
                              jnp.full((2,), t, jnp.int32))
        got, cache = TSV.decode_step(model, tcfg, torch.from_numpy(toks[:, t]),
                                     cache, torch.full((2,), t,
                                                       dtype=torch.int64))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **LOGIT_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_tokens_match_reference(arch):
    jp, jcfg, model, tcfg = _pair(arch)
    toks = _tokens(tcfg, 2, 7, seed=3)
    want = JSV.generate(jp, jcfg, {"tokens": jnp.asarray(toks)},
                        max_new_tokens=6)
    got = TSV.generate(model, tcfg, torch.from_numpy(toks), max_new_tokens=6)
    assert got.tolist() == np.asarray(want).tolist()


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_layout_and_state_size(arch):
    """Each layer's cache has the reference's keys, shapes (one slice of
    its stacked (G, ...) leaves) and dtypes, at bf16 activations; a
    recurrent layer's state does not grow with ``max_len`` (the twin of
    the reference's ``test_long_decode_states_bounded``)."""
    jcfg = j_configs.get_smoke(arch).replace(dtype="bfloat16")
    tcfg = convert.config_from_jax(jcfg)
    want = JT.init_cache(jcfg, 2, 64, jnp.bfloat16)
    short = TT.init_cache(tcfg, 2, 64, torch.bfloat16, device="cpu")
    long = TT.init_cache(tcfg, 2, 4096, torch.bfloat16, device="cpu")
    for layer, (a, b) in enumerate(zip(short, long)):
        g, i = divmod(layer, len(tcfg.block_pattern))
        kind = tcfg.kind(layer)
        ref = want[f"{i}:{kind}"]
        assert sorted(a) == sorted(ref)
        for k, t in a.items():
            assert tuple(t.shape) == ref[k].shape[1:]
            assert str(t.dtype).split(".")[1] == str(ref[k].dtype)
        if kind not in ("attn", "local", "moe"):  # the initial state
            for k, t in a.items():
                np.testing.assert_array_equal(
                    t.float().numpy(), np.asarray(ref[k][g], np.float32))
                assert torch.equal(t, b[k])
    state = lambda c: sum(  # noqa: E731
        t.numel() * t.element_size() for layer, d in enumerate(c)
        if tcfg.kind(layer) not in ("attn", "local", "moe")
        for t in d.values())
    assert state(short) == state(long) > 0
    if tcfg.attention_free:
        total = lambda c: sum(t.numel() * t.element_size()  # noqa: E731
                              for d in c for t in d.values())
        assert total(short) == total(long)


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_serving_refused(arch):
    jp, jcfg, model, tcfg = _pair(arch)
    with pytest.raises(NotImplementedError):
        JT.init_paged_cache(jcfg, 8, 8)
    with pytest.raises(NotImplementedError, match="paged KV cache"):
        TT.init_paged_cache(tcfg, 8, 8, device="cpu")
    with pytest.raises(NotImplementedError, match="paged KV cache"):
        Engine(model, tcfg, max_slots=2, block_size=8, max_model_len=32)
    kind = next(k for k in tcfg.block_pattern
                if k not in ("attn", "local", "moe"))
    layer = tcfg.block_pattern.index(kind)
    with pytest.raises(NotImplementedError, match="attention block kinds"):
        TT.block_apply(model.blocks[layer], tcfg, kind,
                       torch.zeros((1, 1, tcfg.d_model)), None, mode="paged")
