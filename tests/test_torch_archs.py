"""Port parity, the architectures of slice 11: codeqwen1.5-7b,
starcoder2-15b and gpt3-175b (dense: GQA/MHA, LayerNorm, GELU MLPs, no
RoPE, untied heads) and qwen2-moe-a2.7b and llama4-maverick (MoE blocks,
top-4 and top-1 routing, shared experts, qk-norm).

* ``param_count`` and ``shapes.cells`` equal the reference's for every
  ported arch (full and SMOKE configs), and the input specs of the
  enc-dec and vision configs' cells;
* the forward logits of each new arch's SMOKE model, built from the
  reference's weights through ``convert``, within 1e-4 of the reference's
  (msgemm weights; the MoE experts run int4 in both packages);
* the MoE models' continuous-engine tokens equal the reference engine's,
  msgemm weights with an f32 pool and with kv8 (a MoE engine need not
  equal static ``generate``: a prefill chunk's pad tokens take expert
  capacity, in the reference too);
* the dense models' engine tokens equal the port's static ``generate``.
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
from repro.configs import shapes as j_shapes  # noqa: E402
from repro.core.spec import QuantSpec as JSpec  # noqa: E402
from repro.kvq import KVQuantSpec as JKVSpec  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.config import param_count as j_param_count  # noqa: E402
from repro.quant import quantize_model as j_quantize  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.configs import shapes  # noqa: E402
from repro_torch.kvq import KVQuantSpec  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.config import param_count  # noqa: E402
from repro_torch.runtime import serve as TSV  # noqa: E402
from repro_torch.serving import Engine, Request  # noqa: E402

LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
MSGEMM = dict(mode="msgemm", d=3, scale_block=36)
NEW = ["codeqwen15_7b", "starcoder2_15b", "gpt3_175b", "qwen2_moe",
       "llama4_maverick"]
MOE = ["qwen2_moe", "llama4_maverick"]
DENSE = ["codeqwen15_7b", "starcoder2_15b", "gpt3_175b"]


@pytest.mark.parametrize("get", ["get_config", "get_smoke"])
@pytest.mark.parametrize("arch", configs.ARCHS)
def test_param_count_and_cells_equal_reference(arch, get):
    jcfg = getattr(j_configs, get)(arch)
    cfg = getattr(configs, get)(arch)
    assert param_count(cfg) == j_param_count(jcfg)
    assert shapes.cells(cfg) == j_shapes.cells(jcfg)
    assert cfg.num_groups == jcfg.num_groups


def test_input_specs_mirror_the_reference():
    cfg = configs.get_smoke("qwen2_moe")
    jcfg = j_configs.get_smoke("qwen2_moe")
    for name in shapes.SHAPES:
        got = shapes.input_specs(cfg, name, batch=2)
        want = j_shapes.input_specs(jcfg, name, batch=2)
        for key in ("tokens", "labels", "token", "pos"):
            assert (key in got) == (key in want)
            if key in got:
                assert tuple(got[key].shape) == tuple(want[key].shape)
        if "cache" in got:  # per layer here, stacked (G, ...) there
            one = want["cache"]["0:moe"]["k"]
            assert len(got["cache"]) == cfg.num_layers == one.shape[0]
            assert tuple(got["cache"][0]["k"].shape) == tuple(one.shape[1:])


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
@pytest.mark.parametrize("arch", ["whisper_medium", "phi3_vision"])
def test_frontend_input_specs_mirror_the_reference(arch, shape):
    """The enc-dec and vision configs' cells at full width: whisper's
    frames at seq_len and its 448-token decoder target, phi-3's patches
    ahead of seq_len - 576 text tokens (shapes and dtypes); the decode
    cache per layer here, stacked (G, ...) there, whisper's cross K/V at
    seq_len frames."""
    cfg, jcfg = configs.get_config(arch), j_configs.get_config(arch)
    got = shapes.input_specs(cfg, shape, batch=2)
    want = j_shapes.input_specs(jcfg, shape, batch=2)
    assert sorted(got) == sorted(want)
    for key, spec in got.items():
        if key == "cache":
            continue
        assert tuple(spec.shape) == tuple(want[key].shape), key
        assert str(spec.dtype).split(".")[1] == str(want[key].dtype), key
    if "cache" in got:
        assert len(got["cache"]) == cfg.num_layers
        ref = want["cache"]["0:attn"]
        for spec in got["cache"]:
            assert sorted(spec) == sorted(ref)
            for name, s in spec.items():
                assert (cfg.num_groups, *s.shape) == tuple(ref[name].shape)
                assert str(s.dtype).split(".")[1] == str(ref[name].dtype)
        if cfg.is_encdec:
            assert got["cache"][0]["cross_k"].shape[1] == 32768
            assert got["cache"][0]["k"].shape[1] == 448


@pytest.mark.parametrize("shape", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("arch", ["jamba_v01", "xlstm_1b3"])
def test_recurrent_decode_specs_mirror_the_reference(arch, shape):
    """The decode cells' inputs of the recurrent configs at full width:
    per layer here, stacked (G, ...) there — seq_len-deep K/V for
    jamba's attention layers, the recurrent states (shapes and dtypes)
    for the others."""
    cfg, jcfg = configs.get_config(arch), j_configs.get_config(arch)
    got = shapes.input_specs(cfg, shape, batch=2)
    want = j_shapes.input_specs(jcfg, shape, batch=2)
    for key in ("token", "pos"):
        assert tuple(got[key].shape) == tuple(want[key].shape)
    assert len(got["cache"]) == cfg.num_layers
    for layer, spec in enumerate(got["cache"]):
        i = layer % len(cfg.block_pattern)
        ref = want["cache"][f"{i}:{cfg.kind(layer)}"]
        assert sorted(spec) == sorted(ref)
        for name, s in spec.items():
            assert (cfg.num_groups, *s.shape) == tuple(ref[name].shape)
            assert str(s.dtype).split(".")[1] == str(ref[name].dtype)


@functools.lru_cache(maxsize=None)
def _pair(arch):
    """The reference's SMOKE params quantized for msgemm, and the port's
    model converted from them, with both configs."""
    spec = JSpec(**MSGEMM)
    jcfg = j_configs.get_smoke(arch)
    jp = j_quantize(JT.init_params(jax.random.PRNGKey(0), jcfg), jcfg, spec)
    jcfg = jcfg.replace(quant=spec)
    tcfg = convert.config_from_jax(jcfg)
    model = convert.params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                                    device="cpu")
    return jp, jcfg, model, tcfg


@pytest.mark.parametrize("arch", NEW)
def test_forward_logits_match_reference(arch):
    jp, jcfg, model, tcfg = _pair(arch)
    tokens = np.random.default_rng(1).integers(
        0, tcfg.vocab_size, size=(2, 11)).astype(np.int32)
    want, _ = JT.forward(jp, jcfg, {"tokens": jnp.asarray(tokens)})
    got = TT.forward(model, tcfg, torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)


def _prompts(cfg, lens=(13, 5, 20), seed=5):
    rng = np.random.default_rng(seed)
    return [tuple(int(t) for t in rng.integers(0, cfg.vocab_size, size=L))
            for L in lens]


def _serve(engine_cls, req_cls, params, cfg, prompts, **kw):
    eng = engine_cls(params, cfg, max_slots=2, block_size=8,
                     prefill_chunk=8, max_model_len=40, **kw)
    res = eng.run([req_cls(rid=i, prompt=p, max_new_tokens=6)
                   for i, p in enumerate(prompts)])
    return [res[i].generated for i in range(len(prompts))]


@pytest.mark.parametrize("kv", [None, 8], ids=["f32-pool", "kv8"])
@pytest.mark.parametrize("arch", MOE)
def test_moe_engine_matches_reference_engine(arch, kv):
    jp, jcfg, model, tcfg = _pair(arch)
    prompts = _prompts(tcfg)
    got = _serve(Engine, Request, model, tcfg, prompts,
                 kv_quant=None if kv is None else KVQuantSpec(kv))
    want = _serve(JEngine, JRequest, jp, jcfg, prompts,
                  kv_quant=None if kv is None else JKVSpec(kv))
    assert got == want


@pytest.mark.parametrize("arch", DENSE)
def test_dense_engine_matches_static_generate(arch):
    jp, jcfg, model, tcfg = _pair(arch)
    prompts = _prompts(tcfg)
    got = _serve(Engine, Request, model, tcfg, prompts)
    for p, seq in zip(prompts, got):
        ref = TSV.generate(model, tcfg, torch.tensor([p], dtype=torch.int32),
                           max_new_tokens=6)
        assert [int(t) for t in ref[0]] == seq
