"""Port parity, calibration of expert stacks and recurrent linears:
``repro_torch.calib.calibrate`` on a MoE model (the reference's
``MOE_CFG`` of ``tests/test_calib.py``) and on the SMOKE configs of
jamba-v0.1 (Mamba linears and 16-expert stacks) and xlstm-1.3b (the
``xl_*`` linears), against ``repro.calib.calibrate`` on the same numpy
weights and stream.

An expert stack is fitted one table an expert, from the statistics the
MoE block records under ``moe_<name>``; its codebook is (E, 16) for each
layer, the reference's (G, E, 16) being the scan-stacked form of the
same numbers (``convert.port_path`` maps slice g of a stacked path to
layer g's module).

Tolerances, each stated where it is used: fitted tables within one f32
ulp, and report errors within 1e-6 relative, of the reference's (both
fit in float64 and cast to float32); re-applied tables within 1e-6, as
the reference's own test.
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

from repro import calib as jcalib  # noqa: E402
from repro import configs as j_configs  # noqa: E402
from repro.core.spec import QuantSpec as JSpec  # noqa: E402
from repro.data.pipeline import DataConfig as JDataConfig  # noqa: E402
from repro.data.pipeline import SyntheticStream as JStream  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.config import ModelConfig as JModelConfig  # noqa: E402
from repro_torch import calib, convert, dispatch  # noqa: E402
from repro_torch.core.spec import QuantSpec as TSpec  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticStream  # noqa: E402
from repro_torch.quant import quantize_model  # noqa: E402
from repro_torch.runtime import serve as TSV  # noqa: E402
from repro_torch.serving import Engine, Request  # noqa: E402

ERR_TOL = dict(rtol=1e-6, atol=0)
QUANT = dict(mode="msgemm", d=3, scale_block=36)
# tests/test_calib.py's MoE config: two layers of four experts
MOE_CFG = JModelConfig(num_layers=2, d_model=32, num_heads=2,
                       num_kv_heads=2, d_ff=64, vocab_size=97,
                       max_seq_len=64, block_pattern=("moe",), num_experts=4,
                       num_experts_per_tok=2, moe_d_ff=48)


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


def _jcfg(name):
    return MOE_CFG if name == "moe" else j_configs.get_smoke(name)


@functools.lru_cache(maxsize=None)
def _calibrated(name):
    """(reference result, port result, dense port model, port cfg) of
    ``name``'s config, calibrated once for the module with the recipe of
    the reference's MoE test."""
    jcfg = _jcfg(name)
    jp = JT.init_params(jax.random.PRNGKey(3), jcfg)
    tcfg = convert.config_from_jax(jcfg)
    model = convert.params_from_jax(_np_tree(jp), tcfg, device="cpu")
    data = dict(vocab_size=jcfg.vocab_size, seq_len=16, global_batch=2)
    recipe = dict(calib_steps=1, kmeans_iters=6)
    want = jcalib.calibrate(jp, jcfg, JStream(JDataConfig(**data)),
                            jcalib.Recipe(**recipe), quant=JSpec(**QUANT))
    got = calib.calibrate(model, tcfg, SyntheticStream(DataConfig(**data)),
                          calib.Recipe(**recipe), quant=TSpec(**QUANT),
                          device="cpu")
    return want, got, model, tcfg


def _port_tables(want, got, tcfg):
    """[(port path, reference table (E?, 16), port table)] of every
    reference leaf slice g."""
    out = []
    for path, cb in want.codebooks.items():
        cb = np.asarray(cb)
        stacked = "experts" in path.split("/")
        flat = cb.reshape(-1, *cb.shape[-2 if stacked else -1:])
        for g in range(flat.shape[0]):
            ppath = convert.port_path(path, g, tcfg)
            out.append((path, ppath, flat[g], got.codebooks[ppath].numpy()))
    return out


@pytest.mark.parametrize("name", ["moe", "jamba_v01", "xlstm_1b3"])
def test_calibrate_matches_reference(name):
    """Every fitted table within one f32 ulp of the reference's, the
    per-leaf and aggregate errors within 1e-6 relative, as many tables
    (one a layer, and one an expert of a stack) as the reference fits."""
    want, got, _, tcfg = _calibrated(name)
    tables = _port_tables(want, got, tcfg)
    assert len(tables) == len(got.codebooks)
    for path, ppath, ref, mine in tables:
        np.testing.assert_array_max_ulp(mine, ref.astype(np.float32),
                                        maxulp=1)
    by_path: dict = {}
    for path, ppath, _, _ in tables:
        by_path.setdefault(path, []).append(ppath)
    for path, ppaths in by_path.items():
        for key in ("uniform_weighted_err", "learned_weighted_err"):
            mean = np.mean([got.report[p][key] for p in ppaths])
            np.testing.assert_allclose(mean, want.report[path][key],
                                       **ERR_TOL)
    for key, val in want.report["aggregate"].items():
        np.testing.assert_allclose(got.report["aggregate"][key], val,
                                   **ERR_TOL)
    agg = got.report["aggregate"]
    assert agg["learned_weighted_err"] < agg["uniform_weighted_err"]


def test_moe_expert_stacks_get_one_table_an_expert():
    """The twin of the reference's ``test_calibrate_moe_per_layer_codebooks``:
    each layer's expert stack carries (E, 16) tables and int4 codes under
    ``expert_spec``, ``quantize_model`` with the fitted tables reproduces
    them within 1e-6, and learned beats uniform."""
    want, got, model, tcfg = _calibrated("moe")
    for layer in range(2):
        path = f"blocks.{layer}.moe.experts.up"
        cb = got.codebooks[path]
        assert cb.shape == (4, 16)
        leaf = dict(got.params.named_modules())[path].params()
        assert set(leaf) == {"u8", "scales", "codebook"}
        assert leaf["u8"].shape[0] == 4 and torch.equal(leaf["codebook"], cb)
        np.testing.assert_allclose(
            cb.numpy(),
            np.asarray(want.codebooks["blocks/0:moe/moe/experts/up"])[layer],
            rtol=1e-6, atol=1e-6)
    # re-applying the fitted tables through quantize_model reproduces them
    import copy
    again = quantize_model(copy.deepcopy(model), got.quant,
                           codebooks=got.codebooks)
    mods = dict(again.named_modules())
    for path, cb in got.codebooks.items():
        np.testing.assert_allclose(mods[path].params()["codebook"].numpy(),
                                   cb.numpy(), rtol=1e-6)
    agg = got.report["aggregate"]
    assert agg["num_linears"] == want.report["aggregate"]["num_linears"]
    assert agg["learned_weighted_err"] < agg["uniform_weighted_err"]


def test_calibrated_moe_model_serves_on_int4_torch():
    """The calibrated MoE model serves: its learned expert stacks plan
    ``int4_torch`` (the int4 kernel takes no table), its dense linears
    keep msGeMM, and the continuous engine's greedy tokens equal static
    ``generate``'s."""
    _, got, _, tcfg = _calibrated("moe")
    qcfg = tcfg.replace(quant=got.quant)
    prompt = (5, 17, 3, 60, 81)
    with dispatch.collecting() as reqs:
        static = TSV.generate(got.params, qcfg, torch.tensor([prompt]),
                              max_new_tokens=5)
    stacks = {r.backend for r in reqs if r.experts}
    assert stacks == {"int4_torch"}
    assert {r.backend for r in reqs if not r.experts} <= {
        "msgemm_torch", "msgemm_cuda"}
    eng = Engine(got.params, qcfg, max_slots=2, block_size=4,
                 prefill_chunk=4, max_model_len=32)
    out = eng.run([Request(rid=0, prompt=prompt, max_new_tokens=5)])
    assert out[0].generated == [int(t) for t in static[0]]
