"""Tensor-parallel serving in the training layout, on the CPU: the
continuous engine on (model=2) and on (data=2, model=2) meshes of gloo
ranks (``launch.mesh.run_ranks``; rank bodies in
``tests/torch_mesh_ranks.py``), on the reference's sharded-serving
config (``tests/test_sharded_serving.py``'s ``CFG``: d=2 /
scale_block=8, so every projection splits on the boundary).

* greedy tokens equal to the reference's single-device ``Engine`` for
  msgemm, int4_dequant and bf16 weights (exact: the same weights, the
  same tokens);
* a decode step issues no all-gather of a column-parallel output: wq,
  wk/wv, up and gate keep their outputs sharded into the row-parallel wo
  and down, whose psums are the step's all-reduces (with the vocab-split
  embedding's); its all-gathers are the logits' (the lm_head's vocab
  columns) and, where the rows split over 'data', the rows' (the new K/V
  rows and slots the pool takes whole, a layer; the logits the engine
  picks from).  Gathering every column-parallel output whole, the
  layout before this one, issued one all-gather a column-parallel linear
  on top.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_plan_isolation import (  # noqa: E402,F401  (autouse)
    isolated_plan_cache, isolated_plan_cache_module)

import jax  # noqa: E402

import torch_mesh_ranks as R  # noqa: E402
from repro.core.spec import QuantSpec as JSpec  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.config import ModelConfig as JModelConfig  # noqa: E402
from repro.quant import quantize_model as j_quantize  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.launch.mesh import run_ranks  # noqa: E402

CFG = JModelConfig(num_layers=2, d_model=32, num_heads=4, num_kv_heads=2,
                   d_ff=64, vocab_size=64, max_seq_len=64)
BASE = dict(max_slots=4, block_size=4, prefill_chunk=4, max_model_len=32)
MODES = ("msgemm", "int4_dequant", "bf16")
MESHES = {"model2": ((2,), ("model",)),
          "data2_model2": ((2, 2), ("data", "model"))}
NEW = 4


def _prompts(lens, seed):
    rng = np.random.default_rng(seed)
    return [tuple(int(t) for t in rng.integers(0, 64, size=L))
            for L in lens]


PROMPTS = _prompts((5, 9, 3, 7), 1)


def _tree(mode):
    params = JT.init_params(jax.random.PRNGKey(0), CFG)
    if mode == "bf16":
        return params, CFG
    spec = JSpec(mode=mode, d=2, scale_block=8,
                 storage="packed_u8" if mode == "int4_dequant"
                 else "packed_idx")
    return j_quantize(params, CFG, spec), CFG.replace(quant=spec)


@pytest.fixture(scope="module")
def models():
    """{mode: (jax params, reference cfg, numpy tree, port cfg)}."""
    out = {}
    for mode in MODES:
        jp, jcfg = _tree(mode)
        out[mode] = (jp, jcfg, jax.tree.map(np.asarray, jp),
                     convert.config_from_jax(jcfg))
    return out


@pytest.fixture(scope="module")
def reference(models):
    """The reference's single-device engine's tokens, by mode."""
    out = {}
    for mode, (jp, jcfg, _, _) in models.items():
        eng = JEngine(jp, jcfg, **BASE)
        res = eng.run([JRequest(rid=i, prompt=p, max_new_tokens=NEW)
                       for i, p in enumerate(PROMPTS)])
        out[mode] = {r: s.generated for r, s in res.items()}
    return out


@pytest.fixture(scope="module")
def runs(models):
    """Every rank's results on each mesh, one spawn a mesh."""
    trees = {m: v[2] for m, v in models.items()}
    tcfgs = {m: v[3] for m, v in models.items()}
    return {name: run_ranks(R.layout_rank, int(np.prod(shape)), trees,
                            tcfgs, shape, axes, BASE, PROMPTS, NEW,
                            timeout=300)
            for name, (shape, axes) in MESHES.items()}


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("mode", MODES)
def test_layout_tokens_equal_reference_single_device(models, reference,
                                                     runs, mesh, mode):
    for r in runs[mesh]:
        assert r[mode]["tokens"] == reference[mode]


@pytest.mark.parametrize("mesh", list(MESHES))
def test_decode_step_gathers_no_column_parallel_output(runs, mesh):
    """Every decode step's collectives by kind, on every rank and for
    every weight mode: one all-reduce for the embedding and one for each
    row-parallel wo and down; the all-gathers of the logits (and of the
    split rows) alone."""
    L = CFG.num_layers
    rows = mesh.startswith("data")
    want = {"all_reduce": 1 + 2 * L,
            "all_gather": 1 + (3 * L + 1 if rows else 0)}
    for r in runs[mesh]:
        for mode in MODES:
            decode = [c for name, c in r[mode]["steps"] if name == "decode"]
            assert decode, "no decode step ran"
            for counts in decode:
                assert counts == want, (mode, counts)


def test_layout_plans_are_column_and_row_parallel(runs):
    """The plans the engine resolved: wq, wk, wv, up and gate
    column-parallel, wo and down row-parallel over 'model'."""
    tags = {t for _, t in runs["model2"][0]["msgemm"]["plans"].values()
            if t is not None}
    assert any("/m=model/" in t for t in tags)
    assert any("/k=model/" in t for t in tags)
