"""qwen2-moe's SMOKE config (6 experts, a shared expert) served by the
continuous engine on a mesh of gloo ranks, on the CPU
(``launch.mesh.run_ranks``; the rank body in ``tests/torch_mesh_ranks.py``):
at model=2 expert-parallel (3 experts a rank), at model=4 each expert
tensor-parallel over its hidden dim (6 experts do not divide 4).  msgemm
weights at d=2 / scale_block=8 (the experts int4 under ``expert_spec``).
Tokens equal the port's single-device engine's, and the routed-slot
counters (kept, total) and ``dropped_frac`` equal the single-device
run's: every rank routes every token, and counts it once.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_plan_isolation import (  # noqa: E402,F401  (autouse)
    isolated_plan_cache, isolated_plan_cache_module)

import jax  # noqa: E402

import torch_mesh_ranks as R  # noqa: E402
from repro import configs as j_configs  # noqa: E402
from repro.core.spec import QuantSpec as JSpec  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.quant import quantize_model as j_quantize  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.launch.mesh import run_ranks  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.serving import Engine, Request  # noqa: E402

SPEC = dict(mode="msgemm", d=2, scale_block=8)
BASE = dict(max_slots=4, block_size=4, prefill_chunk=4, max_model_len=32)


def _prompts(lens, seed, vocab):
    rng = np.random.default_rng(seed)
    return [tuple(int(t) for t in rng.integers(0, vocab, size=L))
            for L in lens]


QWEN_PROMPTS = _prompts((5, 9, 3), 3, 512)


@pytest.fixture(scope="module")
def qwen():
    """qwen2-moe SMOKE: the numpy tree, the port's config, and its
    single-device engine's tokens and routed-slot counters."""
    cfg = j_configs.get_smoke("qwen2_moe")
    spec = JSpec(**SPEC)
    jp = j_quantize(JT.init_params(jax.random.PRNGKey(0), cfg), cfg, spec)
    tree = jax.tree.map(np.asarray, jp)
    tcfg = convert.config_from_jax(cfg.replace(quant=spec))
    model = convert.params_from_jax(tree, tcfg, device="cpu")
    eng = Engine(model, tcfg, **BASE)
    moe.reset_route_counts(model)
    res = eng.run([Request(rid=i, prompt=p, max_new_tokens=4)
                   for i, p in enumerate(QWEN_PROMPTS)])
    counts = torch.stack([m.route_counts for m in moe._moes(model)])
    return tree, tcfg, {r: s.generated for r, s in res.items()}, \
        counts.sum(0).tolist(), moe.dropped_frac(model)


@pytest.mark.parametrize("model_axis,layout", [(2, "ep"), (4, "tp")])
def test_qwen2_moe_smoke_on_a_mesh(qwen, model_axis, layout):
    tree, tcfg, tokens, counts, dropped = qwen
    assert moe.expert_layout(tcfg, _ShapeMesh(model_axis)) == layout
    ranks = run_ranks(R.moe_counts_rank, model_axis, tree, tcfg,
                      (model_axis,), ("model",), BASE, QWEN_PROMPTS, 4,
                      timeout=300)
    for r in ranks:
        assert r["tokens"] == tokens
        assert r["counts"] == counts
        assert r["dropped"] == dropped


class _ShapeMesh:
    """A mesh's axis sizes alone (what the layouts read)."""

    def __init__(self, model):
        self.shape = {"model": model}
        self.axis_names = ("model",)

    def get_local_rank(self, axis):
        return 0
