"""qwen2-moe's SMOKE config (6 experts, a shared expert) served by the
continuous engine on a mesh of gloo ranks, on the CPU
(``launch.mesh.run_ranks``; the rank body in ``tests/torch_mesh_ranks.py``):
at model=2 expert-parallel (3 experts a rank), at model=4 each expert
tensor-parallel over its hidden dim (6 experts do not divide 4), and
under the 'default' rules on data=2 (every rank all 6 experts' out-dim
block) and on (data=2, model=2) ('ep', 3 experts a rank, their out dim
over 'data'), where the expert stacks stay cut and the tokens move to
them.  One spawn of two ranks (model=2, data=2) and one of four (model=4,
data=2 x model=2).  msgemm weights at d=2 / scale_block=8 (the experts
int4 under ``expert_spec``).  Tokens equal the port's single-device
engine's, and the routed-slot counters (kept, total) and
``dropped_frac`` equal the single-device run's: every rank routes every
token, and counts it once.  Under 'default' no stack leaf is gathered
over 'data' (neither for a step, nor by any all-gather of the run) and
the token collectives are issued.
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


# (name, mesh shape, axes, rules) of each spawn's engines, by its ranks
SCENARIOS = {
    2: [("model2", (2,), ("model",), "serve"),
        ("data2", (2,), ("data",), "default")],
    4: [("model4", (4,), ("model",), "serve"),
        ("data2.model2", (2, 2), ("data", "model"), "default")],
}


@pytest.fixture(scope="module")
def spawns(qwen):
    """{ranks: every rank's results of that spawn's scenarios}."""
    tree, tcfg = qwen[:2]
    return {n: run_ranks(R.moe_counts_rank, n, tree, tcfg, SCENARIOS[n],
                         BASE, QWEN_PROMPTS, 4, timeout=300)
            for n in SCENARIOS}


def _same_as_one_device(qwen, runs):
    _, _, tokens, counts, dropped = qwen
    for r in runs:
        assert r["tokens"] == tokens
        assert r["counts"] == counts
        assert r["dropped"] == dropped


@pytest.mark.parametrize("model_axis,layout", [(2, "ep"), (4, "tp")])
def test_qwen2_moe_smoke_on_a_mesh(qwen, spawns, model_axis, layout):
    tcfg = qwen[1]
    assert moe.expert_layout(tcfg, _ShapeMesh(model_axis)) == layout
    _same_as_one_device(qwen, [r[f"model{model_axis}"]
                               for r in spawns[model_axis]])


@pytest.mark.parametrize("world,name", [(2, "data2"), (4, "data2.model2")])
def test_qwen2_moe_default_rules_move_tokens(qwen, spawns, world, name):
    """'default' serving: tokens, counters and dropped_frac the single
    device's; every stack held cut over 'data' on every rank, none among
    the leaves a step gathers nor gathered whole by any all-gather of the
    run, and the tokens' collectives (their slots gathered, the hidden
    gathered for ``down``, the outputs returned) issued."""
    runs = [r[name] for r in spawns[world]]
    _same_as_one_device(qwen, runs)
    for r in runs:
        assert r["data_out"] == [("up", "gate", "down")] * 2
        assert r["fsdp"] and not [k for k in r["fsdp"] if ".experts." in k]
        assert r["stacks_gathered"] == []
        for kind in ("expert_tokens", "expert_hidden", "expert_return"):
            assert r["collectives"].get(kind, 0) > 0, kind


class _ShapeMesh:
    """A mesh's axis sizes alone (what the layouts read)."""

    def __init__(self, model):
        self.shape = {"model": model}
        self.axis_names = ("model",)

    def get_local_rank(self, axis):
        return 0
