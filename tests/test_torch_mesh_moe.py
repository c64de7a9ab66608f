"""MoE blocks served on a mesh, on the CPU (gloo ranks of
``launch.mesh.run_ranks``; rank bodies in ``tests/torch_mesh_ranks.py``):

* the twin of the reference's ``test_sharded_moe_token_identity``
  (``tests/test_sharded_serving.py``): its ``MOE_CFG`` (4 experts, top 2)
  with msgemm weights at d=2 / scale_block=8 from seed 2, prompts (4, 8,
  6) from seed 2, five new tokens, the continuous engine on a (data=2,
  model=4) mesh — expert-parallel, one expert a rank; its tokens equal
  the reference's single-device engine's (exact);
* qwen2-moe's SMOKE config on a mesh: ``tests/test_torch_mesh_moe_qwen.py``.
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

MOE_CFG = JModelConfig(num_layers=2, d_model=32, num_heads=4,
                       num_kv_heads=2, d_ff=64, vocab_size=64,
                       max_seq_len=64, block_pattern=("attn", "moe"),
                       num_experts=4, num_experts_per_tok=2)
SPEC = dict(mode="msgemm", d=2, scale_block=8)
BASE = dict(max_slots=4, block_size=4, prefill_chunk=4, max_model_len=32)


def _prompts(lens, seed, vocab):
    rng = np.random.default_rng(seed)
    return [tuple(int(t) for t in rng.integers(0, vocab, size=L))
            for L in lens]


def _quantized(cfg, seed):
    spec = JSpec(**SPEC)
    jp = j_quantize(JT.init_params(jax.random.PRNGKey(seed), cfg), cfg,
                    spec)
    jcfg = cfg.replace(quant=spec)
    return jp, jcfg, jax.tree.map(np.asarray, jp), \
        convert.config_from_jax(jcfg)


def test_sharded_moe_token_identity():
    jp, jcfg, tree, tcfg = _quantized(MOE_CFG, 2)
    prompts = _prompts((4, 8, 6), 2, 64)
    jres = JEngine(jp, jcfg, **BASE).run(
        [JRequest(rid=i, prompt=p, max_new_tokens=5)
         for i, p in enumerate(prompts)])
    want = {r: s.generated for r, s in jres.items()}
    ranks = run_ranks(R.layout_rank, 8, {"moe": tree}, {"moe": tcfg},
                      (2, 4), ("data", "model"), BASE, prompts, 5,
                      timeout=300)
    for r in ranks:
        assert r["moe"]["tokens"] == want
