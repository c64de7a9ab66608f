"""Shared cases of the static-engine-on-a-mesh tests
(``tests/test_torch_mesh_static*.py``): the reference's SMOKE weights and
inputs of an architecture, its tokens from ``repro.runtime.serve.generate``,
and the checks of a two-rank (model=2) run of the port's ``generate``
(``tests/torch_mesh_ranks.static_rank``) against them."""

import jax
import jax.numpy as jnp
import numpy as np

import torch_mesh_ranks as R
from repro import configs as j_configs
from repro.core.spec import QuantSpec as JSpec
from repro.models import transformer as JT
from repro.quant import quantize_model as j_quantize
from repro.runtime import serve as JSV
from repro_torch import convert
from repro_torch.launch.mesh import run_ranks

SPEC = dict(mode="msgemm", d=2, scale_block=8)
B, T, NEW, FRAMES = 2, 6, 4, 8
# absolute, on SMOKE logits a few units in size: the mesh sums the same
# products in another order (row-parallel psums, the split-sequence
# softmax), which moves them by about 1e-6
LOGIT_TOL = 1e-4


def case(arch, over=None, prompt=T):
    """(reference tokens, numpy tree, port cfg, numpy batch) of ``arch``'s
    SMOKE config (with the config fields ``over``) with msgemm weights at
    :data:`SPEC`, prompts of ``prompt`` tokens."""
    jcfg = j_configs.get_smoke(arch).replace(**(over or {}))
    spec = JSpec(**SPEC)
    jp = jax.jit(lambda p: j_quantize(p, jcfg, spec))(
        JT.init_params(jax.random.PRNGKey(0), jcfg))
    jcfg = jcfg.replace(quant=spec)
    rng = np.random.default_rng(1)
    batch = {"tokens": rng.integers(0, jcfg.vocab_size,
                                    size=(B, prompt)).astype(np.int32)}
    if jcfg.is_encdec:
        batch["frames"] = rng.normal(
            size=(B, FRAMES, jcfg.d_model)).astype(np.float32)
    elif jcfg.frontend == "image_patches":
        batch["patch_embeds"] = rng.normal(
            size=(B, jcfg.num_patches, jcfg.d_model)).astype(np.float32)
    want = JSV.generate(jp, jcfg, {k: jnp.asarray(v)
                                   for k, v in batch.items()},
                        max_new_tokens=NEW)
    return (np.asarray(want), jax.tree.map(np.asarray, jp),
            convert.config_from_jax(jcfg), batch)


def run(cases):
    """Both ranks' results of every case, one spawn."""
    return run_ranks(R.static_rank, 2, {a: c[1:] for a, c in cases.items()},
                     NEW, (2,), ("model",), timeout=300)


def check(want, ranks, arch):
    """Every rank's tokens (single-device and mesh) equal the reference's,
    and each mesh step's logits are within :data:`LOGIT_TOL` of the
    single-device step's."""
    for r in ranks:
        got = r[arch]
        assert got["single"].tolist() == want.tolist()
        assert got["sharded"].tolist() == want.tolist()
        assert len(got["sharded_logits"]) == NEW
        for a, b in zip(got["sharded_logits"], got["single_logits"]):
            assert float((a - b).abs().max()) <= LOGIT_TOL
        assert got["collectives"].get("all_reduce", 0) > 0


def check_split(cases, ranks, arch):
    """The mesh run's prefill carried each rank's block of the residual:
    every prefill block's input held S/2 of the prompt's S positions (a
    vision frontend's patches counted) where S divides the two ranks, an
    encoder block's its frames' half; decode's one position each; the
    blocks' inputs gathered (``seq_in_gather``) and their row-parallel
    outputs reduce-scattered over the positions (``seq_out_scatter``)."""
    from repro_torch.distributed import collectives as coll

    _, _, cfg, batch = cases[arch]
    S = batch["tokens"].shape[1] + cfg.num_patches

    def part(n):
        return n // 2 if n % 2 == 0 else n

    want = {("prefill", part(S)), ("decode", 1)}
    if cfg.is_encdec:
        want.add(("encode", part(batch["frames"].shape[1])))
    assert S % 2 == 0
    for r in ranks:
        got = r[arch]
        assert set(map(tuple, got["blocks"])) == want, got["blocks"]
        assert got["collectives"][coll.SEQ_IN] > 0
        assert got["collectives"][coll.SEQ_OUT] > 0
        assert "seq_out_gather" not in got["collectives"]


def check_default(want, ranks, arch):
    """The (data=2) run under the 'default' rules: every rank's tokens
    equal the reference's, each step's logits (a rank's rows) are within
    :data:`LOGIT_TOL` of the single device's same rows, the blocks
    gathered their weights over 'data' every step, and a rank holds
    fewer weight bytes than under 'serve'."""
    for r in ranks:
        got = r[arch]
        assert got["default"].tolist() == want.tolist()
        assert len(got["default_logits"]) == NEW
        row = got["default_row"]
        for a, b in zip(got["default_logits"], got["single_logits"]):
            b = b[row:row + a.shape[0]]
            assert float((a - b).abs().max()) <= LOGIT_TOL
        assert got["default_collectives"]["fsdp_gather"] > 0
        assert got["resident"]["default"] < got["resident"]["serve"]
