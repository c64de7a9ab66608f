"""Training on a mesh (FSDP x TP; ``runtime.train`` on a state cut by
``sharding.shard_state``) against the port's single-device step and the
reference's ``repro.runtime.train.train_step``, on gemma-2b's SMOKE
config (MQA: one kv head, so wk, wv and the norms are whole on the model
axis while their consumers are split) and gemma2-9b's (local windows,
soft-caps), from the reference's init state, three steps of 4 x 16
tokens:

* meshes (data=2, model=2) and (pod=2, data=1, model=2), each without
  microbatches or remat and with ``microbatches=2`` and remat: each
  step's loss, metrics and grad_norm (on every rank), gradients (every
  leaf, gathered whole), m, v and params within the
  ``tests/torch_train_parity.py`` tolerances of the single-device step
  from the same state (gathered whole before the step); step 1 within
  them of the reference's;
* remat with ``save_gathered_weights`` computes the same and does not
  gather over 'data' again (remat alone gathers twice); ``fsdp_int8_gather``
  gives a finite step within 1% of the f32 gather's loss;
* every rank of a case issues the same collectives; the autograd
  collectives' outputs and gradients are exact;
* ``collectives.int8_all_gather``'s output equals the reference's
  ``dequantize_int8(*quantize_int8(...))`` of the gathered block
  exactly, and its gradient is the reduce-scatter of the ranks'
  cotangents, exactly;
* ``grad_compression="int8_pod"``: the mean over 'pod' of the pods'
  gradients, and the residual, bit-exact with the reference's
  ``compressed_pmean_tree`` under ``jax.vmap`` on the pod gradients
  (block by block of the model axis, as each rank reduces its block;
  XLA's flushed subnormals aside);
* every arch (qk-norm too) takes a mesh step on (data=2, model=2) that
  equals its single-device step, on every rank (the families' own mesh
  tests are ``test_torch_train_mesh_{moe,recurrent,encdec}.py``);
* where the query heads cannot take 'model' the query positions split
  over it (the reference's 'seq' rule): gemma-2b with 6 query heads over
  its one kv head on (data=1, model=4), and with 6 over 3 kv heads on
  (data=2, model=2), which group unevenly over a rank's 3 heads (once
  refused), with microbatches and remat; each step, every leaf's
  gradient among it, within the tolerances of the single device's, step
  1 of the reference's; 16 positions on (data=1, model=3) do not divide,
  so every rank runs every head there;
* between blocks each rank carries its block of the residual's
  positions (the reference's 'seq' rule, ``sharding.residual_axis``):
  on every rank of every case the residual entering each block holds
  S/M of its S positions, or all of them where S does not divide M
  (model=3); gemma-2b on (data=1, model=2) (the split alone, no FSDP;
  and with a 511-row table, whole on every rank) equals the single
  device's and the reference's steps; each block's
  normed input is gathered whole (``seq_in_gather``) and a row-parallel
  output reduce-scattered back (``seq_out_scatter``), counted exactly.

One spawn of four gloo ranks runs every case (``tests/torch_train_ranks.
py``).
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

import torch_train_mesh_check as C  # noqa: E402
import torch_train_parity as P  # noqa: E402
import torch_train_ranks as R  # noqa: E402
from repro.optim import compression as JC  # noqa: E402
from repro_torch.distributed import sharding  # noqa: E402
from repro_torch.launch.mesh import MeshShape, run_ranks  # noqa: E402

ARCHS = ("gemma_2b", "gemma2_9b")
MESHES = {"d2m2": ((2, 2), ("data", "model")),
          "p2d1m2": ((2, 1, 2), ("pod", "data", "model"))}
VARIANTS = {"plain": ({}, {"remat": False}),
            "mb2remat": ({"microbatches": 2}, {"remat": True})}
STEPS = 3  # of C.B x C.S tokens
CASES = {f"{a}-{m}-{v}": dict(arch=a, shape=MESHES[m][0], axes=MESHES[m][1],
                              tkw=VARIANTS[v][0], over=VARIANTS[v][1])
         for a in ARCHS for m in MESHES for v in VARIANTS}
EXTRA = {  # gemma-2b on (data=2, model=2): (TrainConfig, config fields)
    "remat": ({}, {"remat": True}),
    "saved": ({}, {"remat": True, "save_gathered_weights": True}),
    "int8gather": ({}, {"remat": False, "fsdp_int8_gather": True}),
}
for _k, (_t, _o) in EXTRA.items():
    CASES[f"gemma_2b-d2m2-{_k}"] = dict(arch="gemma_2b", shape=(2, 2),
                                        axes=("data", "model"), tkw=_t,
                                        over=_o)
CASES["gemma_2b-p2d1m2-int8pod"] = dict(
    arch="gemma_2b", shape=(2, 1, 2), axes=("pod", "data", "model"),
    tkw={"grad_compression": "int8_pod"}, over={"remat": False})
# query heads that cannot take 'model': the query positions split over it
SEQ_CASES = {
    "gemma_2b-h6-d1m4": C.case("gemma_2b", (1, 4), ("data", "model"),
                               over={"num_heads": 6, "remat": False}),
    "gemma_2b-h6kv3-d2m2": C.case(
        "gemma_2b", (2, 2), ("data", "model"), {"microbatches": 2},
        {"num_heads": 6, "num_kv_heads": 3, "remat": True}),
    # 16 positions over model=3 (of the four ranks): no split
    "gemma_2b-d1m3": C.case("gemma_2b", (1, 3), ("data", "model"),
                            over={"remat": False}),
}
# the residual split over 'model' alone, no FSDP; with 511 rows the
# table cannot split over the vocab, so every rank looks up every token
# and keeps its block of the positions
SPLIT_CASES = {"gemma_2b-d1m2": C.case("gemma_2b", (1, 2),
                                       ("data", "model"),
                                       over={"remat": False}),
               "gemma_2b-v511-d1m2": C.case(
                   "gemma_2b", (1, 2), ("data", "model"),
                   over={"remat": False, "vocab_size": 511})}


def _init(arch):
    """(reference config, reference init state, the port's weights and
    the 3 numpy batches)."""
    return C.init(arch, (), STEPS)


# every arch (and gemma-2b with qk-norm) takes one step on (data=2,
# model=2) in the same spawn
EVERY_ARCH = [
    ("qwen2_moe", {}), ("jamba_v01", {}), ("xlstm_1b3", {}),
    ("whisper_medium", {}), ("phi3_vision", {}),
    ("gemma_2b", {"qk_norm": True}),
    ("gemma_2b", {}), ("gemma2_9b", {}), ("codeqwen15_7b", {}),
    ("starcoder2_15b", {}), ("gpt3_175b", {}),
]


@pytest.fixture(scope="module")
def ranks():
    weights = {a: _init(a)[2] for a in ARCHS}
    batches = {a: _init(a)[3] for a in ARCHS}
    seq_weights, seq_batches = C.inputs({**SEQ_CASES, **SPLIT_CASES}, STEPS)
    return run_ranks(R.train_mesh_rank, R.WORLD,
                     {**CASES, **SEQ_CASES, **SPLIT_CASES},
                     {**weights, **seq_weights}, {**batches, **seq_batches},
                     EVERY_ARCH, timeout=300)


MAIN = [k for k in CASES if k.rsplit("-", 1)[1] in VARIANTS] + \
    ["gemma_2b-d2m2-remat", "gemma_2b-d2m2-saved"]


@pytest.mark.parametrize("key", MAIN)
def test_mesh_step_matches_single_device(ranks, key):
    """Each of the three mesh steps against the single-device step from
    the same (gathered) state, on the whole batch."""
    C.matches_single_device(ranks, key, CASES[key], STEPS)


@pytest.mark.parametrize("key", [k for k in CASES
                                 if k.rsplit("-", 1)[1] in VARIANTS])
def test_mesh_step_matches_reference(ranks, key):
    """Step 1 against ``repro.runtime.train.train_step`` (its gradients
    read back from its first moment, as ``torch_train_parity`` does)."""
    C.matches_reference(ranks, key, CASES[key], STEPS)


def test_ranks_issue_the_same_collectives(ranks):
    for key in CASES:
        counts = [res[key]["counts"] for res in ranks]
        assert counts[0] and all(c == counts[0] for c in counts), key
    # remat gathers each group's weights again in the backward pass;
    # saved gathered weights are not gathered again over 'data' (the
    # recompute still gathers the MQA kv weights over 'model': 2 a layer)
    gathers = {k: ranks[0][f"gemma_2b-d2m2-{k}"]["counts"]["all_gather"]
               for k in ("plain", "remat", "saved")}
    layers = 2
    assert gathers["saved"] == gathers["plain"] + 2 * layers \
        < gathers["remat"], gathers


def test_int8_fsdp_gather_step(ranks):
    got = [s["metrics"] for s in ranks[0]["gemma_2b-d2m2-int8gather"]["steps"]]
    f32 = [s["metrics"] for s in ranks[0]["gemma_2b-d2m2-plain"]["steps"]]
    for s in range(STEPS):
        assert np.isfinite(got[s]["loss"]) and np.isfinite(
            got[s]["grad_norm"])
        assert abs(got[s]["loss"] - f32[s]["loss"]) <= 1e-2 * f32[s]["loss"]
    assert got[0]["loss"] != f32[0]["loss"]  # the int8 weights did run


def test_autograd_collectives(ranks):
    """Over 'data' on (data=2, model=2), rank (d, m) holding x_d and
    cotangent c_d (exact small integers): the all-gather's gradient is
    the reduce-scatter of the ranks' cotangents (or, for replicated
    consumers, this rank's block of its own), the reduce-scatter's the
    all-gather of them, the psum's the cotangent itself and the
    identity's their sum."""
    for r, res in enumerate(ranks):
        d, m = r // 2, r % 2
        x = [R.ad_input(i, m, "x") for i in range(2)]
        c = [R.ad_input(i, m, "c") for i in range(2)]
        got = res["ad"]
        np.testing.assert_array_equal(got["all_gather"]["out"],
                                      np.concatenate(x))
        # each rank's cotangent covers the gathered rows: c_d twice
        np.testing.assert_array_equal(got["all_gather"]["grad"],
                                      c[0] + c[1])
        np.testing.assert_array_equal(got["all_gather_replicated"]["grad"],
                                      c[d])
        half = slice(2 * d, 2 * d + 2)
        np.testing.assert_array_equal(got["psum_scatter"]["out"],
                                      (x[0] + x[1])[half])
        np.testing.assert_array_equal(got["psum_scatter"]["grad"],
                                      np.concatenate([c[0][:2], c[1][:2]]))
        np.testing.assert_array_equal(got["psum"]["out"], x[0] + x[1])
        np.testing.assert_array_equal(got["psum"]["grad"], c[d])
        np.testing.assert_array_equal(got["identity"]["out"], x[d])
        np.testing.assert_array_equal(got["identity"]["grad"], c[0] + c[1])


@pytest.mark.parametrize("key", ["data", "data_model"])
def test_int8_all_gather_matches_reference(ranks, key):
    """The forward is the reference's quantize/dequantize of the block
    gathered over 'data' (its scale the pmax of the shards' maxima: over
    'data' only), exactly; the gradient under cotangents whose sum over
    the data ranks is ``arange`` is ``arange``'s block, exactly."""
    x = R.int8_input()
    for r, res in enumerate(ranks):
        got = res["int8"][key]
        cols = slice(None) if key == "data" else \
            slice((r % 2) * 3, (r % 2 + 1) * 3)
        want = np.asarray(JC.dequantize_int8(*JC.quantize_int8(
            jnp.asarray(x[:, cols]))))
        np.testing.assert_array_equal(got["out"], want, err_msg=f"rank {r}")
        np.testing.assert_array_equal(got["grad"], got["want_grad"])


def test_int8_pod_mean_matches_vmapped_reference(ranks):
    """On (pod=2, data=1, model=2), rank 2p + m holds pod p's gradients'
    model block m: the reference's ``compressed_pmean_tree`` over the
    two pods' blocks (vmapped), from a zero residual, gives the mesh
    step's mean and new residual bit for bit."""
    key = "gemma_2b-p2d1m2-int8pod"
    weights = _init("gemma_2b")[2]

    class Shape:
        shape = {"pod": 2, "data": 1, "model": 2}

    specs = sharding.param_specs(weights, Shape, "default")
    pods = [ranks[0][key]["steps"][0], ranks[2][key]["steps"][0]]
    for n, spec in specs.items():
        dim = next((i for i, e in enumerate(spec) if e == "model"), None)
        for m in range(2 if dim is not None else 1):
            def block(a):
                if dim is None:
                    return a
                size = a.shape[dim] // 2
                return np.take(a, range(m * size, (m + 1) * size), axis=dim)

            g = jnp.stack([jnp.asarray(block(p["pod_grads"][n]))
                           for p in pods])
            mean, res = jax.vmap(
                lambda t: JC.compressed_pmean_tree({"g": t}, "pod"),
                axis_name="pod")(g)
            np.testing.assert_array_equal(block(pods[0]["grads"][n]),
                                          np.asarray(mean["g"][0]),
                                          err_msg=n)
            for i, p in enumerate(pods):
                got, want = block(p["after"]["residual"][n]), \
                    np.asarray(res["g"][i])
                # XLA on the CPU flushes subnormal results to zero; torch
                # keeps them: bit-exact everywhere else (ROADMAP C)
                differ = got != want
                assert not differ.any() or (
                    np.abs(got[differ]) < np.finfo(np.float32).tiny).all() \
                    and (want[differ] == 0).all(), (n, got[differ][:4])
    plain = ranks[0]["gemma_2b-p2d1m2-plain"]["steps"][0]["metrics"]
    np.testing.assert_allclose(pods[0]["metrics"]["loss"], plain["loss"],
                               **P.TOL)


def test_moe_on_a_mesh_steps(ranks):
    """A MoE config takes a mesh step (where it was refused before its
    layouts trained): qwen2-moe on (data=2, model=2), expert-parallel,
    from ``init_state(..., mesh=)``: every rank's metrics the single
    device's, its aux terms among them."""
    want = R.arch_step("qwen2_moe", {})
    for res in ranks:
        got = res["archs"]["qwen2_moe-{}"]
        for k, v in want.items():
            np.testing.assert_allclose(got[k], v, **P.TOL, err_msg=k)
    assert want["load_balance"] > 0


@pytest.mark.parametrize("arch,over", EVERY_ARCH)
def test_every_arch_trains_on_a_mesh(ranks, arch, over):
    """``check_train_mesh`` accepts every arch on (data=2, model=2), and
    its mesh step (from ``init_state(..., mesh=)`` and the lcg stream's
    ``device_batch(..., mesh=)``) gives the single device's metrics on
    every rank."""
    from repro_torch import configs
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.models import transformer

    cfg = configs.get_smoke(arch).replace(**over)
    transformer.check_train_mesh(cfg, MeshShape({"data": 2, "model": 2}))
    want = R.arch_step(arch, over)
    for r, res in enumerate(ranks):
        got = res["archs"][f"{arch}-{over}"]
        assert all(np.isfinite(v) for v in got.values())
        for k, v in want.items():
            np.testing.assert_allclose(got[k], v, **P.TOL,
                                       err_msg=f"rank {r} {k}")


@pytest.mark.parametrize("key", SEQ_CASES)
def test_split_query_positions_match_single_device(ranks, key):
    C.matches_single_device(ranks, key, SEQ_CASES[key], STEPS)


@pytest.mark.parametrize("key", SEQ_CASES)
def test_split_query_positions_match_reference(ranks, key):
    C.matches_reference(ranks, key, SEQ_CASES[key], STEPS)


@pytest.mark.parametrize("key", SEQ_CASES)
def test_split_query_positions_collectives(ranks, key):
    """Every rank issues the same collectives; where the positions split,
    each attention layer gathers its block's K and V in each
    microbatch's forward (again in its remat recompute), and so does
    each MLP its normed input (``seq_in_gather``; the head's input once
    a microbatch, outside remat), whose ``down`` reduce-scatters its
    output over the positions where the hidden splits, as the vocab-split
    lookup does once a microbatch (``seq_out_scatter``; a remat
    recompute stops before a group's last op, so it issues none); the
    attention's output stays on the block (no gather of it).  Where they do not
    divide, none of these (on model=3 nothing of gemma-2b's SMOKE config
    splits: no collective at all)."""
    from repro_torch.distributed import collectives as coll
    from repro_torch.models import layers as L
    from repro_torch.models import transformer

    counts = [res[key]["counts"] for res in ranks if res[key] is not None]
    assert all(c == counts[0] for c in counts), key
    c = SEQ_CASES[key]
    cfg = R.smoke(c["arch"], c["over"])
    M = dict(zip(c["axes"], c["shape"]))["model"]
    transformer.check_train_mesh(cfg, MeshShape({"model": M}))
    assert not L.heads_split(cfg, M)
    counts = ranks[0][key]["counts"]
    kinds = (L.SEQ_KV, coll.SEQ_IN, coll.SEQ_OUT)
    if C.S % M:
        assert not set(kinds) & set(counts), counts
        return
    mb = c["tkw"].get("microbatches", 1)
    runs = mb * (2 if c["over"]["remat"] else 1)
    mlps = cfg.num_layers * runs
    assert counts[L.SEQ_KV] == 2 * mlps
    assert counts[coll.SEQ_IN] == mlps + mb
    assert counts[coll.SEQ_OUT] == cfg.num_layers * mb * (
        cfg.d_ff % M == 0) + mb * (cfg.vocab_size % M == 0)
    assert "seq_out_gather" not in counts


@pytest.mark.parametrize("key", SPLIT_CASES)
def test_split_residual_matches_single_device(ranks, key):
    C.matches_single_device(ranks, key, SPLIT_CASES[key], STEPS)


@pytest.mark.parametrize("key", SPLIT_CASES)
def test_split_residual_matches_reference(ranks, key):
    C.matches_reference(ranks, key, SPLIT_CASES[key], STEPS)


@pytest.mark.parametrize("key", [*CASES, *SEQ_CASES, *SPLIT_CASES])
def test_residual_enters_each_block_split(ranks, key):
    C.residual_blocks(ranks, key, {**CASES, **SEQ_CASES, **SPLIT_CASES}[key])
