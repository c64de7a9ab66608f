"""Encoder-decoder and vision training on a mesh against the port's
single-device step and the reference's ``repro.runtime.train.
train_step``, from the reference's init state, two steps of 4 x 16
tokens with ``microbatches=2`` and remat:

* whisper-medium (12 stub frames) on (data=2, model=2) and (pod=2,
  data=1, model=2): the encoder's non-causal blocks tensor-parallel
  over this rank's heads, the decoder's learned positions, its cross
  attention on this rank's heads of the encoder output;
* phi-3-vision on (data=2, model=2): its 8 patch embeddings ahead of the
  text, IGNORE labels over them;
* whisper-medium with 6 heads on (data=1, model=4), which cannot take
  'model': the encoder's, the decoder's and the cross attention's query
  positions split over it (the decoder's 16, the encoder's 12 frames, 3
  a rank, K and V of each rank's block gathered).

The residual splits over 'model' between blocks: the decoder's 16
positions (phi-3's 8 patches and 8 tokens), the encoder's 12 frames, a
block of each on every rank; the encoder's output gathered once for the
cross attentions.

Each step's loss, metrics, grad_norm (on every rank), every gradient,
m, v and params within the ``tests/torch_train_parity.py`` tolerances of
the single-device step from the same (gathered) state; step 1 within
them of the reference's; every rank issues the same collectives.  One
spawn of four gloo ranks runs every case (``tests/torch_train_ranks.
py``).
"""

import pytest

torch = pytest.importorskip("torch")
from torch_plan_isolation import (  # noqa: E402,F401  (autouse)
    isolated_plan_cache, isolated_plan_cache_module)
# one intra-op thread each: the suite runs in parallel workers
torch.set_num_threads(1)

import torch_train_mesh_check as C  # noqa: E402
import torch_train_ranks as R  # noqa: E402
from repro_torch.launch.mesh import run_ranks  # noqa: E402

STEPS = 2
MB, REMAT = {"microbatches": 2}, {"remat": True}
CASES = {
    "whisper_medium-d2m2": C.case("whisper_medium", (2, 2),
                                  ("data", "model"), MB, REMAT),
    "whisper_medium-p2d1m2": C.case("whisper_medium", (2, 1, 2),
                                    ("pod", "data", "model"), MB, REMAT),
    "phi3_vision-d2m2": C.case("phi3_vision", (2, 2), ("data", "model"),
                               MB, REMAT),
    "whisper_medium-h6-d1m4": C.case(
        "whisper_medium", (1, 4), ("data", "model"), MB,
        dict(REMAT, num_heads=6, num_kv_heads=6)),
}


@pytest.fixture(scope="module")
def ranks():
    weights, batches = C.inputs(CASES, STEPS)
    return run_ranks(R.cases_rank, R.WORLD, CASES, weights, batches,
                     timeout=300)


@pytest.mark.parametrize("key", CASES)
def test_mesh_step_matches_single_device(ranks, key):
    C.matches_single_device(ranks, key, CASES[key], STEPS)


@pytest.mark.parametrize("key", CASES)
def test_mesh_step_matches_reference(ranks, key):
    C.matches_reference(ranks, key, CASES[key], STEPS)


@pytest.mark.parametrize("key", CASES)
def test_ranks_issue_the_same_collectives(ranks, key):
    C.same_collectives(ranks, key)


@pytest.mark.parametrize("key", CASES)
def test_residual_enters_each_block_split(ranks, key):
    C.residual_blocks(ranks, key, CASES[key],
                      S_src=12 if key.startswith("whisper") else None)


def test_encoder_and_cross_attention_are_trained(ranks):
    """The mesh step reaches every weight of the encoder and of the cross
    attentions: each gets a nonzero gradient (its value is held to the
    single device's by ``test_mesh_step_matches_single_device``)."""
    rec = ranks[0]["whisper_medium-d2m2"]["steps"][0]
    names = [n for n in rec["grads"]
             if n.startswith("encoder.blocks.") or ".cross." in n]
    assert names
    assert all(abs(rec["grads"][n]).max() > 0 for n in names
               if n.endswith(".w")), names


def test_split_query_positions_in_encoder_and_cross_attention(ranks):
    """With 6 heads on model=4, every attention of the step splits its
    query positions: each of the encoder's and the decoder's self
    attentions and each cross attention gathers its block's K and V, in
    each microbatch's forward and its remat recompute, and its output
    stays on the block.  Each MLP gathers its normed input
    (``seq_in_gather``), as do the head and the encoder's output once a
    microbatch, and reduce-scatters its output where its hidden splits,
    as the vocab-split lookup does (``seq_out_scatter``; the decoder's
    remat recompute stops before a group's closing reduce-scatter)."""
    from repro_torch.distributed import collectives as coll
    from repro_torch.models import layers as L

    c = CASES["whisper_medium-h6-d1m4"]
    cfg = R.smoke(c["arch"], c["over"])
    counts = ranks[0]["whisper_medium-h6-d1m4"]["counts"]
    # the encoder runs outside remat; the decoder's groups inside it
    runs = c["tkw"]["microbatches"]
    attns = cfg.encoder_layers + 2 * 2 * cfg.num_layers
    mlps = cfg.encoder_layers + 2 * cfg.num_layers
    assert counts[L.SEQ_KV] == 2 * runs * attns
    assert counts[coll.SEQ_IN] == runs * (mlps + 2)
    once = cfg.encoder_layers + cfg.num_layers
    assert counts[coll.SEQ_OUT] == runs * (once * (cfg.d_ff % 4 == 0)
                                           + (cfg.vocab_size % 4 == 0))
    assert "seq_out_gather" not in counts
