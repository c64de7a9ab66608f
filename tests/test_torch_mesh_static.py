"""The static engine on a mesh, on the CPU (1 of 2): ``runtime.serve.
generate`` run SPMD by two gloo ranks on (model=2)
(``launch.mesh.run_ranks``; the rank body in
``tests/torch_mesh_ranks.py``, the cases in
``tests/torch_mesh_static_cases.py``), each rank on its ``shard_params``
copy, for the SMOKE configs of gemma-2b (MQA: one kv head, so the decode
cache splits its sequence over 'model') and jamba-v0.1 (Mamba, attention
and MoE blocks), msgemm weights at d=2 / scale_block=8 (every projection
splits on the boundary): tokens equal to the reference's
``repro.runtime.serve.generate`` on the same weights and inputs (exact),
every step's logits within 1e-4 of the port's single-device run; and
each again on (data=2) under the 'default' rules (FSDP weight storage,
the rows split), tokens equal to the reference's.  gemma-2b with 3
query heads, which cannot take 'model': its prefill splits the query
positions over it (a 32-token prompt, 16 a rank in chunks of 8), the
same checks.  Every prefill carries each rank's block of the residual's
positions between blocks (each block's input gathered at its entry, its
row-parallel output reduce-scattered back), and the tokens still equal
the reference's.
xlstm-1.3b, whisper-medium and phi-3-vision are in
``tests/test_torch_mesh_static_more.py``.
"""

import pytest

torch = pytest.importorskip("torch")
from torch_plan_isolation import (  # noqa: E402,F401  (autouse)
    isolated_plan_cache, isolated_plan_cache_module)

import torch_mesh_static_cases as C  # noqa: E402
from repro import configs as j_configs  # noqa: E402

# gemma-2b with 3 query heads over its kv head: a prompt of 32 tokens,
# in query chunks of 8
SEQ = ("gemma_2b-h3", "gemma_2b", dict(num_heads=3, attn_chunk=8), 32)
ARCHS = ("gemma_2b", "jamba_v01", SEQ[0])


@pytest.fixture(scope="module")
def cases():
    out = {arch: C.case(arch) for arch in ARCHS[:-1]}
    out[SEQ[0]] = C.case(SEQ[1], SEQ[2], SEQ[3])
    return out


@pytest.fixture(scope="module")
def ranks(cases):
    return C.run(cases)


@pytest.mark.parametrize("arch", ARCHS)
def test_static_generate_on_a_mesh_equals_reference(cases, ranks, arch):
    C.check(cases[arch][0], ranks, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_splits_the_residual(cases, ranks, arch):
    C.check_split(cases, ranks, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_static_generate_under_default_rules_equals_reference(cases, ranks,
                                                              arch):
    """The same weights stored cut over 'data' (the 'default' rules, FSDP)
    on a (data=2) mesh: tokens equal the reference's."""
    C.check_default(cases[arch][0], ranks, arch)


def test_split_sequence_decode_combines_partial_softmax(ranks):
    """gemma-2b's one kv head cannot take 'model': the decode cache splits
    its sequence, and each decode layer takes the max of the ranks'
    logits (all_reduce_max) and sums their exp-sums and values."""
    layers = j_configs.get_smoke("gemma_2b").num_layers
    counts = ranks[0]["gemma_2b"]["collectives"]
    assert counts["all_reduce_max"] == layers * (C.NEW - 1)


def test_fsdp_table_routes_equal_one_device(ranks):
    """A table stored cut over 'data': the lookup is exact by both routes
    (the looked-up activations gathered, or the table's columns), the
    tied head within 1e-6 of one device's (its partial logits summed
    over 'data' in another order), exact from the gathered columns."""
    for r in ranks:
        got = r["fsdp_table"]
        assert set(got) == {"embed-activations", "embed-table",
                            "head-partial", "head-table"}
        for route, (a, b) in got.items():
            assert a.shape == b.shape
            if route == "head-partial":
                assert float((a - b).abs().max()) <= 1e-6
            else:
                assert torch.equal(a, b), route


def test_prefill_splits_query_positions_where_heads_cannot(cases, ranks):
    """With 3 query heads on model=2 every rank holds the attention
    whole, and the prefill splits its 32 positions: each layer gathers
    its block's K and V once, and its output stays on the block; each
    MLP gathers its normed input (``seq_in_gather``) and reduce-scatters
    ``down``'s partial sums over the positions, as the vocab-split
    lookup does (``seq_out_scatter``); decode splits the cache's
    positions (the partial softmax combined) as for 4 heads."""
    from repro_torch.distributed import collectives as coll
    from repro_torch.models import layers as L

    cfg = cases[SEQ[0]][2]
    for r in ranks:
        counts = r[SEQ[0]]["collectives"]
        assert counts[L.SEQ_KV] == 2 * cfg.num_layers
        assert counts[coll.SEQ_IN] == cfg.num_layers
        assert counts[coll.SEQ_OUT] == cfg.num_layers + 1
        assert counts["all_reduce_max"] == cfg.num_layers * (C.NEW - 1)
        assert L.SEQ_KV not in r["gemma_2b"]["collectives"]
