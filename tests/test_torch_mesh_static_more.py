"""The static engine on a mesh, on the CPU (2 of 2; the first is
``tests/test_torch_mesh_static.py``): two gloo ranks on (model=2) for the
SMOKE configs of xlstm-1.3b (mLSTM heads split over 'model', the sLSTM
whole), whisper-medium (the encoder's and the cross attention's heads
split) and phi-3-vision (the patch embeddings whole on every rank):
tokens equal to the reference's ``repro.runtime.serve.generate``
(exact), every step's logits within 1e-4 of the port's single-device
run; and each again on (data=2) under the 'default' rules (FSDP weight
storage, the rows split), tokens equal to the reference's.  The
prefill carries each rank's block of the residual's positions (the
patches counted; the encoder's frames alike).
"""

import pytest

torch = pytest.importorskip("torch")
from torch_plan_isolation import (  # noqa: E402,F401  (autouse)
    isolated_plan_cache, isolated_plan_cache_module)

import torch_mesh_static_cases as C  # noqa: E402

ARCHS = ("xlstm_1b3", "whisper_medium", "phi3_vision")


@pytest.fixture(scope="module")
def cases():
    return {arch: C.case(arch) for arch in ARCHS}


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
