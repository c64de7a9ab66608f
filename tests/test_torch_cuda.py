"""The msGeMM CUDA kernel against its plain PyTorch version, on the card.

Marked ``cuda``: skips without a GPU.  Imports torch only (the machine
with the card has no JAX); run there with
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py``.

Kernel and plain version share one op order, so results are bit-exact
with the identity epilogue (on random floats too) and within rtol = atol
= 1e-5 with gelu, whose tanh differs in the last ulps.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import packing  # noqa: E402
from repro_torch.kernels import msgemm as ms  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

SHAPES = [  # (d, scale_block, m, k, b)
    (1, 6, 13, 30, 5),
    (2, 4, 16, 24, 8),
    (3, 12, 64, 258, 1),
    (3, 9, 7, 129, 2),
    (4, 8, 24, 140, 4),
    (3, 36, 2048, 2048, 4),
    (3, 36, 600, 16384, 8),
]


@pytest.mark.cuda
@pytest.mark.parametrize("d,sb,m,k,b", SHAPES)
def test_cuda_kernel_matches_plain(d, sb, m, k, b):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    rng = np.random.default_rng(m + k)
    for exact in (True, False):
        codes = rng.integers(0, 16, size=(m, k)).astype(np.uint8)
        nsb = -(-k // sb)
        x = (rng.integers(-4, 5, size=(k, b)) if exact
             else rng.standard_normal((k, b))).astype(np.float32)
        sc = (2.0 ** rng.integers(-2, 3, size=(m, nsb)) if exact
              else np.abs(rng.standard_normal((m, nsb))) + 0.1) \
            .astype(np.float32)
        idx = packing.pack_indices(torch.from_numpy(codes), d).cuda()
        xt, st = torch.from_numpy(x).cuda(), torch.from_numpy(sc).cuda()
        res = torch.from_numpy(rng.standard_normal((m, b)).astype(np.float32)) \
            .cuda()
        tiles = ops.msgemm_tiles(m, idx.shape[1], b, d, sb)
        for act in ("none", "gelu"):
            kw = dict(d=d, scale_block=sb, tiles=tiles, act=act, residual=res)
            vals = packing.b_values(device="cuda")
            got = ms.msgemm_cuda(idx, xt, st, vals, **kw)
            want = ms.msgemm_plain(idx, xt, st, vals, **kw)
            torch.cuda.synchronize()
            if act == "none":
                assert torch.equal(got, want)
            else:
                torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
