"""Port parity, kernel layer: the msGeMM kernel's plain PyTorch version
(what the wrapper runs on CPU tensors) against the JAX package's Pallas
kernel in interpret mode (``repro.kernels.ops.msgemm``) and its tile-replay
oracle (``repro.kernels.ref.msgemm_tiled_ref``).  The CUDA kernel itself
is held against the plain version in tests/test_torch_cuda.py.

Tolerances: on exactly representable inputs (integer activations,
power-of-two scales) every sum is exact, so results must be bit-identical
whatever the op order; on random floats the plain version and the Pallas
kernel group the contraction differently (tile sizes), so they agree
within rtol = atol = 1e-5.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_plan_isolation import (  # noqa: E402,F401  (autouse)
    isolated_plan_cache, isolated_plan_cache_module)
# one intra-op thread each: the suite runs in parallel workers
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.core.epilogue import Epilogue as JEpilogue  # noqa: E402
from repro.kernels import ops as j_ops  # noqa: E402
from repro.kernels import ref as j_ref  # noqa: E402
from repro_torch.core import packing  # noqa: E402
from repro_torch.core.epilogue import Epilogue  # noqa: E402
from repro_torch.kernels import msgemm as ms  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402


def _mk(rng, m, k, b, scale_block, exact):
    codes = rng.integers(0, 16, size=(m, k)).astype(np.uint8)
    if exact:
        x = rng.integers(-4, 5, size=(k, b)).astype(np.float32)
        sc = 2.0 ** rng.integers(-2, 3, size=(m, -(-k // scale_block)))
    else:
        x = rng.standard_normal((k, b))
        sc = np.abs(rng.standard_normal((m, -(-k // scale_block)))) + 0.1
    return codes, x.astype(np.float32), sc.astype(np.float32)


def _port(codes, x, sc, d, sb, **kw):
    idx = packing.pack_indices(torch.from_numpy(codes), d)
    cb = kw.pop("codebook", None)
    return ops.msgemm(idx, torch.from_numpy(x), d,
                      scales=torch.from_numpy(sc), scale_block=sb,
                      codebook=None if cb is None else torch.from_numpy(cb),
                      **kw)


def _f32(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else a,
                      np.float32)


# (d, scale_block, m, k, b): every d, ragged m/k/b, non-power-of-two and
# prime chunk counts, b = 1 decode shapes
SHAPES = [
    (1, 6, 13, 30, 5),
    (2, 4, 16, 24, 8),
    (2, 8, 40, 104, 3),
    (3, 6, 32, 90, 16),
    (3, 12, 64, 258, 1),
    (3, 9, 7, 129, 2),
    (4, 8, 24, 140, 4),
]


@pytest.mark.parametrize("d,sb,m,k,b", SHAPES)
def test_plain_bitexact_vs_pallas_and_tiled_ref(d, sb, m, k, b):
    rng = np.random.default_rng(d * 101 + m + k + b)
    codes, x, sc = _mk(rng, m, k, b, sb, exact=True)
    got = _port(codes, x, sc, d, sb).numpy()
    pallas = np.asarray(j_ops.msgemm(jnp.asarray(codes), jnp.asarray(x), d,
                                     scales=jnp.asarray(sc), scale_block=sb))
    tm, tj, tb = j_ops.msgemm_tiles(m, -(-k // d), b, d, sb)
    tiled = np.asarray(j_ref.msgemm_tiled_ref(
        jnp.asarray(codes), jnp.asarray(x), jnp.asarray(sc), d=d,
        scale_block=sb, tm=tm, tj=tj, tb=tb))
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, tiled)


@pytest.mark.parametrize("d,sb,m,k,b", SHAPES)
def test_plain_float_vs_pallas(d, sb, m, k, b):
    rng = np.random.default_rng(d * 77 + m + k + b)
    codes, x, sc = _mk(rng, m, k, b, sb, exact=False)
    got = _port(codes, x, sc, d, sb).numpy()
    want = np.asarray(j_ops.msgemm(jnp.asarray(codes), jnp.asarray(x), d,
                                   scales=jnp.asarray(sc), scale_block=sb))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


EPILOGUES = [
    dict(),
    dict(act="relu"),
    dict(act="gelu"),
    dict(act="silu"),
    dict(bias=True),
    dict(act="relu", bias=True),
    dict(residual=True),
    dict(act="gelu", bias=True, residual=True),
    dict(act="silu", residual=True, out_dtype="bfloat16"),
    dict(out_dtype="bfloat16"),
]


@pytest.mark.parametrize("epk", EPILOGUES, ids=lambda e: "-".join(
    f"{k}={v}" for k, v in e.items()) or "identity")
def test_plain_epilogues_vs_tiled_ref(epk):
    d, sb, m, k, b = 3, 6, 32, 90, 5
    rng = np.random.default_rng(EPILOGUES.index(epk))
    codes, x, sc = _mk(rng, m, k, b, sb, exact=True)
    bias = (rng.integers(-3, 4, size=m).astype(np.float32)
            if epk.get("bias") else None)
    res = (rng.integers(-3, 4, size=(m, b)).astype(np.float32)
           if epk.get("residual") else None)
    got = _port(codes, x, sc, d, sb, epilogue=Epilogue(**epk),
                bias=None if bias is None else torch.from_numpy(bias),
                residual=None if res is None else torch.from_numpy(res))
    tm, tj, tb = j_ops.msgemm_tiles(m, -(-k // d), b, d, sb)
    want = j_ref.msgemm_tiled_ref(
        jnp.asarray(codes), jnp.asarray(x), jnp.asarray(sc), d=d,
        scale_block=sb, tm=tm, tj=tj, tb=tb, epilogue=JEpilogue(**epk),
        bias=None if bias is None else jnp.asarray(bias),
        residual=None if res is None else jnp.asarray(res))
    assert str(got.dtype).removeprefix("torch.") == \
        (epk.get("out_dtype") or "float32")
    if epk.get("act", "none") in ("none", "relu"):
        np.testing.assert_array_equal(_f32(got), _f32(want))
    else:  # tanh/exp: the same formula, last-ulp differences allowed
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-5,
                                   atol=1e-5)


def test_plain_learned_codebook_vs_pallas():
    d, sb, m, k, b = 2, 8, 24, 40, 3
    rng = np.random.default_rng(12)
    codes, x, sc = _mk(rng, m, k, b, sb, exact=False)
    cb = np.concatenate([[0.0], np.sort(rng.uniform(-7, 7, 15))]) \
        .astype(np.float32)
    got = _port(codes, x, sc, d, sb, codebook=cb).numpy()
    want = np.asarray(j_ops.msgemm(jnp.asarray(codes), jnp.asarray(x), d,
                                   scales=jnp.asarray(sc), scale_block=sb,
                                   codebook=jnp.asarray(cb)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_plain_vector_x():
    rng = np.random.default_rng(1)
    codes, x, sc = _mk(rng, 8, 12, 1, 6, exact=False)
    got = _port(codes, x[:, 0], sc, 3, 6)
    assert got.shape == (8,)
    want = np.asarray(j_ops.msgemm(jnp.asarray(codes), jnp.asarray(x[:, 0]),
                                   3, scales=jnp.asarray(sc), scale_block=6))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("tj", [3, 6, 12, 30])
def test_split_changes_no_exact_result(tj):
    """The contraction split only regroups exact sums."""
    d, sb, m, k, b = 3, 9, 20, 90, 4
    rng = np.random.default_rng(4)
    codes, x, sc = _mk(rng, m, k, b, sb, exact=True)
    tiles = ms.Tiles(tb=4, rows=512, stage=16, tj=3)
    base = _port(codes, x, sc, d, sb, tiles=tiles).numpy()
    got = _port(codes, x, sc, d, sb, tiles=tiles._replace(tj=tj)).numpy()
    np.testing.assert_array_equal(got, base)


def test_hopper_tiles():
    """The picker at the engine's shapes: 1024-row blocks (512 for small
    m, 2048 for large ones at b = 1), the index stage sized to the row
    tile, tj whole scale blocks."""
    t = ops.msgemm_tiles(2048, 683, 4, 3, 36)
    assert (t.tb, t.rows, t.stage) == (4, 1024, 8)
    assert t.tj % 12 == 0 and -(-683 // t.tj) > 1  # split-K fills the card
    t = ops.msgemm_tiles(16384, 683, 4, 3, 36)
    assert (t.tb, t.rows, t.stage, t.tj) == (4, 1024, 8, 84)
    # wk/wv: one row tile; b = 1 reads one column, in 2048-row blocks for
    # the large GeMMs
    t = ops.msgemm_tiles(256, 683, 1, 3, 36)
    assert (t.tb, t.rows) == (1, 512)
    assert ops.msgemm_tiles(2048, 683, 1, 3, 36).rows == 1024
    assert ops.msgemm_tiles(16384, 683, 1, 3, 36)[:3] == (1, 2048, 4)
    assert ops.msgemm_tiles(2048, 5462, 1, 3, 36).rows == 2048
    # b = 8 runs as two column tiles of 4
    assert ops.msgemm_tiles(2048, 683, 8, 3, 36).tb == 4
    # a vocab-sized m already fills the card: no split
    t = ops.msgemm_tiles(256000, 683, 8, 3, 36)
    assert -(-683 // t.tj) == 1
    # d = 4: one column a table
    assert ops.msgemm_tiles(2048, 500, 4, 4, 48)[:2] == (1, 1024)


def test_wrapper_routes_by_device_without_fallback():
    rng = np.random.default_rng(2)
    codes, x, sc = _mk(rng, 8, 12, 2, 6, exact=True)
    idx = packing.pack_indices(torch.from_numpy(codes), 3)
    args = (idx, torch.from_numpy(x), torch.from_numpy(sc),
            packing.b_values())
    kw = dict(d=3, scale_block=6, tiles=ops.msgemm_tiles(8, 4, 2, 3, 6))
    before = ms.launches
    ms.msgemm(*args, **kw)  # CPU tensors: the plain version, no launch
    assert ms.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        ms.msgemm_cuda(*args, **kw)  # the kernel never takes CPU tensors
    with pytest.raises(ValueError, match="unsupported device"):
        ms.msgemm(*(a.to("meta") for a in args), **kw)
    with pytest.raises(ValueError, match="scales"):
        ms.msgemm_plain(args[0], args[1], args[2][:, :1], args[3], **kw)
