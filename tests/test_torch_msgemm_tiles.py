"""The msGeMM kernel's tile picker and its plain version at the picker's
tiles, on the CPU.

The picker (``repro_torch.kernels.ops.msgemm_tiles``) is a function of the
shape alone, so the CPU and the card take the same contraction split and
give the same bits; its invariants are checked here over the engine's
shapes and a grid of others.  The plain version (what the wrapper runs on
CPU tensors) is held against the JAX package's Pallas kernel in
interpret mode at the new tiles, and against itself on bf16 operands.

Tolerances: on exactly representable inputs (integer activations,
power-of-two scales) every sum is exact, so results must be bit-identical
whatever the op order; on random floats the plain version and the Pallas
kernel group the contraction differently (tile sizes), so they agree
within rtol = atol = 1e-5.  Widening bf16 to f32 is exact, so bf16
operands give the bits of their f32 copies.
"""

import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_plan_isolation import (  # noqa: E402,F401  (autouse)
    isolated_plan_cache, isolated_plan_cache_module)
# one intra-op thread each: the suite runs in parallel workers
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as j_ops  # noqa: E402
from repro_torch.core import packing  # noqa: E402
from repro_torch.core.epilogue import Epilogue  # noqa: E402
from repro_torch.kernels import msgemm as ms  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

# (m, k) of every engine GeMM (gemma-2b, gemma2-9b, the tied vocab head)
ENGINE = [(2048, 2048), (256, 2048), (16384, 2048), (2048, 16384),
          (4096, 3584), (2048, 3584), (3584, 4096), (14336, 3584),
          (3584, 14336), (256000, 2048), (256000, 3584)]
OTHER = [(1, 1), (7, 129), (100, 300), (511, 1000), (513, 90),
         (5000, 301), (70000, 64)]
PICKS = [(m, k, b, d, sb)
         for (m, k), b, (d, sb) in itertools.product(
             ENGINE + OTHER, (1, 2, 4, 5, 8, 16),
             ((1, 6), (2, 8), (3, 36), (3, 12), (4, 48)))]


def _picks():
    for m, k, b, d, sb in PICKS:
        kc = -(-k // d)
        yield (m, kc, b, d, sb), ops.msgemm_tiles(m, kc, b, d, sb)


def test_picker_invariants():
    """tj whole scale blocks, a variant the kernel builds, row and column
    tiles that cover the output, the stage sized to the row tile."""
    for (m, kc, b, d, sb), t in _picks():
        cpb = sb // d
        assert t.tj % cpb == 0, (m, kc, b, d, sb, t)
        ms.check_tiles(t, d, cpb)  # raises on a variant csrc/ lacks
        gx, gy, gz = ms.grid(m, kc, b, t)
        assert gx * t.rows >= m > (gx - 1) * t.rows
        assert gy == -(-kc // t.tj) and gz * t.tb >= b > (gz - 1) * t.tb
        assert t.rows * t.stage == ops.STAGE_WORDS
        assert t == ops.msgemm_tiles(m, kc, b, d, sb)  # shape alone


def test_split_fills_one_wave():
    """At the engine's decode shapes the contraction split keeps every SM
    busy without a second wave of full blocks."""
    for m, k in ENGINE[:9]:
        kc = -(-k // 3)
        t = ops.msgemm_tiles(m, kc, 4, 3, 36)
        gx, gy, gz = ms.grid(m, kc, 4, t)
        full = gx * gz * (gy if kc % t.tj == 0 else gy - 1)
        assert full <= ops.NUM_SMS, (m, k, t)
        assert gx * gz * gy > ops.NUM_SMS // 2 or t.tj == 12, (m, k, t)
    # the model the picker minimizes, on a hand-checked case: 16 row tiles
    # of 9 splits (8 of 84 chunks, one of 11) on 132 SMs
    assert ops._makespan(16, 1, [86] * 8 + [13], 132) == 86


def test_picker_shared_memory_fits():
    """Every (d, TB, rows, stage) the picker can return asks for at most
    the 232,448 bytes a block may use, by the Python mirror of the .cu
    formula."""
    seen = {(d, t.tb, t.rows, t.stage) for (_, _, _, d, _), t in _picks()}
    assert {v[0] for v in seen} == {1, 2, 3, 4}
    for v in seen:
        assert ms.smem_bytes(*v) <= 232_448, v
    # the d = 3 variant the picker takes for b > 1, and the terms
    assert ms.smem_bytes(3, 4, 1024, 8) == 4 * (
        2 * 4096 * 4 + 2 * 8 * 3 * 4 + 16 + 2 * 1024 * 12) == 230_208
    assert ms.smem_bytes(4, 1, 512, 16) == 4 * (
        2 * 16 * 4 + 16 + 2 * 512 * 20)


@pytest.mark.parametrize("bad", [
    dict(tb=8), dict(rows=768), dict(rows=256), dict(stage=12),
    dict(stage=2), dict(tj=13), dict(stage=32, rows=2048),
    dict(tb=4, d=4)])
def test_check_tiles_refuses(bad):
    d = bad.pop("d", 3)
    t = ms.Tiles(tb=4 if d < 4 else 1, rows=512, stage=16,
                 tj=12)._replace(**bad)
    with pytest.raises(ValueError, match="bad tiles"):
        ms.check_tiles(t, d, 12)


def _mk(rng, m, k, b, sb, d, exact):
    codes = rng.integers(0, 16, size=(m, k)).astype(np.uint8)
    if exact:
        x = rng.integers(-4, 5, size=(k, b)).astype(np.float32)
        sc = 2.0 ** rng.integers(-2, 3, size=(m, -(-k // sb)))
    else:
        x = rng.standard_normal((k, b))
        sc = np.abs(rng.standard_normal((m, -(-k // sb)))) + 0.1
    idx = packing.pack_indices(torch.from_numpy(codes), d)
    return codes, idx, x.astype(np.float32), sc.astype(np.float32)


@pytest.mark.parametrize("act", ["none", "gelu"])
def test_plain_bf16_engine_layout_equals_f32(act):
    """bf16 x and residual as the engine passes them (transposed views of
    (b, .) buffers) give the bits of the same call on f32 copies."""
    d, sb, m, k, b = 3, 36, 300, 700, 4
    rng = np.random.default_rng(5)
    _, idx, _, sc = _mk(rng, m, k, b, sb, d, exact=False)
    xb = torch.from_numpy(rng.standard_normal((b, k)).astype(np.float32)) \
        .to(torch.bfloat16)
    rb = torch.from_numpy(rng.standard_normal((b, m)).astype(np.float32)) \
        .to(torch.bfloat16)
    tiles = ops.msgemm_tiles(m, idx.shape[1], b, d, sb)
    kw = dict(d=d, scale_block=sb, tiles=tiles, act=act,
              out_dtype=torch.bfloat16)
    vals, st = packing.b_values(), torch.from_numpy(sc)
    got = ms.msgemm_plain(idx, xb.t(), st, vals, residual=rb.t(), **kw)
    want = ms.msgemm_plain(idx, xb.float().t().contiguous(), st, vals,
                           residual=rb.float().t().contiguous(), **kw)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want)
    # the public wrapper passes bf16 operands through unchanged
    got_ops = ops.msgemm(idx, xb.t(), d, scales=st, scale_block=sb,
                         tiles=tiles, residual=rb.t(),
                         epilogue=Epilogue(act=act, residual=True,
                                           out_dtype="bfloat16"))
    assert torch.equal(got_ops, want)


# kc = 101 chunks: not a multiple of any stage, and the last scale block
# (cpb = 4) holds one chunk
@pytest.mark.parametrize("tiles", [
    ms.Tiles(tb=4, rows=512, stage=32, tj=100),
    ms.Tiles(tb=4, rows=1024, stage=16, tj=8),
    ms.Tiles(tb=1, rows=2048, stage=8, tj=104),
], ids=["stage32-1split", "stage16-13splits", "rows2048-tb1"])
@pytest.mark.parametrize("exact", [True, False])
def test_plain_new_tiles_vs_pallas(tiles, exact):
    d, sb, m, k, b = 3, 12, 40, 301, 3
    rng = np.random.default_rng(9 + int(exact))
    codes, idx, x, sc = _mk(rng, m, k, b, sb, d, exact)
    assert idx.shape[1] % tiles.stage and idx.shape[1] % (sb // d) == 1
    got = ops.msgemm(idx, torch.from_numpy(x), d,
                     scales=torch.from_numpy(sc), scale_block=sb,
                     tiles=tiles).numpy()
    want = np.asarray(j_ops.msgemm(jnp.asarray(codes), jnp.asarray(x), d,
                                   scales=jnp.asarray(sc), scale_block=sb))
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
