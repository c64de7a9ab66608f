"""The port's int8 gradient compression (``repro_torch.optim.
compression``) against the reference's (``repro.optim.compression``):

* ``quantize_int8`` / ``dequantize_int8`` bit-exact with the reference on
  random, tiny, all-zero and one-hot inputs, and the round trip within
  half a scale;
* on 2 and 4 gloo ranks (one spawn of four: pod=2 x data=2 and pod=4),
  ``compressed_psum`` and ``compressed_pmean_tree`` (its mean and its
  residual, with a residual carried in and without one) bit-exact with
  the reference's functions run under ``jax.vmap(..., axis_name="pod")``
  on the ranks' inputs stacked in pod order.  The rank bodies are in
  ``tests/torch_train_ranks.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_train_ranks as R  # noqa: E402
from repro.optim import compression as J  # noqa: E402
from repro_torch.launch.mesh import run_ranks  # noqa: E402
from repro_torch.optim import compression as C  # noqa: E402

LEAVES = {"w": (6, 10), "b": (7,), "zero": (3, 4)}


def _inputs():
    g = np.random.default_rng(11)
    f32 = np.float32

    def draw(shape, scale):
        return [(g.standard_normal(shape) * scale).astype(f32)
                for _ in range(R.WORLD)]

    grads = {n: draw(s, 0.1) for n, s in LEAVES.items()}
    grads["zero"] = [np.zeros(LEAVES["zero"], f32)] * R.WORLD
    return {"x": draw((5, 9), 2.0), "grads": grads,
            "residual": {n: draw(s, 1e-3) for n, s in LEAVES.items()}}


@pytest.fixture(scope="module")
def ranks():
    inputs = _inputs()
    return inputs, run_ranks(R.compression_rank, R.WORLD, inputs, timeout=120)


@pytest.mark.parametrize("kind", ["normal", "tiny", "zeros", "onehot"])
def test_quantize_bit_exact_with_reference(kind):
    g = np.random.default_rng(5)
    x = {"normal": g.standard_normal((33, 17)) * 3,
         "tiny": g.standard_normal((8,)) * 1e-30,
         "zeros": np.zeros((4, 4)),
         "onehot": np.eye(5)[2]}[kind].astype(np.float32)
    q, s = C.quantize_int8(torch.from_numpy(x))
    jq, js = J.quantize_int8(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert float(s) == float(js)
    back = C.dequantize_int8(q, s).numpy()
    np.testing.assert_array_equal(back, np.asarray(J.dequantize_int8(jq, js)))
    assert np.abs(back - x).max() <= float(s) / 2


def _reference(inputs, group):
    """The reference under vmap over the ranks of ``group`` (pod order)."""
    def stack(v):
        return jnp.stack([jnp.asarray(v[r]) for r in group])

    x = stack(inputs["x"])
    grads = {n: stack(v) for n, v in inputs["grads"].items()}
    res = {n: stack(v) for n, v in inputs["residual"].items()}
    psum = jax.vmap(lambda a: J.compressed_psum(a, "pod"),
                    axis_name="pod")(x)
    mean, new = jax.vmap(lambda g, r: J.compressed_pmean_tree(g, "pod", r),
                         axis_name="pod")(grads, res)
    mean0, new0 = jax.vmap(lambda g: J.compressed_pmean_tree(g, "pod"),
                           axis_name="pod")(grads)
    return dict(psum=psum, mean=mean, residual=new, mean0=mean0,
                residual0=new0)


@pytest.mark.parametrize("key,groups", [
    ("pod2", [(0, 2), (1, 3)]),  # (pod, data) -> rank 2 * pod + data
    ("pod4", [(0, 1, 2, 3)]),
])
def test_compressed_reductions_bit_exact_with_reference(ranks, key, groups):
    inputs, res = ranks
    for group in groups:
        want = _reference(inputs, group)
        for i, r in enumerate(group):
            got = res[r][key]
            np.testing.assert_array_equal(got["psum"],
                                          np.asarray(want["psum"][i]))
            for part in ("mean", "residual", "mean0", "residual0"):
                for n in LEAVES:
                    np.testing.assert_array_equal(
                        got[part][n], np.asarray(want[part][n][i]),
                        err_msg=f"{key} rank {r} {part} {n}")
    # the mean is the ranks' mean within the quantization error
    for group in groups:
        for n in LEAVES:
            exact = np.mean([inputs["grads"][n][r] + inputs["residual"][n][r]
                             for r in group], axis=0)
            got = res[group[0]][key]["mean"][n]
            bound = max(np.abs(inputs["grads"][n][r]
                               + inputs["residual"][n][r]).max()
                        for r in group) / 127
            assert np.abs(got - exact).max() <= bound / 2 + 1e-7
