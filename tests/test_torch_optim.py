"""Port parity, the optimizer: ``repro_torch.optim`` against
``repro.optim`` on the same numpy inputs.

* ``schedules`` (constant, warmup_cosine, warmup_linear) equal the
  reference's at steps 0..120, within a few f32 ulps (5e-7 relative:
  the two packages' cos differ in the last bits);
* ``global_norm`` within 1e-6 relative;
* three ``adamw_update`` steps on a small random tree (a matrix, a
  vector, a scalar-like leaf, gradients that grow so clipping engages)
  equal the reference's new params and moments: f32 state within 1e-6
  (rtol, atol 1e-7); ``state_dtype="bfloat16"`` within one bf16 ulp
  (rtol 2^-7); with weight decay on and off and clipping on and off; an
  integer leaf is left as it was;
* the quadratic converges (the twin of ``tests/test_substrate.py``'s).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.optim import AdamWConfig as JAdamW  # noqa: E402
from repro.optim import adamw_init as j_init  # noqa: E402
from repro.optim import adamw_update as j_update  # noqa: E402
from repro.optim import schedules as j_sched  # noqa: E402
from repro.optim.adamw import global_norm as j_norm  # noqa: E402
from repro_torch.optim import (AdamWConfig, adamw_init,  # noqa: E402
                               adamw_update, global_norm, schedules)

F32 = dict(rtol=1e-6, atol=1e-7)
BF16 = dict(rtol=2**-7, atol=1e-7)  # one bf16 ulp
# a few f32 ulps: XLA's and torch's cos differ in the last bits
SCHED = dict(rtol=5e-7, atol=1e-12)


@pytest.mark.parametrize("name,args", [
    ("constant", (3e-3,)),
    ("warmup_cosine", (3e-3, 10, 100)),
    ("warmup_cosine", (1e-3, 0, 50)),
    ("warmup_linear", (2e-3, 10, 100)),
])
def test_schedules_match_reference(name, args):
    want_fn = getattr(j_sched, name)(*args)
    got_fn = getattr(schedules, name)(*args)
    for step in range(121):
        got = got_fn(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.shape == ()
        np.testing.assert_allclose(float(got), float(want_fn(step)), **SCHED)
        assert float(got_fn(step)) == float(got)  # a python int too


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"w": (rng.normal(size=(6, 5)) * scale).astype(np.float32),
            "b": (rng.normal(size=(5,)) * scale).astype(np.float32),
            "s": (rng.normal(size=(1,)) * scale).astype(np.float32)}


def test_global_norm_matches():
    g = _tree(0, 3.0)
    got = global_norm({k: torch.from_numpy(v) for k, v in g.items()})
    want = j_norm({k: jnp.asarray(v) for k, v in g.items()})
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
@pytest.mark.parametrize("grad_clip", [0.0, 1.0])
def test_adamw_update_matches_reference(state_dtype, weight_decay,
                                        grad_clip):
    kw = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=weight_decay,
              grad_clip=grad_clip, state_dtype=state_dtype)
    jcfg = JAdamW(lr=j_sched.warmup_cosine(1e-2, 2, 10), **kw)
    cfg = AdamWConfig(lr=schedules.warmup_cosine(1e-2, 2, 10), **kw)
    p0 = _tree(1)
    idx = np.arange(6, dtype=np.int32).reshape(2, 3)
    jp = {**{k: jnp.asarray(v) for k, v in p0.items()},
          "idx": jnp.asarray(idx)}
    tp = {**{k: torch.from_numpy(v.copy()) for k, v in p0.items()},
          "idx": torch.from_numpy(idx.copy())}
    jst, tst = j_init(jp, jcfg), adamw_init(tp, cfg)
    tol = F32 if state_dtype == "float32" else BF16
    for step in range(3):
        g = _tree(10 + step, scale=0.5 * 4**step)  # clipping engages
        jg = {**{k: jnp.asarray(v) for k, v in g.items()},
              "idx": jnp.zeros_like(jp["idx"])}
        tg = {**{k: torch.from_numpy(v) for k, v in g.items()},
              "idx": torch.zeros_like(tp["idx"])}
        jp, jst, jm = j_update(jg, jst, jp, jcfg)
        tp, tst, tm = adamw_update(tg, tst, tp, cfg)
        assert int(tst["count"]) == int(jst["count"]) == step + 1
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), **F32)
        for k in p0:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       **F32, err_msg=f"param {k}")
            for mom in ("m", "v"):
                got = tst[mom][k]
                assert got.dtype == getattr(torch, state_dtype)
                np.testing.assert_allclose(
                    got.float().numpy(),
                    np.asarray(jst[mom][k].astype(jnp.float32)), **tol,
                    err_msg=f"{mom} {k}")
        assert torch.equal(tp["idx"], torch.from_numpy(idx))  # frozen


def test_adamw_params_keep_their_dtype():
    cfg = AdamWConfig(lr=schedules.constant(0.1), state_dtype="bfloat16")
    p = {"w": torch.ones(4, dtype=torch.bfloat16)}
    st = adamw_init(p, cfg)
    p, st, _ = adamw_update({"w": torch.full((4,), 0.5)}, st, p, cfg)
    assert p["w"].dtype == torch.bfloat16
    assert st["m"]["w"].dtype == st["v"]["w"].dtype == torch.bfloat16
    assert float(p["w"][0]) < 1.0


def test_adamw_converges_quadratic():
    cfg = AdamWConfig(lr=schedules.constant(0.1), grad_clip=0.0)
    params = {"w": torch.tensor([3.0, -2.0])}
    state = adamw_init(params, cfg)
    for _ in range(200):
        w = params["w"].detach().requires_grad_(True)
        (g,) = torch.autograd.grad(torch.sum(w**2), w)
        params, state, _ = adamw_update({"w": g}, state, params, cfg)
    assert float(torch.sum(params["w"] ** 2)) < 1e-3

