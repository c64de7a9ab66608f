"""Port parity, the train step (``repro_torch.runtime.train``) on gemma-2b's
SMOKE config, and what every architecture's step must do.

* one ``train_step`` from the reference's converted state equals
  ``repro.runtime.train.train_step``'s (``torch_train_parity``: loss and
  metrics, every gradient, new params, m and v; rtol 1e-4, atol 1e-6);
* three steps on three batches: loss and every metric at each step
  within rtol 1e-4; the final params within it but for at most 1% of
  their elements, which stay within 3 lr (where a gradient sits within a
  few eps of zero, each Adam step can turn its last-bit noise into up to
  about lr of movement), and the final m and v within rtol 1e-3 (those
  params feed the later steps' gradients);
* ``microbatches=2`` with f32 accumulation (the tolerances above) and
  with bf16 accumulation: gradients and m within one bf16 ulp of their
  value (rtol 2^-7) plus one at the leaf's largest gradient (a
  microbatch's half-gradient rounds at its own magnitude before the two
  cancel), v within twice both;
* remat on against off, and the 'dots' policy, bit-equal on the CPU;
  under remat the recompute runs every block again while MoE
  ``route_counts`` and the calibration observer count once a forward;
* all eleven architectures (the twin of ``tests/test_archs_smoke.py``'s
  train step): the trainable leaves equal the reference param tree's in
  names (through ``convert.port_path``), count and shapes, and one
  ``train_step`` at SMOKE gives a finite positive loss and changes
  every trainable leaf class;
* a quantized model is refused; ``grad_compression`` other than 'none'
  and 'int8_pod' is a ValueError; ``convert.state_from_jax`` keeps bf16
  moments bf16.
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

from repro import configs as j_configs  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.optim import AdamWConfig as JAdamW  # noqa: E402
from repro.runtime import train as JRT  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.core import linear as qlinear  # noqa: E402
from repro_torch.core.spec import QuantSpec  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.quant import quantize_model  # noqa: E402
from repro_torch.runtime import train as RT  # noqa: E402
from torch_train_parity import (TOL, V_TOL, batch,  # noqa: E402
                                check_one_step, port_state, ref_leaves,
                                ref_state, ref_step, torch_batch)

BF16_GRAD = dict(rtol=2**-7, atol=1e-6)  # one bf16 ulp
BF16_V = dict(rtol=2**-6, atol=1e-12)  # a square: two
BF16_LEAF = 2**-7  # one bf16 ulp at the leaf's largest magnitude


def test_one_step_matches_reference():
    rep = check_one_step("gemma_2b")
    assert rep["leaves"] == 20 and rep["widened"] < 0.01 * rep["elements"]


def test_three_step_trajectory_matches_reference():
    jtcfg = JRT.TrainConfig(optimizer=JAdamW())
    jcfg, jstate = ref_state("gemma_2b", jtcfg)
    state, cfg = port_state(jstate, jcfg)
    step = ref_step(jcfg, jtcfg)
    tcfg = RT.TrainConfig()
    for seed in (1, 2, 3):
        b = batch(jcfg, seed=seed)
        jstate, jm = step(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        state, met = RT.train_step(state, torch_batch(b), cfg, tcfg)
        for k in jm:
            np.testing.assert_allclose(float(met[k]), float(jm[k]), **TOL,
                                       err_msg=f"step {seed} {k}")
    assert int(state["step"]) == 3 and int(state["opt"]["count"]) == 3
    for key, tol in (("m", dict(TOL, rtol=1e-3)),
                     ("v", dict(V_TOL, rtol=1e-3))):
        want = ref_leaves(jstate["opt"][key], cfg)
        for n, w in want.items():
            np.testing.assert_allclose(state["opt"][key][n].numpy(), w,
                                       **tol, err_msg=f"{key} {n}")
    want = ref_leaves(jstate["params"], cfg)
    bufs = dict(state["params"].named_buffers())
    lr = float(jm["lr"])
    off = total = 0
    for n, w in want.items():
        d = np.abs(bufs[n].numpy() - w)
        off += int((d > TOL["atol"] + TOL["rtol"] * np.abs(w)).sum())
        total += w.size
        assert d.max() <= 3 * lr, n
    assert off <= 0.01 * total, (off, total)


@pytest.mark.parametrize("accum,grad_tol,v_tol,leaf_rel", [
    ("float32", TOL, V_TOL, 0.0),
    ("bfloat16", BF16_GRAD, BF16_V, BF16_LEAF),
])
def test_microbatches_match_reference(accum, grad_tol, v_tol, leaf_rel):
    rep = check_one_step("gemma_2b", train=dict(
        microbatches=2, grad_accum_dtype=accum),
        grad_tol=grad_tol, v_tol=v_tol, leaf_rel=leaf_rel)
    assert rep["widened"] < 0.01 * rep["elements"]


def _smoke_state(arch="gemma_2b", **overrides):
    cfg = configs.get_smoke(arch).replace(**overrides)
    return RT.init_state(cfg, RT.TrainConfig(),
                         generator=torch.Generator().manual_seed(0),
                         device="cpu"), cfg


@pytest.mark.parametrize("policy", ["nothing", "dots"])
def test_remat_equals_no_remat(policy):
    b = torch_batch(batch(configs.get_smoke("gemma_2b")))
    out = {}
    for remat in (False, True):
        state, cfg = _smoke_state(remat=remat, remat_policy=policy)
        state, met = RT.train_step(state, b, cfg, RT.TrainConfig())
        out[remat] = (met, dict(state["params"].named_buffers()),
                      state["opt"])
    (m0, p0, o0), (m1, p1, o1) = out[False], out[True]
    for k in m0:
        assert torch.equal(m0[k], m1[k]), k
    for n in p0:
        assert torch.equal(p0[n], p1[n]), n
        assert torch.equal(o0["m"][n], o1["m"][n])
        assert torch.equal(o0["v"][n], o1["v"][n])


class _Counter:
    def __init__(self):
        self.n = 0

    def record(self, tag, x):
        self.n += 1


def test_remat_counts_side_effects_once(monkeypatch):
    """A remat recompute runs every block again, but MoE route counts and
    the calibration observer see one forward."""
    calls = []
    real = TT.block_apply

    def counted(*a, **kw):
        calls.append(qlinear.replaying())
        return real(*a, **kw)

    monkeypatch.setattr(TT, "block_apply", counted)
    b = torch_batch(batch(configs.get_smoke("qwen2_moe")))
    seen = {}
    for remat in (False, True):
        state, cfg = _smoke_state("qwen2_moe", remat=remat)
        model = state["params"]
        moe.reset_route_counts(model)
        calls.clear()
        obs = _Counter()
        qlinear.set_observer(obs)
        try:
            RT._grads(model, list(state["opt"]["m"]), cfg, RT.TrainConfig(),
                      b)
        finally:
            qlinear.set_observer(None)
        counts = torch.stack([m.route_counts for m in model.modules()
                              if isinstance(m, moe.MoE)])
        seen[remat] = (counts, obs.n, list(calls))
    counts0, n0, calls0 = seen[False]
    counts1, n1, calls1 = seen[True]
    L = configs.get_smoke("qwen2_moe").num_layers
    assert calls0 == [False] * L
    assert calls1 == [False] * L + [True] * L  # every block recomputed
    assert torch.equal(counts0, counts1) and int(counts1[:, 1].sum()) > 0
    assert n0 == n1 > 0
    assert not qlinear.replaying()


def _ref_tree_shapes(arch):
    jcfg = j_configs.get_smoke(arch)
    shapes = jax.eval_shape(lambda: JT.init_params(jax.random.PRNGKey(0),
                                                   jcfg))
    cfg = convert.config_from_jax(jcfg)
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        keys = "/".join(k.key for k in path)
        if "blocks" in keys.split("/")[:2]:
            for g in range(leaf.shape[0]):
                out[convert.port_path(keys, g, cfg)] = tuple(leaf.shape[1:])
        else:
            out[convert.port_path(keys, 0, cfg)] = tuple(leaf.shape)
    return out


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_every_arch_trains(arch):
    """The trainable leaves are the reference tree's; a SMOKE train step
    gives a finite loss and changes the params."""
    state, cfg = _smoke_state(arch)
    leaves = RT.trainable(state["params"])
    assert {n: tuple(t.shape) for n, t in leaves.items()} == \
        _ref_tree_shapes(arch)
    assert list(state["opt"]["m"]) == list(leaves)
    before = {n: t.clone() for n, t in leaves.items()}
    b = torch_batch(batch(cfg))
    state, met = RT.train_step(state, b, cfg, RT.TrainConfig())
    loss = float(met["loss"])
    assert np.isfinite(loss) and loss > 0, arch
    after = RT.trainable(state["params"])
    changed = [n for n in before if not torch.equal(before[n], after[n])]
    # every leaf the batch reaches moves (the sinusoid-fed encoder too)
    assert len(changed) == len(before), sorted(set(before) - set(changed))
    assert int(state["step"]) == 1


def test_quantized_model_refused():
    cfg = configs.get_smoke("gemma_2b")
    spec = QuantSpec(mode="msgemm", d=3, scale_block=36)
    with pytest.raises(ValueError, match="quantized"):
        RT.init_state(cfg.replace(quant=spec), RT.TrainConfig(),
                      generator=torch.Generator().manual_seed(0),
                      device="cpu")
    state, _ = _smoke_state()
    quantize_model(state["params"], spec)
    with pytest.raises(ValueError, match="quantized"):
        RT.trainable(state["params"])
    with pytest.raises(ValueError, match="quantized"):
        RT.train_step(state, torch_batch(batch(cfg)), cfg.replace(quant=spec),
                      RT.TrainConfig())
    with pytest.raises(ValueError, match="grad_compression"):
        RT.TrainConfig(grad_compression="int8_dcn")
    assert RT.TrainConfig(grad_compression="int8_pod").grad_compression \
        == "int8_pod"


def test_state_from_jax_keeps_bf16_moments():
    jtcfg = JRT.TrainConfig(optimizer=JAdamW(state_dtype="bfloat16"))
    jcfg, jstate = ref_state("gemma_2b", jtcfg)
    state, _ = port_state(jstate, jcfg)
    m = state["opt"]["m"]
    assert {t.dtype for t in m.values()} == {torch.bfloat16}
    assert list(m) == list(RT.trainable(state["params"]))
    assert int(state["opt"]["count"]) == 0 and int(state["step"]) == 0

