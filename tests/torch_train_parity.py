"""Shared helpers of the train-step parity tests (``test_torch_train*.py``):
one ``train_step`` of the port from the reference's converted state,
held against ``repro.runtime.train.train_step`` on the same numpy batch.

The reference's gradients are read back from its new first moment: from
zero moments, step 1 stores ``m = (1 - b1) * g * scale`` with ``scale =
min(1, clip / (grad_norm + 1e-9))``, so ``g = m / ((1 - b1) * scale)``
within a few f32 ulps; this saves compiling the reference's gradient
function beside its train step.

Tolerances (f32):

* loss, metrics, gradients and ``m``: rtol 1e-4, atol 1e-6; ``v`` holds
  squared gradients, so rtol 2e-4 (twice the gradients'), atol 1e-12;
* params: rtol 1e-4, atol 1e-6 plus ``lr`` times the difference of the
  two first steps' directions g / (|g| + eps) at the two packages' own
  (clipped) gradients: where a gradient sits within a few eps of zero,
  Adam's first step turns its last-bit noise into up to ``lr`` of
  movement (how many elements that widens past 1e-6 is returned).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import configs as j_configs
from repro.runtime import train as JRT
from repro_torch import convert
from repro_torch.runtime import train as RT

TOL = dict(rtol=1e-4, atol=1e-6)
V_TOL = dict(rtol=2e-4, atol=1e-12)


def batch(cfg, B=2, S=16, seed=1) -> dict:
    """numpy batch (the twin of ``tests/test_archs_smoke.py``'s): tokens
    and labels; whisper 12 stub frames; phi-3 its patches, S - P text
    tokens and IGNORE labels over the patches."""
    rng = np.random.default_rng(seed)
    b = {}
    if cfg.is_encdec:
        b["frames"] = rng.standard_normal((B, 12, cfg.d_model)).astype(
            np.float32)
    if cfg.frontend == "image_patches":
        P = cfg.num_patches
        b["patch_embeds"] = rng.standard_normal(
            (B, P, cfg.d_model)).astype(np.float32)
        b["tokens"] = rng.integers(0, cfg.vocab_size, (B, S - P)).astype(
            np.int32)
        labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
        labels[:, :P] = RT.IGNORE
        b["labels"] = labels
    else:
        b["tokens"] = rng.integers(0, cfg.vocab_size, (B, S)).astype(
            np.int32)
        b["labels"] = rng.integers(0, cfg.vocab_size, (B, S)).astype(
            np.int32)
    return b


def ref_leaves(tree, cfg) -> dict[str, np.ndarray]:
    """The reference tree's leaves under the port's names (``port_path``;
    a stacked leaf under ``blocks`` split into its layers)."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = "/".join(k.key for k in path)
        a = np.asarray(leaf)
        if "blocks" in keys.split("/")[:2]:
            for g in range(a.shape[0]):
                out[convert.port_path(keys, g, cfg)] = a[g]
        else:
            out[convert.port_path(keys, 0, cfg)] = a
    return out


@functools.lru_cache(maxsize=None)
def ref_step(jcfg, jtcfg):
    return jax.jit(functools.partial(JRT.train_step, cfg=jcfg, tcfg=jtcfg))


def ref_state(arch, jtcfg, **overrides):
    """(reference config, its init state from PRNGKey(0))."""
    jcfg = j_configs.get_smoke(arch)
    if overrides:
        jcfg = jcfg.replace(**overrides)
    return jcfg, JRT.init_state(jax.random.PRNGKey(0), jcfg, jtcfg)


def port_state(jstate, jcfg):
    cfg = convert.config_from_jax(jcfg)
    return convert.state_from_jax(jax.tree.map(np.asarray, jstate), cfg,
                                  device="cpu"), cfg


def torch_batch(b: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in b.items()}


def close_params(got: dict, want: dict, got_g: dict, want_g: dict,
                 lr: float, eps: float) -> int:
    """New params within TOL plus ``lr`` times the first step's direction
    difference at the clipped gradients ``got_g``/``want_g``; returns how
    many elements that term widened past TOL's atol."""
    widened = 0
    for n, w in want.items():
        g = got[n].detach().float().numpy()
        gp, gr = got_g[n].astype(np.float64), want_g[n].astype(np.float64)
        ds = np.abs(gp / (np.abs(gp) + eps) - gr / (np.abs(gr) + eps))
        extra = lr * ds * 1.01
        widened += int((extra > TOL["atol"]).sum())
        bound = TOL["atol"] + TOL["rtol"] * np.abs(w) + extra
        bad = np.abs(g - w) > bound
        assert not bad.any(), (n, g[bad][:4], w[bad][:4])
    return widened


def check_one_step(arch: str, seed: int = 1, train: dict | None = None,
                   grad_tol: dict = TOL, v_tol: dict = V_TOL,
                   leaf_rel: float = 0.0, **overrides) -> dict:
    """One train step of ``arch``'s SMOKE config, port against reference:
    the trainable leaves' names and shapes, loss and every metric, every
    gradient and ``m`` (within ``grad_tol``), ``v`` (``v_tol``), the new
    params.  ``leaf_rel`` widens the atol of a leaf's gradients, m and v
    by that share of the leaf's largest magnitude (``v``: twice it).
    ``train``: TrainConfig fields of both packages (``microbatches``,
    ``grad_accum_dtype``).  Returns a report."""
    from repro.optim import AdamWConfig as JAdamW

    train = train or {}
    jtcfg = JRT.TrainConfig(optimizer=JAdamW(), **train)
    jcfg, jstate = ref_state(arch, jtcfg, **overrides)
    b = batch(jcfg, seed=seed)
    new, jm = ref_step(jcfg, jtcfg)(jstate,
                                    {k: jnp.asarray(v) for k, v in b.items()})
    state, cfg = port_state(jstate, jcfg)
    names = list(state["opt"]["m"])
    want_p = ref_leaves(new["params"], cfg)
    shapes = {n: tuple(t.shape) for n, t in RT.trainable(
        state["params"]).items()}
    assert shapes == {n: a.shape for n, a in want_p.items()}
    tcfg = RT.TrainConfig(**train)
    tb = torch_batch(b)
    _, _, grads = RT._grads(state["params"], names, cfg, tcfg, tb)
    state, met = RT.train_step(state, tb, cfg, tcfg)
    assert list(met) == ["loss", "ce", "z_loss", "load_balance",
                         "dropped_frac", "grad_norm", "lr"]
    for k in met:
        np.testing.assert_allclose(float(met[k]), float(jm[k]), **TOL,
                                   err_msg=k)
    ocfg = jtcfg.optimizer
    gn = np.float32(jm["grad_norm"])
    scale = min(np.float32(1.0), np.float32(ocfg.grad_clip) / (gn + 1e-9))
    want_m = ref_leaves(new["opt"]["m"], cfg)
    want_v = ref_leaves(new["opt"]["v"], cfg)
    want_g = {n: m / np.float32((1 - ocfg.b1) * scale)
              for n, m in want_m.items()}
    def close(got, want, tol, rel, what):
        atol = tol["atol"] + rel * float(np.abs(want).max())
        np.testing.assert_allclose(got, want, rtol=tol["rtol"], atol=atol,
                                   err_msg=what)

    for n in names:
        close(grads[n].float().numpy(), want_g[n], grad_tol, leaf_rel,
              f"grad {n}")
        close(state["opt"]["m"][n].numpy(), want_m[n], grad_tol, leaf_rel,
              f"m {n}")
        close(state["opt"]["v"][n].numpy(), want_v[n], v_tol, 2 * leaf_rel,
              f"v {n}")
    bufs = dict(state["params"].named_buffers())
    got_scale = min(1.0, ocfg.grad_clip / (float(met["grad_norm"]) + 1e-9))
    n_small = close_params(
        bufs, want_p,
        {n: g.float().numpy() * got_scale for n, g in grads.items()},
        {n: g * scale for n, g in want_g.items()}, float(jm["lr"]),
        ocfg.eps)
    assert int(state["step"]) == int(new["step"]) == 1
    assert int(state["opt"]["count"]) == int(new["opt"]["count"]) == 1
    return {"leaves": len(names), "widened": n_small,
            "elements": sum(a.size for a in want_p.values())}
