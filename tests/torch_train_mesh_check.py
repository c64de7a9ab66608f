"""Shared checks of the mesh-training tests (``test_torch_train_mesh*.py``):
a case is one mesh run of ``tests/torch_train_ranks.run_case`` (an
arch's SMOKE config with field overrides ``over``, a mesh ``shape`` /
``axes``, TrainConfig fields ``tkw``) from the reference's init state;
each of its steps is held to the port's single-device step from the same
(gathered) state on the whole batch, and its first step to the
reference's single-device ``repro.runtime.train.train_step``, within the
``tests/torch_train_parity.py`` tolerances.
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np
import torch

import torch_mesh_ranks as MR
import torch_train_parity as P
import torch_train_ranks as R
from repro.optim import AdamWConfig as JAdamW
from repro.runtime import train as JRT
from repro_torch.runtime import train as RT

B, S = 4, 16


def case(arch, shape, axes, tkw=None, over=None, **extra):
    return dict(arch=arch, shape=shape, axes=axes, tkw=tkw or {},
                over=over or {}, **extra)


def _items(d: dict) -> tuple:
    return tuple(sorted(d.items()))


@functools.lru_cache(maxsize=None)
def init(arch, over_items=(), steps: int = 3):
    """(reference config, reference init state, the port's weights and
    ``steps`` numpy batches) of ``arch`` with the config fields
    ``over_items``."""
    jcfg, jstate = P.ref_state(arch, JRT.TrainConfig(optimizer=JAdamW()),
                               **dict(over_items))
    state, _ = P.port_state(jstate, jcfg)
    weights = {n: t.numpy().copy()
               for n, t in state["params"].state_dict().items()}
    batches = [P.batch(jcfg, B=B, S=S, seed=1 + s) for s in range(steps)]
    return jcfg, jstate, weights, batches


def inputs(cases: dict, steps: int):
    """({case key: weights}, {case key: batches}) for ``run_ranks``."""
    made = {k: init(c["arch"], _items(c["over"]), steps)
            for k, c in cases.items()}
    return ({k: v[2] for k, v in made.items()},
            {k: v[3] for k, v in made.items()})


def single_step(c: dict, k: int, before: dict, steps: int) -> dict:
    """The port's single-device step ``k`` (0-based) of case ``c`` from
    the whole state ``before``: its gradients, metrics, routed slots
    (kept, all; None without MoE blocks) and the state after."""
    jcfg, jstate, _, batches = init(c["arch"], _items(c["over"]), steps)
    state, cfg = P.port_state(jstate, jcfg)
    over = {n: v for n, v in c["over"].items()
            if n not in ("save_gathered_weights", "fsdp_int8_gather")}
    cfg = cfg.replace(**over)
    tcfg = R.train_config({n: v for n, v in c["tkw"].items()
                           if n != "grad_compression"})
    state["params"].load_state_dict({n: torch.from_numpy(a.copy()) for n, a
                                     in before["params"].items()})
    for key in ("m", "v"):
        state["opt"][key] = {n: torch.from_numpy(a.copy())
                             for n, a in before[key].items()}
    state["opt"]["count"] = torch.tensor(before["count"], dtype=torch.int32)
    tb = P.torch_batch(batches[k])
    _, _, g = RT._grads(state["params"], list(state["opt"]["m"]), cfg, tcfg,
                        tb)
    routes = MR.route_counts(state["params"])
    state, met = RT.train_step(state, tb, cfg, tcfg)
    if routes is not None:
        routes = [a - b for a, b in zip(MR.route_counts(state["params"]),
                                        routes)]
    return {"grads": {n: t.numpy() for n, t in g.items()},
            "metrics": {n: float(v) for n, v in met.items()},
            "routes": routes,
            "after": {"params": {n: t.numpy() for n, t in
                                 state["params"].state_dict().items()},
                      **{k: {n: t.numpy() for n, t in state["opt"][k].items()}
                         for k in ("m", "v")},
                      "count": int(state["opt"]["count"])}}


def close(got, want, tol, what, names=None):
    for n in names or want:
        np.testing.assert_allclose(got[n], want[n], **tol,
                                   err_msg=f"{what} {n}")


def _direction(m, v, k):
    """Adam's direction at step ``k`` from its moments after the step."""
    ocfg = JAdamW()
    mh = m.astype(np.float64) / (1 - ocfg.b1 ** k)
    vh = v.astype(np.float64) / (1 - ocfg.b2 ** k)
    return mh / (np.sqrt(vh) + ocfg.eps)


def check_params(got, want, lr):
    """Params after a step from the same state within TOL plus ``lr`` times
    the difference of the two steps' directions (read off the moments,
    which are held to TOL themselves): where a gradient sits near zero,
    Adam turns its last-bit noise into up to ``lr`` of movement (as
    ``torch_train_parity.close_params``)."""
    k = want["count"]
    assert got["count"] == k
    for name, w in want["params"].items():
        extra = np.abs(_direction(got["m"][name], got["v"][name], k)
                       - _direction(want["m"][name], want["v"][name], k)
                       ) * lr * 1.01
        g = got["params"][name]
        bad = np.abs(g - w) > P.TOL["atol"] + P.TOL["rtol"] * np.abs(w) \
            + extra
        assert not bad.any(), (name, k, g[bad][:4], w[bad][:4])


def matches_single_device(ranks, key: str, c: dict, steps: int) -> None:
    """Each mesh step of case ``key`` against the single-device step from
    the same (gathered) state, on the whole batch: every rank's metrics,
    the gradients, m, v and the params."""
    for k, rec in enumerate(ranks[0][key]["steps"]):
        want = single_step(c, k, rec["before"], steps)
        for r, res in enumerate(ranks):
            if res[key] is None:  # not a rank of this case's mesh
                continue
            for name, v in want["metrics"].items():
                np.testing.assert_allclose(
                    res[key]["steps"][k]["metrics"][name], v, **P.TOL,
                    err_msg=f"rank {r} step {k + 1} {name}")
        close(rec["grads"], want["grads"], P.TOL, f"step {k + 1} grad")
        close(rec["after"]["m"], want["after"]["m"], P.TOL,
              f"step {k + 1} m")
        close(rec["after"]["v"], want["after"]["v"], P.V_TOL,
              f"step {k + 1} v")
        check_params(rec["after"], want["after"], want["metrics"]["lr"])


@functools.lru_cache(maxsize=None)
def reference(arch, over_items, tkw_items, steps: int):
    """The reference's first step of ``arch`` (config fields
    ``over_items``, TrainConfig fields ``tkw_items``): (new state,
    metrics)."""
    jcfg, jstate, _, batches = init(arch, over_items, steps)
    jtcfg = JRT.TrainConfig(optimizer=JAdamW(), **dict(tkw_items))
    new, jm = P.ref_step(jcfg, jtcfg)(
        jstate, {k: jnp.asarray(v) for k, v in batches[0].items()})
    return new, {k: float(v) for k, v in jm.items()}


def matches_reference(ranks, key: str, c: dict, steps: int) -> None:
    """Step 1 of case ``key`` against ``repro.runtime.train.train_step``
    (its gradients read back from its first moment, as
    ``torch_train_parity`` does)."""
    from repro_torch import convert

    over = _items({n: v for n, v in c["over"].items()
                   if n not in ("remat", "save_gathered_weights",
                                "fsdp_int8_gather")})
    jcfg = init(c["arch"], _items(c["over"]), steps)[0]
    cfg = convert.config_from_jax(jcfg)
    new, jm = reference(c["arch"], over, _items(c["tkw"]), steps)
    got = ranks[0][key]["steps"][0]
    for k, v in jm.items():
        np.testing.assert_allclose(got["metrics"][k], v, **P.TOL, err_msg=k)
    ocfg = JAdamW()
    gn = np.float32(jm["grad_norm"])
    scale = min(np.float32(1.0), np.float32(ocfg.grad_clip) / (gn + 1e-9))
    want_m = P.ref_leaves(new["opt"]["m"], cfg)
    want_g = {n: m / np.float32((1 - ocfg.b1) * scale)
              for n, m in want_m.items()}
    close(got["grads"], want_g, P.TOL, "grad")
    close(got["after"]["m"], want_m, P.TOL, "m")
    close(got["after"]["v"], P.ref_leaves(new["opt"]["v"], cfg), P.V_TOL,
          "v")
    got_scale = min(1.0, ocfg.grad_clip / (got["metrics"]["grad_norm"]
                                           + 1e-9))
    P.close_params({n: torch.from_numpy(v)
                    for n, v in got["after"]["params"].items()},
                   P.ref_leaves(new["params"], cfg),
                   {n: g * got_scale for n, g in got["grads"].items()},
                   {n: g * scale for n, g in want_g.items()}, jm["lr"],
                   ocfg.eps)


def residual_blocks(ranks, key: str, c: dict, S: int = S,
                    S_src: int | None = None) -> None:
    """On every rank of case ``key``'s mesh, the residual entering each
    block of the last step holds S/M of its S positions where they
    divide the M ranks of 'model' (``sharding.residual_axis``), all S
    otherwise; an encoder block's, of its ``S_src`` frames, alike."""
    M = dict(zip(c["axes"], c["shape"])).get("model", 1)

    def part(n):
        return n // M if n % M == 0 else n

    want = {("train", part(S))}
    if S_src is not None:
        want.add(("encode", part(S_src)))
    for res in ranks:
        if res[key] is not None:
            assert set(map(tuple, res[key]["blocks"])) == want, key


def same_routes(ranks, key: str, c: dict, steps: int) -> None:
    """Each mesh step's routed slots (kept, all: the whole batch's, on
    every rank) equal the single-device step's from the same state."""
    for k, rec in enumerate(ranks[0][key]["steps"]):
        want = single_step(c, k, rec["before"], steps)["routes"]
        assert want is not None and want[1] > 0
        for r, res in enumerate(ranks):
            if res[key] is not None:
                assert res[key]["steps"][k]["routes"] == want, (r, k)


def same_collectives(ranks, key: str) -> None:
    """Every rank of case ``key``'s mesh issued the same collectives."""
    counts = [res[key]["counts"] for res in ranks if res[key] is not None]
    assert counts[0] and all(c == counts[0] for c in counts), key
