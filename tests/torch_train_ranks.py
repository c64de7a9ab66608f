"""Rank bodies of the port's mesh-training tests on the CPU
(``launch.mesh.run_ranks``: gloo ranks, each a spawned process).  They
import torch and ``repro_torch`` only, so a rank starts without JAX; the
test modules compare what they return with the single-process results
(the port's single-device step and the reference's).

Every rank function runs several meshes in one spawn of four ranks: a
mesh of fewer ranks is made by every rank (its groups are the world's)
and run by its members only.  Tensors come back as numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import configs
from repro_torch.data.pipeline import DataConfig, SyntheticStream
from repro_torch.distributed import collectives as coll
from repro_torch.distributed import sharding
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import transformer
from repro_torch.optim import AdamWConfig, schedules
from repro_torch.optim.compression import (compressed_pmean_tree,
                                           compressed_psum)
from repro_torch.runtime import driver
from repro_torch.runtime import train as RT

WORLD = 4
# the int8 gather's inputs: (8, 6) whole, over data=2 x model=2
I8_SHAPE = (8, 6)


def _np(t):
    """A copy: a leaf whole on every rank is the state's own tensor,
    which later steps update in place."""
    return t.detach().cpu().numpy().copy()


def member(mesh, rank: int) -> bool:
    """Whether global ``rank`` is one of ``mesh``'s."""
    return rank < mesh.mesh.numel()


# ---------------------------------------------------------- compression
def compression_rank(rank, device, inputs):
    """``compressed_psum`` and ``compressed_pmean_tree`` over 'pod' on
    (pod=2, data=2) and (pod=4): this rank's ``inputs[name][rank]``."""
    out = {}
    for key, shape, axes in (("pod2", (2, 2), ("pod", "data")),
                             ("pod4", (4,), ("pod",))):
        mesh = make_mesh(shape, axes)
        with sharding.use(mesh):
            x = torch.from_numpy(inputs["x"][rank])
            grads = {n: torch.from_numpy(v[rank])
                     for n, v in inputs["grads"].items()}
            res = {n: torch.from_numpy(v[rank])
                   for n, v in inputs["residual"].items()}
            mean, new = compressed_pmean_tree(grads, "pod", res)
            mean0, new0 = compressed_pmean_tree(grads, "pod")
            out[key] = dict(psum=_np(compressed_psum(x, "pod")),
                            mean={n: _np(v) for n, v in mean.items()},
                            residual={n: _np(v) for n, v in new.items()},
                            mean0={n: _np(v) for n, v in mean0.items()},
                            residual0={n: _np(v) for n, v in new0.items()})
    return out


# ---------------------------------------------------------- train steps
def smoke(arch: str, over: dict):
    return configs.get_smoke(arch).replace(**over)


def train_config(tkw: dict) -> RT.TrainConfig:
    return RT.TrainConfig(optimizer=AdamWConfig(), **tkw)


def model_from(cfg, weights: dict):
    """A CPU model of ``cfg`` holding ``weights`` ({buffer: array})."""
    model = transformer.init_params(cfg, generator=torch.Generator(
    ).manual_seed(0), device="cpu")
    model.load_state_dict({n: torch.from_numpy(np.array(a))
                           for n, a in weights.items()})
    return model


def local_batch(batch: dict, mesh) -> dict:
    """This rank's rows of a whole numpy batch."""
    first, n = sharding.batch_rows(next(iter(batch.values())).shape[0],
                                   mesh)
    return {k: torch.from_numpy(v[first:first + n]) for k, v in batch.items()}


def whole(tree: dict, specs: dict, mesh) -> dict:
    return {n: _np(sharding.gather_leaf(t, specs[n], mesh))
            for n, t in tree.items()}


def _whole_state(state) -> dict:
    tree = sharding.gather_state(state)
    return {"params": {n: _np(t) for n, t in tree["params"].items()},
            **{k: {n: _np(t) for n, t in tree["opt"][k].items()}
               for k in sharding.MOMENTS if k in tree["opt"]},
            "count": int(tree["opt"]["count"])}


def run_case(case: dict, weights: dict, batches: list, rank: int) -> dict:
    """One mesh training case: a step on each of ``batches`` from
    ``weights``.  Returns for each step, whole: the state before it
    (params, m, v, count), its gradients (and the pods' own, before
    their mean over 'pod'), the state after it, its metrics; and the
    collectives of the last step by kind."""
    cfg, tcfg = smoke(case["arch"], case["over"]), train_config(case["tkw"])
    mesh = make_mesh(case["shape"], case["axes"])
    if not member(mesh, rank):
        return None
    state = sharding.shard_state(
        RT.state_for(model_from(cfg, weights), tcfg), mesh, cfg.logical_rules)
    specs, names = state["specs"], list(state["opt"]["m"])
    out = {"steps": []}
    for step, b in enumerate(batches):
        b = local_batch(b, mesh)
        rec = {"before": _whole_state(state)}
        _, _, pod_grads = RT._grads(state["params"], names, cfg, tcfg, b,
                                    mesh=mesh, specs=specs)
        res = state["opt"].get("residual")
        grads, _ = RT._pod_mean(pod_grads, mesh, tcfg,
                                None if res is None else dict(res))
        rec["grads"] = whole(grads, specs, mesh)
        rec["pod_grads"] = whole(pod_grads, specs, mesh)
        del grads, pod_grads
        if step == len(batches) - 1:
            coll.reset_counts()
        state, met = RT.train_step(state, b, cfg, tcfg)
        rec["metrics"] = {k: float(v) for k, v in met.items()}
        rec["after"] = _whole_state(state)
        out["steps"].append(rec)
    out["counts"] = dict(coll.counts)
    return out


def int8_gather(rank: int) -> dict:
    """``int8_all_gather`` on (data=2, model=2) of one (8, 6) tensor under
    two specs, and the gradient of ``sum(g * c)`` where this rank's
    cotangent ``c`` is ``arange`` on the elements whose index modulo 2 is
    its data coordinate (the data ranks' sum to ``arange``)."""
    mesh = make_mesh((2, 2), ("data", "model"))
    x = torch.from_numpy(int8_input())
    out = {}
    for key, spec in (("data", ("data", None)),
                      ("data_model", ("data", "model"))):
        leaf = sharding.local_slice(x, spec, mesh).clone().requires_grad_()
        g = coll.int8_all_gather(leaf, mesh, spec, axis="data")
        full = torch.arange(48.0).reshape(I8_SHAPE)
        ct = torch.where(torch.arange(48).reshape(I8_SHAPE) % 2
                         == sharding.coord(mesh, "data"), full, 0.0)
        ct = sharding.local_slice(ct, (None,) + spec[1:], mesh)
        (grad,) = torch.autograd.grad((g * ct).sum(), leaf)
        out[key] = dict(out=_np(g), grad=_np(grad),
                        want_grad=_np(sharding.local_slice(full, spec, mesh)))
    return out


def int8_input() -> np.ndarray:
    return (np.random.default_rng(3).standard_normal(I8_SHAPE) * 0.3
            ).astype(np.float32)


AD_SHAPE = (4, 3)  # a rank's input to the autograd collectives


def ad_input(data: int, model: int, what: str) -> np.ndarray:
    """The (data, model) rank's input ``x`` or cotangent ``c``: small
    integers, so every sum is exact."""
    g = np.random.default_rng([data, model, what == "c"])
    return g.integers(-8, 9, AD_SHAPE).astype(np.float32)


def autograd_collectives(rank: int) -> dict:
    """Each autograd collective over 'data' on (data=2, model=2): its
    output and the gradient of ``sum(out * c)`` for this rank's input
    ``x`` and cotangent ``c`` (:func:`ad_input`)."""
    mesh = make_mesh((2, 2), ("data", "model"))
    d, m = sharding.coord(mesh, "data"), sharding.coord(mesh, "model")
    c = torch.from_numpy(ad_input(d, m, "c"))
    out = {}
    for key, fn, grow in (
            ("all_gather", lambda x: coll.ad_all_gather(
                x, "data", dim=0, mesh=mesh), 2),
            ("all_gather_replicated", lambda x: coll.ad_all_gather(
                x, "data", dim=0, mesh=mesh, reduce_grad=False), 2),
            ("psum_scatter", lambda x: coll.ad_psum_scatter(
                x, "data", dim=0, mesh=mesh), 0.5),
            ("psum", lambda x: coll.ad_psum(x, "data", mesh=mesh), 1),
            ("identity", lambda x: coll.ad_identity(x, "data", mesh=mesh),
             1)):
        x = torch.from_numpy(ad_input(d, m, "x")).requires_grad_()
        y = fn(x)
        cy = c.repeat(2, 1) if grow == 2 else c[:int(4 * grow)]
        (grad,) = torch.autograd.grad((y * cy).sum(), x)
        out[key] = dict(out=_np(y), grad=_np(grad))
    return out


def train_mesh_rank(rank, device, cases, weights, batches):
    """Every case of ``cases`` ({key: {arch, shape, axes, tkw, over}}),
    the autograd collectives, the int8 gather, and the refusal of a MoE
    config on a mesh."""
    out = {"int8": int8_gather(rank), "ad": autograd_collectives(rank)}
    for key, case in cases.items():
        out[key] = run_case(case, weights[case["arch"]],
                            batches[case["arch"]], rank)
    mesh = make_mesh((2, 2), ("data", "model"))
    try:
        RT.init_state(configs.get_smoke("qwen2_moe"), RT.TrainConfig(),
                      generator=torch.Generator().manual_seed(0),
                      device="cpu", mesh=mesh)
        out["moe"] = None
    except NotImplementedError as e:
        out["moe"] = str(e)
    return out


# ---------------------------------------------------------- checkpoints
LR = 1e-3
STEPS = 4


def elastic_setup(arch: str = "gemma_2b"):
    """(cfg, tcfg, data) of the elastic-restore runs: gemma-2b SMOKE, the
    lcg stream of 8 rows of 16 tokens from seed 0."""
    cfg = configs.get_smoke(arch)
    tcfg = RT.TrainConfig(optimizer=AdamWConfig(lr=schedules.constant(LR)))
    data = SyntheticStream(DataConfig(vocab_size=cfg.vocab_size, seq_len=17,
                                      global_batch=8, seed=0))
    return cfg, tcfg, data


def fresh_state(cfg, tcfg, mesh=None):
    return RT.init_state(cfg, tcfg, generator=torch.Generator(
    ).manual_seed(0), device="cpu", mesh=mesh)


def _quiet(*args):
    pass


def drive(state, cfg, tcfg, data, directory: str, steps: int,
          every: int = 2) -> dict:
    return driver.run(state, RT.make_train_step(cfg, tcfg), data,
                      driver.DriverConfig(total_steps=steps,
                                          checkpoint_every=every,
                                          checkpoint_dir=directory),
                      device="cpu", log=_quiet)


def losses(res) -> dict:
    return {m["step"]: m["loss"] for m in res["metrics"]}


def elastic_rank(rank, device, root: str):
    """The elastic restores (module doc of ``test_torch_train_elastic``):
    {name: {step: loss}} and the restored leaves' bits, on rank 0."""
    from repro_torch.checkpoint import CheckpointManager

    cfg, tcfg, data = elastic_setup()
    out = {}
    mesh22 = make_mesh((2, 2), ("data", "model"))
    # uninterrupted on (2, 2), and stopped at 2 then resumed on (2, 2)
    out["mesh22"] = losses(drive(fresh_state(cfg, tcfg, mesh22), cfg, tcfg,
                                 data, f"{root}/whole22", STEPS))
    first = drive(fresh_state(cfg, tcfg, mesh22), cfg, tcfg, data,
                  f"{root}/a", 2)
    saved = sharding.gather_state(first["state"])
    state = fresh_state(cfg, tcfg, mesh22)
    ckpt = CheckpointManager(f"{root}/a")
    tree = driver._restore(ckpt, 2, state)
    back = sharding.gather_state(tree)
    out["same_mesh_exact"] = all(
        torch.equal(saved[k][n], back[k][n]) for k in ("params",)
        for n in saved[k]) and all(
        torch.equal(saved["opt"][k][n], back["opt"][k][n])
        for k in ("m", "v") for n in saved["opt"][k]) and \
        int(back["step"]) == 2 and int(back["opt"]["count"]) == 2
    out["resumed22"] = losses(drive(fresh_state(cfg, tcfg, mesh22), cfg,
                                    tcfg, data, f"{root}/a", STEPS))
    # the (2, 2) checkpoint at step 2 onto (4, 1) and onto (1, 2)
    for key, shape in (("mesh41", (4, 1)), ("mesh12", (1, 2))):
        mesh = make_mesh(shape, ("data", "model"))
        if member(mesh, rank):
            import shutil

            d = f"{root}/{key}"
            if sharding.is_lead(mesh):
                shutil.copytree(f"{root}/a/step_000000002",
                                f"{d}/step_000000002")
            sharding.mesh_barrier(mesh)
            out[key] = losses(drive(fresh_state(cfg, tcfg, mesh), cfg, tcfg,
                                    data, d, STEPS))
    # the single-device checkpoint (written by the parent) onto (2, 2)
    out["single_to_22"] = losses(drive(fresh_state(cfg, tcfg, mesh22), cfg,
                                       tcfg, data, f"{root}/single", STEPS))
    # a preemption seen by one rank stops every rank at the same step,
    # after a checkpoint of it
    stop = [rank == 1]
    res = driver.run(fresh_state(cfg, tcfg, mesh22),
                     RT.make_train_step(cfg, tcfg), data,
                     driver.DriverConfig(total_steps=STEPS,
                                         checkpoint_dir=f"{root}/stop"),
                     device="cpu", stop_flag=stop, log=_quiet)
    out["preempted"] = (res["preempted"], len(res["metrics"]),
                        CheckpointManager(f"{root}/stop").latest_step())
    # int8_pod on (pod=2, data=1, model=2): uninterrupted, and stopped at
    # 2 then resumed on the same mesh, every pod's residual its own
    pod_mesh = make_mesh((2, 1, 2), ("pod", "data", "model"))
    ptcfg = RT.TrainConfig(optimizer=tcfg.optimizer,
                           grad_compression="int8_pod")
    out["pod"] = losses(drive(fresh_state(cfg, ptcfg, pod_mesh), cfg, ptcfg,
                              data, f"{root}/wholepod", STEPS))
    first = drive(fresh_state(cfg, ptcfg, pod_mesh), cfg, ptcfg, data,
                  f"{root}/pod", 2)
    tree = driver._restore(CheckpointManager(f"{root}/pod"), 2,
                           fresh_state(cfg, ptcfg, pod_mesh))
    out["pod_same_exact"] = local_equal(first["state"], tree)
    out["pod_residual_nonzero"] = all(
        bool(r.any()) for r in tree["opt"]["residual"].values())
    out["pod_resumed"] = losses(drive(fresh_state(cfg, ptcfg, pod_mesh), cfg,
                                      ptcfg, data, f"{root}/pod", STEPS))
    # structure and shape mismatches raise, as does a residual of 2 pods
    # onto a mesh without 'pod'
    errors = {}
    for key, d, c, t in (
            ("leaves", "a", cfg, ptcfg),
            ("shape", "a", cfg.replace(d_ff=2 * cfg.d_ff), tcfg),
            ("pods", "pod", cfg, ptcfg)):
        try:
            driver._restore(CheckpointManager(f"{root}/{d}"), 2,
                            fresh_state(c, t, mesh22))
            errors[key] = None
        except ValueError as e:
            errors[key] = str(e)
    out["errors"] = errors
    return out if rank == 0 else {k: out[k] for k in (
        "pod_same_exact", "pod_residual_nonzero")}


def local_equal(a: dict, b: dict) -> bool:
    """Whether two states hold the same bits on this rank: its blocks of
    the params and of every optimizer tree, the count and the step."""
    pa, pb = a["params"].state_dict(), b["params"].state_dict()
    return all(torch.equal(pa[n], pb[n]) for n in pa) and all(
        torch.equal(a["opt"][k][n], b["opt"][k][n])
        for k in sharding.MOMENTS if k in a["opt"] for n in a["opt"][k]) \
        and int(a["opt"]["count"]) == int(b["opt"]["count"]) \
        and int(a["step"]) == int(b["step"])


# ------------------------------------------------------------- dry run
def dryrun_rank(rank, device, shape, axes, batch_shape, tkw):
    """One real train step of gemma-2b SMOKE on ``shape``/``axes``: this
    rank's collectives by kind (count, bytes) and its state-plus-batch
    bytes, for the fake-mode cell to equal."""
    from repro_torch.launch import dryrun

    cfg = configs.get_smoke("gemma_2b")
    tcfg = train_config(tkw)
    mesh = make_mesh(shape, axes)
    state = fresh_state(cfg, tcfg, mesh)
    B, S = batch_shape
    g = np.random.default_rng(0)
    b = {k: g.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
         for k in ("tokens", "labels")}
    b = local_batch(b, mesh)
    args = dryrun.state_bytes(state, b)
    coll.reset_counts()
    RT.train_step(state, b, cfg, tcfg)
    return {"argument_bytes": args,
            "collectives": {k: {"count": coll.counts[k],
                                "bytes": coll.nbytes[k]}
                            for k in sorted(coll.counts)}}
