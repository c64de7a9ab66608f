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

import torch_mesh_ranks as MR
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


def local_batch(batch: dict, mesh, microbatches: int = 1) -> dict:
    """This rank's rows of a whole numpy batch (its share of each
    microbatch, ``sharding.local_rows``)."""
    return {k: torch.from_numpy(np.ascontiguousarray(
        sharding.local_rows(v, mesh, microbatches)))
        for k, v in batch.items()}


def whole(tree: dict, specs: dict, mesh) -> dict:
    """Every leaf of ``tree`` (this rank's blocks under ``specs``)
    gathered whole, a two-halves leaf back in the single-device order."""
    def one(n, t):
        t = sharding.gather_leaf(t, specs[n], mesh)
        return sharding.from_blocks(t, sharding.halves_parts(
            specs[n], mesh)) if sharding.is_halves(n) else t

    return {n: _np(one(n, t)) for n, t in tree.items()}


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
    their mean over 'pod'), the state after it, its metrics; the
    collectives of the last step by kind; the expert stacks held cut
    over 'data' (whole shapes) and the last step's all-gathers that gave
    one of them (``torch_mesh_ranks.stacks_gathered``); the residual's
    positions entering each block of the last step
    (``torch_mesh_ranks.recording_blocks``) and each step's routed slots
    of a MoE config."""
    cfg, tcfg = smoke(case["arch"], case["over"]), train_config(case["tkw"])
    mesh = make_mesh(case["shape"], case["axes"])
    if not member(mesh, rank):
        return None
    state = sharding.shard_state(
        RT.state_for(model_from(cfg, weights), tcfg), mesh, cfg.logical_rules)
    specs, names = state["specs"], list(state["opt"]["m"])
    out = {"steps": []}
    for step, b in enumerate(batches):
        b = local_batch(b, mesh, tcfg.microbatches)
        rec = {"before": _whole_state(state)}
        _, _, pod_grads = RT._grads(state["params"], names, cfg, tcfg, b,
                                    mesh=mesh, specs=specs)
        res = state["opt"].get("residual")
        grads, _ = RT._pod_mean(pod_grads, mesh, tcfg,
                                None if res is None else dict(res))
        rec["grads"] = whole(grads, specs, mesh)
        rec["pod_grads"] = whole(pod_grads, specs, mesh)
        del grads, pod_grads
        seen, blocks = [], []
        routes = MR.route_counts(state["params"])
        if step == len(batches) - 1:
            coll.reset_counts()
            with MR.recording_gathers(seen), MR.recording_blocks(blocks):
                state, met = RT.train_step(state, b, cfg, tcfg)
            out["blocks"] = sorted(set(blocks))
        else:
            state, met = RT.train_step(state, b, cfg, tcfg)
        if routes is not None:  # the step's routed slots (kept, all)
            rec["routes"] = [a - b for a, b in zip(
                MR.route_counts(state["params"]), routes)]
        rec["metrics"] = {k: float(v) for k, v in met.items()}
        rec["after"] = _whole_state(state)
        out["steps"].append(rec)
    out["counts"] = dict(coll.counts)
    stacks = MR.whole_stacks(state["params"],
                             dict(zip(case["axes"], case["shape"]))
                             .get("data", 1))
    out["stacks"] = stacks
    out["stacks_gathered"] = MR.stacks_gathered(seen, stacks)
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


def train_mesh_rank(rank, device, cases, weights, batches, archs):
    """Every case of ``cases`` ({key: {arch, shape, axes, tkw, over}}),
    from the weights and batches under its key, or else its arch's; the
    autograd collectives, the int8 gather, and one step of each of
    ``archs`` on (data=2, model=2) (:func:`arch_steps`)."""
    out = {"int8": int8_gather(rank), "ad": autograd_collectives(rank),
           "archs": arch_steps(archs)}
    for key, case in cases.items():
        src = key if key in weights else case["arch"]
        out[key] = run_case(case, weights[src], batches[src], rank)
    return out


def cases_rank(rank, device, cases, weights, batches, root=None):
    """Every case of ``cases`` from its own ``weights[key]`` and
    ``batches[key]`` (:func:`run_case`; None on a rank outside its
    mesh); with ``root``, also :func:`halves_round_trips` there."""
    out = {key: run_case(case, weights[key], batches[key], rank)
           for key, case in cases.items()}
    if root is not None:
        out["halves"] = halves_round_trips(rank, root)
    return out


def _bits(a: dict, b: dict) -> list:
    """The names whose tensors differ in a bit (or in shape)."""
    return sorted(n for n in a if not torch.equal(a[n], b[n]))


def _whole_trees(tree: dict) -> dict:
    """A ``gather_state`` tree as {'params/name' | 'm/name' | 'v/name':
    tensor}."""
    out = {f"params/{n}": t for n, t in tree["params"].items()}
    for k in ("m", "v"):
        out.update({f"{k}/{n}": t for n, t in tree["opt"][k].items()})
    return out


def halves_round_trips(rank: int, root: str) -> dict:
    """The two-halves leaves (Mamba's ``in_proj``, the mLSTM's ``xl_up``)
    of jamba and xlstm SMOKE on (data=2, model=2), after one step: this
    rank's block is its channels of both halves (then its 'data' block of
    the columns); the state gathered whole (``gather_state``) and cut
    again (``shard_state``) gives the same blocks; its checkpoint
    restored onto one device gives the gathered leaves, and restored
    onto (data=1, model=4) and gathered, the same, bit for bit.  Returns
    {arch: {check: the names that differ}}."""
    from repro_torch.checkpoint import CheckpointManager

    out = {}
    mesh = make_mesh((2, 2), ("data", "model"))
    for arch, name in (("jamba_v01", "blocks.0.mamba.in_proj.w"),
                       ("xlstm_1b3", "blocks.0.xl_up.w")):
        cfg, tcfg = smoke(arch, {}), train_config({})
        whole_w = dict(fresh_state(cfg, tcfg)["params"].named_buffers())[name]
        state = fresh_state(cfg, tcfg, mesh)
        r, half = sharding.coord(mesh, "model"), whole_w.shape[0] // 2
        n = half // 2
        want = torch.cat([whole_w[r * n:(r + 1) * n],
                          whole_w[half + r * n:half + (r + 1) * n]])
        want = sharding.local_slice(want, (None, state["specs"][name][1]),
                                    mesh)
        res = {"block": [] if torch.equal(dict(state["params"]
                                               .named_buffers())[name], want)
               else [name]}
        batch = arch_stream(cfg).device_batch(0, device="cpu", mesh=mesh)
        state, _ = RT.train_step(state, batch, cfg, tcfg)
        tree = sharding.gather_state(state)
        whole = _whole_trees(tree)
        again = RT.state_for(model_from(cfg, {n: t.numpy() for n, t in
                                              tree["params"].items()}), tcfg)
        for k in ("m", "v"):
            again["opt"][k] = {n: t.clone() for n, t in tree["opt"][k].items()}
        again = sharding.shard_state(again, mesh, cfg.logical_rules)
        res["reshard"] = _bits(
            {**{f"params/{n}": t for n, t in
                state["params"].state_dict().items()},
             **{f"{k}/{n}": t for k in ("m", "v")
                for n, t in state["opt"][k].items()}},
            {**{f"params/{n}": t for n, t in
                again["params"].state_dict().items()},
             **{f"{k}/{n}": t for k in ("m", "v")
                for n, t in again["opt"][k].items()}})
        d = f"{root}/{arch}"
        CheckpointManager(d).save(1, driver._tree(state),
                                  shardings=driver.shardings(state))
        if rank == 0:
            one = driver._restore(CheckpointManager(d), 1,
                                  fresh_state(cfg, tcfg))
            res["onto_1x1"] = _bits(whole, _whole_trees(
                {"params": one["params"].state_dict(), "opt": one["opt"]}))
        m14 = make_mesh((1, 4), ("data", "model"))
        other = driver._restore(CheckpointManager(d), 1,
                                fresh_state(cfg, tcfg, m14))
        res["onto_1x4"] = _bits(whole, _whole_trees(
            sharding.gather_state(other)))
        out[arch] = res
    return out


ARCH_BATCH = (4, 16)  # a one-step run of every arch: 4 rows of 16 tokens


def arch_stream(cfg) -> SyntheticStream:
    """The lcg stream of :func:`arch_steps` (whisper 8 stub frames,
    phi-3 its patches ahead of the text)."""
    B, S = ARCH_BATCH
    return SyntheticStream(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=S + 1, global_batch=B, seed=0,
        frontend=cfg.frontend, d_model=cfg.d_model, num_frames=8,
        num_patches=cfg.num_patches))


def arch_step(arch: str, over: dict, mesh=None) -> dict:
    """One step of ``arch``'s SMOKE config (fields ``over``) from seed 0
    on batch 0 of :func:`arch_stream` (on ``mesh``, this rank's rows):
    its metrics."""
    cfg = smoke(arch, over)
    tcfg = train_config({})
    state = fresh_state(cfg, tcfg, mesh)
    batch = arch_stream(cfg).device_batch(0, device="cpu", mesh=mesh)
    _, met = RT.train_step(state, batch, cfg, tcfg)
    return {k: float(v) for k, v in met.items()}


def arch_steps(archs) -> dict:
    """:func:`arch_step` of each (arch, over) of ``archs`` on (data=2,
    model=2), by ``f"{arch}-{over}"``."""
    mesh = make_mesh((2, 2), ("data", "model"))
    return {f"{a}-{o}": arch_step(a, o, mesh) for a, o in archs}


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
def dryrun_rank(rank, device, shape, axes, batch_shape, tkw, archs):
    """One real train step of each of ``archs``' SMOKE configs (an entry
    a name, or (key, name, config fields)) on ``shape``/``axes``: by
    key, this rank's collectives by kind (count, bytes) and its
    state-plus-batch bytes, for the fake-mode cell to equal."""
    from repro_torch.launch import dryrun

    out = {}
    for arch in archs:  # a name, or (key, name, config fields)
        key, arch, over = (arch, arch, {}) if isinstance(arch, str) \
            else arch
        cfg = configs.get_smoke(arch).replace(**over)
        tcfg = train_config(tkw)
        mesh = make_mesh(shape, axes)
        state = fresh_state(cfg, tcfg, mesh)
        B, S = batch_shape
        g = np.random.default_rng(0)
        b = {k: g.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
             for k in ("tokens", "labels")}
        b = local_batch(b, mesh, tcfg.microbatches)
        args = dryrun.state_bytes(state, b)
        coll.reset_counts()
        RT.train_step(state, b, cfg, tcfg)
        out[key] = {"argument_bytes": args,
                     "collectives": {k: {"count": coll.counts[k],
                                         "bytes": coll.nbytes[k]}
                                     for k in sorted(coll.counts)}}
    return out
