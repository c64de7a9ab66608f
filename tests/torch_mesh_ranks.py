"""Rank bodies of the port's multi-process tests on the CPU
(``launch.mesh.run_ranks``: gloo ranks, each a spawned process).  They
import torch and ``repro_torch`` only, so a rank starts without JAX; the
test modules compare what they return with the single-process results.

Every input is drawn from a seed, so the parent draws the same ones.
"""

from __future__ import annotations

import torch

from repro_torch import dispatch
from repro_torch.core import linear as qlinear
from repro_torch.core.epilogue import Epilogue
from repro_torch.core.spec import QuantSpec
from repro_torch.dispatch.shard import shard_linear
from repro_torch.distributed import collectives as coll
from repro_torch.distributed import compat
from repro_torch.distributed import sharding
from repro_torch.launch.mesh import make_mesh

# collective inputs: (name, shape, dim); dims that divide 2 and 4, one
# that divides 2 only, and ones that divide neither
COLL_SHAPES = (("d12", (2, 12), -1), ("d10", (3, 10), -1),
               ("d7", (5, 7), -1), ("rows8", (8, 3), 0))
# a sharded linear: m, k; k_local (k / 2 or k / 4) splits into 2 or 3
# chunks that stay scale_block- and d-aligned at d=2, scale_block=8
LIN_M, LIN_K = 24, 192
LIN_X = (3, 5, LIN_K)
LAYOUTS = {  # name -> (logical axes, ExecPolicy shard knobs)
    "column": (("mlp", "embed"), dict()),
    "psum": (("embed", "mlp"), dict()),
    "reduce_scatter": (("embed", "mlp"),
                       dict(shard_collective="reduce_scatter")),
    "ring_psum": (("embed", "mlp"), dict(shard_impl="ring")),
    "ring_reduce_scatter": (("embed", "mlp"),
                            dict(shard_collective="reduce_scatter",
                                 shard_impl="ring")),
    "pipelined2": (("embed", "mlp"), dict(shard_pipeline=2)),
    "pipelined3_ring": (("embed", "mlp"),
                        dict(shard_pipeline=3, shard_impl="ring")),
}
MODES = ("msgemm", "int4_dequant", "bf16")


def coll_input(rank: int, shape, integer: bool) -> torch.Tensor:
    g = torch.Generator().manual_seed(100 + rank)
    if integer:
        return torch.randint(-8, 9, shape, generator=g).float()
    return torch.randn(shape, generator=g)


def lin_spec(mode: str) -> QuantSpec:
    if mode == "bf16":
        return QuantSpec(mode="bf16")
    return QuantSpec(mode=mode, d=2, scale_block=8,
                     storage="packed_u8" if mode == "int4_dequant"
                     else "packed_idx")


def lin_inputs(mode: str):
    """(whole leaves, x, bias, residual, epilogue) of the test linear."""
    g = torch.Generator().manual_seed(7)
    w = torch.randn((LIN_M, LIN_K), generator=g) * LIN_K ** -0.5
    x = torch.randn(LIN_X, generator=g)
    bias = torch.randn(LIN_M, generator=g)
    residual = torch.randn(LIN_X[:-1] + (LIN_M,), generator=g)
    ep = Epilogue(act="gelu", bias=True, residual=True)
    return qlinear.from_dense(w, lin_spec(mode)), x, bias, residual, ep


def collectives_rank(rank, device, n):
    """The ring collectives and the group's own on a model=n mesh, on
    integer-valued and random inputs; plus broadcasts."""
    mesh = make_mesh((n,), ("model",))
    out = {}
    with sharding.use(mesh):
        for integer in (True, False):
            for name, shape, dim in COLL_SHAPES:
                y = coll_input(rank, shape, integer)
                key = f"{name}-{'int' if integer else 'float'}"
                out[f"{key}-psum"] = coll.psum(y, "model")
                out[f"{key}-ring_psum"] = coll.ring_psum(y, "model")
                out[f"{key}-all_gather"] = coll.all_gather(y, "model",
                                                           dim=dim)
                out[f"{key}-ring_all_gather"] = coll.ring_all_gather(
                    y, "model", dim=dim)
                for fn in ("psum_scatter", "ring_reduce_scatter"):
                    try:
                        out[f"{key}-{fn}"] = getattr(coll, fn)(
                            y, "model", dim=dim)
                    except ValueError:
                        out[f"{key}-{fn}"] = "ValueError"
        t = torch.full((3,), float(rank))
        out["broadcast"] = coll.broadcast(t)
        out["broadcast_object"] = coll.broadcast_object({"rank": rank})
        out["coord"] = sharding.coord(mesh, "model")
        out["axis_size"] = compat.axis_size("model")
        out["transport"] = coll.transport(mesh.get_group("model"))
    out["counts"] = dict(coll.counts)
    return out


def linears_rank(rank, device, n):
    """Every (mode, layout) linear run sharded on a model=n mesh through
    ``dispatch.execute``: this rank's leaves (``shard_linear``), x,
    bias and residual whole.  Returns {(mode, layout): (y, shard tag)}."""
    mesh = make_mesh((n,), ("model",))
    out = {}
    with sharding.use(mesh, "serve"):
        for mode in MODES:
            spec = lin_spec(mode)
            whole, x, bias, residual, ep = lin_inputs(mode)
            for layout, (axes, knobs) in LAYOUTS.items():
                policy = dispatch.ExecPolicy(**knobs)
                local = shard_linear(spec, axes, whole, LIN_M, LIN_K, mesh)
                with dispatch.using_policy(policy):
                    p = dispatch.plan(spec, LIN_M, LIN_K, 15,
                                      device_type="cpu", shard_axes=axes,
                                      lead_batch=1)
                    y = dispatch.execute(local, x, spec, in_dim=LIN_K,
                                         epilogue=ep, bias=bias,
                                         residual=residual,
                                         shard_axes=axes, out_dim=LIN_M)
                out[(mode, layout)] = (y, None if p.shard is None
                                       else p.shard.tag())
    return out


def engine_rank(rank, device, trees, tcfgs, scenarios):
    """The continuous engine on a (data=2, model=2) mesh: for each
    scenario (name, weights key, Engine kwargs, prompts, new tokens),
    tokens by request id, the preemptions, the exec plans' keys and
    shard tags; then the refusals (the recurrent one reads its config
    alone, before any weight)."""
    from repro_torch import convert, faults
    from repro_torch.serving import Engine, Request

    mesh = make_mesh((2, 2), ("data", "model"))
    models = {key: convert.params_from_jax(tree, tcfgs[key], device="cpu")
              for key, tree in trees.items()}
    out = {}
    for name, key, kw, prompts, new in scenarios:
        if name == "offmesh_cache":
            # an off-mesh plan, on the plain backend, of every key the
            # 'msgemm' scenario's engine asked for: a sharded engine must
            # never replay it
            for pkey in out["msgemm"]["plans"]:
                off = pkey.rsplit("|sh", 1)[0] + "|sh-"
                dispatch.cache().put(off, dispatch.ExecPlan(
                    "msgemm_torch"), persist=False)
        eng = Engine(models[key], tcfgs[key], mesh=mesh, **kw)
        if name == "replan" and rank == 0:
            # NaN logits on the leader alone: its guard replans, and the
            # followers replan with it
            faults.arm(faults.FaultPlan(faults.parse_spec(
                "nan_logits:p=1.0,after=1,max=2"), seed=0))
        try:
            res = eng.run([Request(rid=i, prompt=p, max_new_tokens=new)
                           for i, p in enumerate(prompts)])
        finally:
            faults.disarm()
            dispatch.clear_quarantine()
        out[name] = dict(
            tokens={rid: s.generated for rid, s in res.items()},
            status={rid: s.status for rid, s in res.items()},
            replans=eng.num_replans,
            preemptions=eng.scheduler.num_preemptions,
            plans={k: (p.backend, None if p.shard is None
                       else p.shard.tag())
                   for k, p in eng.exec_plans.items()},
            leader=eng.is_leader)
    refusals = {}
    for what, fn in (
            ("cuda_graph", lambda: Engine(models["msgemm"],
                                          tcfgs["msgemm"], mesh=mesh,
                                          cuda_graph=True)),
            ("default_rules", lambda: Engine(models["msgemm"],
                                             tcfgs["msgemm"], mesh=mesh,
                                             mesh_rules="default")),
            ("recurrent", lambda: Engine(models["msgemm"],
                                         tcfgs["recurrent"], mesh=mesh))):
        try:
            fn()
            refusals[what] = None
        except (ValueError, NotImplementedError) as e:
            refusals[what] = type(e).__name__
    out["refusals"] = refusals
    return out


def runner_failure_rank(rank, device, tree, tcfg, prompts, path):
    """A model=2 engine whose leader fails inside its second step, after
    it told the followers to step: the leader writes its step calls and
    retries to ``path``, then the failure ends its run."""
    import json

    from repro_torch import convert
    from repro_torch.serving import Engine, Request

    mesh = make_mesh((2,), ("model",))
    eng = Engine(convert.params_from_jax(tree, tcfg, device="cpu"), tcfg,
                 mesh=mesh, max_slots=4, block_size=4, prefill_chunk=4,
                 max_model_len=32)
    calls = []
    if rank == 0:
        run = eng.runner._run

        def failing(name, arrays):
            calls.append(name)
            if len(calls) == 2:
                raise RuntimeError("device fault inside the step")
            return run(name, arrays)

        eng.runner._run = failing
    try:
        eng.run([Request(rid=i, prompt=p, max_new_tokens=3)
                 for i, p in enumerate(prompts)])
    finally:
        if rank == 0:
            with open(path, "w") as f:
                json.dump(dict(calls=len(calls),
                               retries=eng.num_step_retries), f)


# ----------------------------------------- the training layout in serving
def _counting_runner(eng):
    """Wrap ``eng``'s step runner so that each step it runs records its
    collectives by kind: [(step shape name, {kind: count})]."""
    steps = []
    run = eng.runner._run

    def counted(name, arrays):
        coll.reset_counts()
        out = run(name, arrays)
        steps.append((name, dict(coll.counts)))
        return out

    eng.runner._run = counted
    return steps


def layout_rank(rank, device, trees, tcfgs, shape, axes, kw, prompts, new):
    """The continuous engine on a ``shape`` / ``axes`` mesh for each
    weights key of ``trees``: tokens by request id, each step's
    collectives (:func:`_counting_runner`), and the MoE blocks'
    dropped_frac."""
    from repro_torch import convert
    from repro_torch.models import moe
    from repro_torch.serving import Engine, Request

    mesh = make_mesh(shape, axes)
    out = {}
    for key, tree in trees.items():
        model = convert.params_from_jax(tree, tcfgs[key], device="cpu")
        eng = Engine(model, tcfgs[key], mesh=mesh, **kw)
        steps = _counting_runner(eng)
        moe.reset_route_counts(model)
        res = eng.run([Request(rid=i, prompt=p, max_new_tokens=new)
                       for i, p in enumerate(prompts)])
        out[key] = dict(tokens={rid: s.generated for rid, s in res.items()},
                        steps=steps, dropped=moe.dropped_frac(model),
                        plans={k: (p.backend, None if p.shard is None
                                   else p.shard.tag())
                               for k, p in eng.exec_plans.items()})
    return out


def static_rank(rank, device, cases, new, shape, axes):
    """Static ``generate`` of each case {name: (numpy tree, port cfg,
    numpy batch)} on one device and on a ``shape`` / ``axes`` mesh (this
    rank's ``shard_params`` copy): tokens and every step's logits of
    both, and the mesh run's collectives."""
    from repro_torch import convert
    from repro_torch.runtime import serve as SV

    mesh = make_mesh(shape, axes)
    out = {}
    for name, (tree, tcfg, batch) in cases.items():
        model = convert.params_from_jax(tree, tcfg, device="cpu")
        b = {k: torch.from_numpy(v) for k, v in batch.items()}
        one, many = [], []
        single = SV.generate(model, tcfg, b, max_new_tokens=new,
                             step_logits=one)
        local = SV.shard_params(model, tcfg, mesh)
        coll.reset_counts()
        sharded = SV.generate(local, tcfg, b, max_new_tokens=new,
                              mesh=mesh, step_logits=many)
        out[name] = dict(single=single, sharded=sharded,
                         single_logits=one, sharded_logits=many,
                         collectives=dict(coll.counts))
    return out


def serve_cell_rank(rank, device, cfg, shapes, mesh_shape, axes, seed):
    """A real step of each dry-run serve cell ``shapes`` on this rank of a
    ``mesh_shape`` / ``axes`` mesh: the model drawn from ``seed`` (whole,
    then cut by ``shard_params``), the rank's inputs built as the dry run
    builds them (``launch.dryrun.serve_inputs``, random tokens, a decode
    at position ``seq_len - 1`` over a zero cache).  Returns each cell's
    collectives (count and bytes by kind) and argument bytes."""
    from repro_torch.launch import dryrun
    from repro_torch.models import transformer
    from repro_torch.runtime import serve as SV

    mesh = make_mesh(mesh_shape, axes)
    whole = transformer.init_params(
        cfg, generator=torch.Generator().manual_seed(seed), device="cpu",
        quant=cfg.quant)
    params = SV.shard_params(whole, cfg, mesh, dryrun.SERVE_RULES)
    g = torch.Generator().manual_seed(seed + 1)
    out = {}
    for shape in shapes:
        def make(dims, dtype, name, seq=shape.seq_len):
            if name in ("tokens", "token"):
                return torch.randint(0, cfg.vocab_size, dims, generator=g,
                                     dtype=dtype)
            if name == "pos":
                return torch.full(dims, seq - 1, dtype=dtype)
            return torch.zeros(dims, dtype=dtype)

        inputs, row = dryrun.serve_inputs(cfg, shape, mesh, make=make)
        coll.reset_counts()
        dryrun.serve_step(params, cfg, shape.kind, inputs, mesh, row)
        out[shape.name] = dict(
            collectives={k: {"count": coll.counts[k],
                             "bytes": coll.nbytes[k]}
                         for k in sorted(coll.counts)},
            argument_bytes=dryrun.serve_bytes(params, inputs))
    return out


def moe_counts_rank(rank, device, tree, tcfg, shape, axes, kw, prompts,
                    new):
    """The continuous engine on a MoE model on a ``shape`` / ``axes``
    mesh: tokens, the MoE blocks' routed-slot counters summed (kept,
    total) and dropped_frac."""
    from repro_torch import convert
    from repro_torch.models import moe
    from repro_torch.serving import Engine, Request

    mesh = make_mesh(shape, axes)
    model = convert.params_from_jax(tree, tcfg, device="cpu")
    eng = Engine(model, tcfg, mesh=mesh, **kw)
    moe.reset_route_counts(model)  # the build's idle steps route too
    res = eng.run([Request(rid=i, prompt=p, max_new_tokens=new)
                   for i, p in enumerate(prompts)])
    counts = torch.stack([m.route_counts for m in moe._moes(model)])
    return dict(tokens={rid: s.generated for rid, s in res.items()},
                counts=counts.sum(0).tolist(),
                dropped=moe.dropped_frac(model))
