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


def _plans(eng) -> dict:
    return {k: (p.backend, None if p.shard is None else p.shard.tag())
            for k, p in eng.exec_plans.items()}


def _tuner_round_trip(model, tcfg, mesh, kw, caches) -> dict:
    """The ``shard_pipeline=0`` scenario's builds beside its run: how many
    candidates the first build timed, this rank's variant table, a
    rebuild from the cache file (its timed count, its plans equal the
    first build's), and a build that also tunes the kernel tiles (its
    plans and tiles), each on the cache file ``caches`` names."""
    from repro_torch.dispatch import autotune as at
    from repro_torch.serving import Engine

    at.num_timed_candidates = 0
    first = Engine(model, tcfg, mesh=mesh, autotune_cache=caches[0], **kw)
    out = dict(timed=at.num_timed_candidates,
               variants={k: dispatch.cache().shard_variant(k)
                         for k in dispatch.cache().variant_keys()})
    at.num_timed_candidates = 0
    again = Engine(model, tcfg, mesh=mesh, autotune_cache=caches[0], **kw)
    out.update(rebuilt_timed=at.num_timed_candidates,
               rebuilt_same=again.exec_plans == first.exec_plans)
    tiles = Engine(model, tcfg, mesh=mesh, autotune=True,
                   autotune_cache=caches[1], **kw)
    out["tile_plans"] = {k: (p.backend, str(p.tiles), p.shard.tag()
                             if p.shard else None)
                         for k, p in tiles.exec_plans.items()}
    dispatch.set_cache_path(caches[0])  # the run replays the first's
    return out


def engine_rank(rank, device, trees, tcfgs, scenarios, caches=None):
    """The continuous engine on a (data=2, model=2) mesh: for each
    scenario (name, weights key, Engine kwargs, prompts, new tokens),
    tokens by request id, the preemptions, the exec plans' keys and
    shard tags; the 'tuned' scenario (``shard_pipeline=0``) also its
    tuner round trip on the cache files ``caches``
    (:func:`_tuner_round_trip`); then the refusals (the recurrent one
    reads its config alone, before any weight)."""
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
        tuner = None
        if name == "tuned":
            tuner = _tuner_round_trip(models[key], tcfgs[key], mesh, kw,
                                      caches)
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
            if tuner is not None:
                dispatch.set_cache_path(None)
        out[name] = dict(
            tokens={rid: s.generated for rid, s in res.items()},
            status={rid: s.status for rid, s in res.items()},
            replans=eng.num_replans,
            preemptions=eng.scheduler.num_preemptions,
            plans=_plans(eng), leader=eng.is_leader,
            resident=sum(b.numel() * b.element_size()
                         for b in eng.params.buffers()), tuner=tuner)
    refusals = {}
    for what, fn in (
            ("cuda_graph", lambda: Engine(models["msgemm"],
                                          tcfgs["msgemm"], mesh=mesh,
                                          cuda_graph=True)),
            ("unknown_rules", lambda: Engine(models["msgemm"],
                                             tcfgs["msgemm"], mesh=mesh,
                                             mesh_rules="fsdp")),
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
    both, and the mesh run's collectives.  Then each case again on a
    (data=2) mesh of the first two ranks under the 'default' rules (the
    weights stored cut over 'data', the rows split): its tokens, its
    steps' logits (this rank's rows, from ``default_row``), its
    collectives and this rank's resident weight bytes under 'default'
    and under 'serve'."""
    from repro_torch import convert
    from repro_torch.runtime import serve as SV

    mesh = make_mesh(shape, axes)
    data = make_mesh((2,), ("data",))
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
        fsdp, steps = SV.shard_params(model, tcfg, data, "default"), []
        coll.reset_counts()
        tokens = SV.generate(fsdp, tcfg, b, max_new_tokens=new, mesh=data,
                             rules="default", step_logits=steps)
        out[name].update(
            default=tokens, default_logits=steps,
            default_row=sharding.coord(data, "data") * steps[0].shape[0],
            default_collectives=dict(coll.counts),
            resident={rules: sum(t.numel() * t.element_size()
                                 for t in SV.shard_params(
                                     model, tcfg, data, rules).buffers())
                      for rules in ("default", "serve")})
    out["fsdp_table"] = _fsdp_table_paths(data)
    return out


def _fsdp_table_paths(mesh) -> dict:
    """The embedding lookup and the tied head from a table stored cut over
    'data' (``transformer._embed_fsdp``, ``_tied_head_fsdp``), both of
    their routes (the activations gathered, or the table's columns),
    against one device's on this rank's rows: {route: (got, want)}."""
    from types import SimpleNamespace

    from repro_torch.models import transformer as TT

    cfg = SimpleNamespace(d_model=8, embed_scale=True)
    g = torch.Generator().manual_seed(3)
    c = sharding.coord(mesh, "data")
    out = {}
    with sharding.use(mesh, "default"), sharding.split_rows("data"):
        for route, vocab in (("activations", 64), ("table", 6)):
            table = torch.randn((vocab, 8), generator=g)
            tokens = torch.randint(0, vocab, (4, 5), generator=g)
            mine = sharding.local_slice(tokens, ("data",), mesh)
            block = table[:, c * 4:(c + 1) * 4].contiguous()
            out[f"embed-{route}"] = (TT._embed_fsdp(block, cfg, mine, None),
                                     TT._embed(table, cfg, mine, None))
        table = torch.randn((6, 8), generator=g)
        block = table[:, c * 4:(c + 1) * 4].contiguous()
        for route, positions in (("partial", 1), ("table", 3)):
            x = torch.randn((4, positions, 8), generator=g)
            mine = sharding.local_slice(x, ("data",), mesh)
            out[f"head-{route}"] = (TT._tied_head_fsdp(mine, block),
                                    TT._tied_head(mine, table))
    return out


def serve_cell_rank(rank, device, cfg, shapes, mesh_shape, axes, seed,
                    rules=("default", "serve")):
    """A real step of each dry-run serve cell ``shapes`` on this rank of a
    ``mesh_shape`` / ``axes`` mesh under each of ``rules``: the model
    drawn from ``seed`` (whole, then cut by ``shard_params``), the rank's
    inputs built as the dry run builds them (``launch.dryrun.
    serve_inputs``, random tokens, a decode at position ``seq_len - 1``
    over a zero cache).  Returns {rules: {cell: its collectives (count
    and bytes by kind) and argument bytes}}."""
    mesh = make_mesh(mesh_shape, axes)
    return {r: _serve_cells(cfg, shapes, mesh, seed, r) for r in rules}


def _serve_cells(cfg, shapes, mesh, seed, rules):
    from repro_torch.launch import dryrun
    from repro_torch.models import transformer
    from repro_torch.runtime import serve as SV

    whole = transformer.init_params(
        cfg, generator=torch.Generator().manual_seed(seed), device="cpu",
        quant=cfg.quant)
    params = SV.shard_params(whole, cfg, mesh, rules)
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

        inputs, row = dryrun.serve_inputs(cfg, shape, mesh, rules,
                                          make=make)
        coll.reset_counts()
        dryrun.serve_step(params, cfg, shape.kind, inputs, mesh, row,
                          rules)
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
