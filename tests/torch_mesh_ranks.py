"""Rank bodies of the port's multi-process tests on the CPU
(``launch.mesh.run_ranks``: gloo ranks, each a spawned process).  They
import torch and ``repro_torch`` only, so a rank starts without JAX; the
test modules compare what they return with the single-process results.

Every input is drawn from a seed, so the parent draws the same ones.
"""

from __future__ import annotations

import contextlib
import gc
import weakref

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


# the all-to-all's input a rank: dim 1 splits over 2 and 4 ranks, the
# blocks land along the last dim
A2A_SHAPE = (2, 8, 3)


def a2a_input(rank: int, what: str, shape=A2A_SHAPE) -> torch.Tensor:
    """Rank ``rank``'s integer-valued input ``x`` or cotangent ``c`` of the
    all-to-all (every sum exact)."""
    g = torch.Generator().manual_seed(500 + 2 * rank + (what == "c"))
    return torch.randint(-8, 9, shape, generator=g).float()


@contextlib.contextmanager
def recording_gathers(seen: list):
    """While active, every ``collectives.all_gather`` (the autograd and
    int8 gathers' too) appends (axis, kind, result shape) to ``seen``."""
    orig = coll.all_gather

    def record(y, axis, **kw):
        out = orig(y, axis, **kw)
        seen.append((axis, kw.get("kind", "all_gather"), tuple(out.shape)))
        return out

    coll.all_gather = record
    try:
        yield seen
    finally:
        coll.all_gather = orig


@contextlib.contextmanager
def recording_blocks(seen: list):
    """While active, every block a step runs appends (mode, its input's
    positions) to ``seen``: a training step's on a mesh ('train', and
    'encode' for an encoder block) and a serving mode's."""
    from repro_torch.models import transformer as TT

    tp, serve = TT._block_apply_tp, TT.block_apply

    def record_tp(p, cfg, kind, x, *a, causal=True, **kw):
        seen.append(("train" if causal else "encode", x.shape[1]))
        return tp(p, cfg, kind, x, *a, causal=causal, **kw)

    def record(p, cfg, kind, x, *a, mode="train", **kw):
        if mode != "train":
            seen.append((mode, x.shape[1]))
        return serve(p, cfg, kind, x, *a, mode=mode, **kw)

    TT._block_apply_tp, TT.block_apply = record_tp, record
    try:
        yield seen
    finally:
        TT._block_apply_tp, TT.block_apply = tp, serve


def route_counts(model) -> list | None:
    """The routed-slot counters (kept, all) summed over ``model``'s MoE
    blocks, or None without MoE blocks."""
    from repro_torch.models import moe

    blocks = moe._moes(model)
    if not blocks:
        return None
    return [int(v) for v in sum(m.route_counts for m in blocks).tolist()]


def whole_stacks(model, n: int) -> dict:
    """{name: shape} of the expert-stack leaves of ``model`` (a rank's
    copy) held cut over 'data' along their out dim (``Experts.
    data_out``), at the shape a gather over ``n`` 'data' ranks gives."""
    from repro_torch.models import moe

    out = {}
    for prefix, mod in model.named_modules():
        if isinstance(mod, moe.Experts):
            for name in mod.data_out:
                for leaf, t in getattr(mod, name).params().items():
                    if leaf != "codebook":
                        shape = list(t.shape)
                        shape[1] *= n
                        out[f"{prefix}.{name}.{leaf}"] = tuple(shape)
    return out


def stacks_gathered(seen: list, stacks: dict) -> list:
    """The gathers of ``seen`` (:func:`recording_gathers`) over 'data' whose
    result is a whole stack leaf of ``stacks`` (:func:`whole_stacks`) by
    shape, outside the tokens' own kinds."""
    shapes = set(stacks.values())
    return [g for g in seen if g[0] == "data" and g[2] in shapes
            and not g[1].startswith("expert_")]


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
        # the all-to-all and its autograd form: this rank's output, the
        # gradient of sum(y * c), and the adjoint all-to-all of c
        x = a2a_input(rank, "x").requires_grad_()
        before = (coll.counts["expert_return"],
                  coll.nbytes["expert_return"])
        y = coll.ad_all_to_all(x, "model", split_dim=1, concat_dim=-1,
                               kind="expert_return")
        c = a2a_input(rank, "c", tuple(y.shape))
        (grad,) = torch.autograd.grad((y * c).sum(), x)
        out["a2a"] = dict(
            y=y.detach(), grad=grad,
            plain=coll.all_to_all(x.detach(), "model", split_dim=1,
                                  concat_dim=-1),
            adjoint=coll.all_to_all(c, "model", split_dim=-1,
                                    concat_dim=1),
            count=coll.counts["expert_return"] - before[0],
            nbytes=coll.nbytes["expert_return"] - before[1])
        try:
            coll.all_to_all(torch.zeros(2, 3, 5), "model", split_dim=-1,
                            concat_dim=0)
            out["a2a"]["indivisible"] = None
        except ValueError:
            out["a2a"]["indivisible"] = "ValueError"
        # the autograd gather under a kind of its own: counted so, its
        # backward a reduce-scatter
        x = a2a_input(rank, "x").requires_grad_()
        g = coll.ad_all_gather(x, "model", dim=1, kind="expert_tokens")
        cg = a2a_input(rank, "c", tuple(g.shape))
        (ggrad,) = torch.autograd.grad((g * cg).sum(), x)
        out["ag"] = dict(y=g.detach(), grad=ggrad)
        t = torch.full((3,), float(rank))
        out["broadcast"] = coll.broadcast(t)
        out["broadcast_object"] = coll.broadcast_object({"rank": rank})
        out["coord"] = sharding.coord(mesh, "model")
        out["axis_size"] = compat.axis_size("model")
        out["transport"] = coll.transport(mesh.get_group("model"))
    out["counts"] = dict(coll.counts)
    out["nbytes"] = dict(coll.nbytes)
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


@contextlib.contextmanager
def watching_cuts(refs: list):
    """While active, a weak reference to every weight leaf (each linear's
    and expert stack's, codebooks aside) of every part
    ``runtime.serve`` cuts to a rank's copy is appended to ``refs``, as
    the part is before the cut: the whole model's leaves."""
    from repro_torch.core.linear import QLinear
    from repro_torch.runtime import serve as SV

    orig = SV._cut_layout

    def watch(root, cfg, mesh):
        refs.extend(weakref.ref(t) for m in root.modules()
                    if isinstance(m, QLinear)
                    for n, t in m.params().items() if n != "codebook")
        return orig(root, cfg, mesh)

    SV._cut_layout = watch
    try:
        yield refs
    finally:
        SV._cut_layout = orig


def _left_alive(refs: list, copy) -> dict:
    """Of the whole model's leaves (``refs``): how many there were, how
    many are freed, and how many are alive though the rank's ``copy``
    does not hold them."""
    gc.collect()
    own = {id(t) for t in copy.buffers()}
    alive = [r() for r in refs if r() is not None]
    return dict(leaves=len(refs), freed=len(refs) - len(alive),
                stray=sum(id(t) not in own for t in alive))


def ownership(mesh) -> dict:
    """A rank serving qwen2-moe SMOKE (expert stacks, a shared expert, an
    untied head) under the 'default' rules keeps none of the whole
    model's weight leaves but those its copy holds: built by
    ``Engine(mesh=)`` from a whole model the caller then drops, and by
    the serve CLI's build (``launch.serve.build_model`` with a mesh,
    ``runtime.serve.init_shard``)."""
    from repro_torch import configs
    from repro_torch.core.spec import QuantSpec
    from repro_torch.launch import serve as CLI
    from repro_torch.models import transformer
    from repro_torch.serving import Engine

    cfg = configs.get_smoke("qwen2_moe")
    spec = QuantSpec(mode="msgemm", d=2, scale_block=8)
    out = {}
    refs = []
    with watching_cuts(refs):
        model = transformer.init_params(
            cfg, generator=torch.Generator().manual_seed(0), device="cpu",
            quant=spec)
        eng = Engine(model, cfg.replace(quant=spec), mesh=mesh,
                     mesh_rules="default", max_slots=2, block_size=4,
                     max_model_len=16)
        del model
    out["engine"] = _left_alive(refs, eng.params)
    del eng
    refs = []
    args = CLI.parse_args(["--arch", "qwen2_moe", "--smoke", "--device",
                           "cpu", "--d", "2", "--mesh", "data=2,model=2",
                           "--mesh-rules", "default"])
    with watching_cuts(refs), contextlib.redirect_stdout(None):
        copy = CLI.build_model(args, torch.device("cpu"), mesh=mesh)[0]
    out["cli"] = _left_alive(refs, copy)
    out["cli"]["served_on"] = copy.served_on
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
    out["ownership"] = ownership(mesh)
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
        with recording_blocks([]) as blocks:
            sharded = SV.generate(local, tcfg, b, max_new_tokens=new,
                                  mesh=mesh, step_logits=many)
        out[name] = dict(single=single, sharded=sharded,
                         single_logits=one, sharded_logits=many,
                         collectives=dict(coll.counts),
                         blocks=sorted(set(blocks)))
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
                    rules=("default", "serve"), moe_cfg=None, seq_cfg=None):
    """A real step of each dry-run serve cell ``shapes`` on this rank of a
    ``mesh_shape`` / ``axes`` mesh under each of ``rules``: the model
    drawn from ``seed`` (whole, then cut by ``shard_params``), the rank's
    inputs built as the dry run builds them (``launch.dryrun.
    serve_inputs``, random tokens, a decode at position ``seq_len - 1``
    over a zero cache).  Returns {rules: {cell: its collectives (count
    and bytes by kind) and argument bytes}}; with ``moe_cfg`` (a MoE
    config) also its cells under 'default', as {"moe": ...}, and with
    ``seq_cfg`` (a config whose query heads cannot take 'model') its
    cells under each of ``rules``, as {"seq": {rules: ...}}."""
    mesh = make_mesh(mesh_shape, axes)
    out = {r: _serve_cells(cfg, shapes, mesh, seed, r) for r in rules}
    if moe_cfg is not None:
        out["moe"] = _serve_cells(moe_cfg, shapes, mesh, seed, "default")
    if seq_cfg is not None:
        out["seq"] = {r: _serve_cells(seq_cfg, shapes, mesh, seed, r)
                      for r in rules}
    return out


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


def moe_counts_rank(rank, device, tree, tcfg, scenarios, kw, prompts,
                    new):
    """The continuous engine on a MoE model, one engine a scenario (name,
    mesh shape, axes, rule set): tokens, the MoE blocks' routed-slot
    counters summed (kept, total), dropped_frac, the collectives by kind,
    the all-gathers that gave a whole expert-stack leaf over 'data'
    (:func:`stacks_gathered`), the stacks held cut (``data_out``) and the
    leaves the blocks gather for a step (their ``fsdp`` records)."""
    from repro_torch import convert
    from repro_torch.models import moe
    from repro_torch.serving import Engine, Request

    out = {}
    for name, shape, axes, rules in scenarios:
        mesh = make_mesh(shape, axes)
        model = convert.params_from_jax(tree, tcfg, device="cpu")
        eng = Engine(model, tcfg, mesh=mesh, mesh_rules=rules, **kw)
        moe.reset_route_counts(model)  # the build's idle steps route too
        coll.reset_counts()
        seen = []
        with recording_gathers(seen):
            res = eng.run([Request(rid=i, prompt=p, max_new_tokens=new)
                           for i, p in enumerate(prompts)])
        counts = torch.stack([m.route_counts for m in moe._moes(model)])
        out[name] = dict(
            tokens={rid: s.generated for rid, s in res.items()},
            counts=counts.sum(0).tolist(), dropped=moe.dropped_frac(model),
            collectives=dict(coll.counts),
            stacks_gathered=stacks_gathered(seen, whole_stacks(
                eng.params, dict(zip(axes, shape)).get("data", 1))),
            data_out=[m.data_out for m in eng.params.modules()
                      if isinstance(m, moe.Experts)],
            fsdp=sorted(f"{p}.{k}" for p, m in eng.params.named_modules()
                        for k in getattr(m, "fsdp", {}) if p))
    return out
