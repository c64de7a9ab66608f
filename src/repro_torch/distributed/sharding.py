"""Logical-axis sharding rules; port of repro.distributed.sharding.

Tensors are annotated with *logical* axis names; a rule table maps logical
axes to mesh axes.  Spec construction is shape-aware and greedy, exactly
as the reference's:

* logical axes are resolved in PRIORITY order (e.g. 'expert' grabs the
  'model' mesh axis before 'mlp' does, 'kvheads' before 'kv_seq');
* a mesh axis is used at most once per spec;
* a candidate mesh axis is skipped when the dim size is not divisible by
  its size (qwen2-moe's 60 experts fall through to per-expert TP on
  mlp=1408).

A spec is a tuple with one entry a dim: None, a mesh axis name, or a
tuple of names (only 'batch' folds, over 'pod' x 'data') — the
reference's ``PartitionSpec`` as a tuple; :func:`compat.placements`
turns it into DTensor placements.

The tables are the reference's, copied.  The tree functions walk the
port's modules (``param_specs``: buffer names such as
``blocks.3.attn.wq.idx``, the names ``convert.port_path`` gives) and
caches (a list of per-layer dicts).  The port's leaves carry no stacked
'layers' dim (one module a layer), so a spec here is the reference's
without its leading 'layers' entry; an expert stack keeps its leading
'expert' dim.

On the port's serving path a mesh runs as one process a device, each
holding plain tensors: its own shard of every sharded weight and pool,
and whole activations, except that a step's batch rows may be split over
the batch axis (:func:`split_rows`, set by the engine).
:func:`constrain` takes this rank's slice of a whole tensor along the
dims its spec shards (no communication), and :func:`gather_rows` gathers
split batch rows.  Under the 'default' rules serving also stores the
weights FSDP-style (:func:`fsdp_store`): a rank keeps its 'data' block
of every leaf whose model dim takes 'data', and a block's leaves are
gathered back into the 'serve' layout for each step
(:func:`gather_fsdp`).

The expert stacks are the exception, in training and serving alike: a
stack's 'data' dim is its out dim ('expert_out'), and the stack stays
cut there.  The tokens move to the experts instead (``models.moe``, as
the reference pins them), so no stack leaf is ever gathered over 'data';
which projections are cut so is recorded as ``Experts.data_out``
(:func:`record_stacks`).
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import NamedTuple

import torch

from repro_torch.distributed import compat

# Resolution priority: earlier names grab contested mesh axes first.
PRIORITY = (
    "batch", "expert", "expert_out", "heads", "kvheads", "mlp", "vocab",
    "embed", "mamba_inner", "xl_inner", "kv_seq", "seq", "capacity",
    "stack", "layers", "head_dim", "conv", "state", "scales", "expert_in",
    "none",
)
assert PRIORITY.index("seq") > PRIORITY.index("heads")

# logical axis -> candidate mesh axes, tried in order.
ACT_RULES: dict[str, tuple[str, ...]] = {
    "batch": ("pod", "data"),  # folded: batch shards over pod x data
    # sequence-parallel fallback: when heads/kvheads cannot take the model
    # axis (llama4: 40 heads, gemma-2b: 8 heads on model=16), activations
    # shard over seq instead, bounding the attention-logits footprint.
    # PRIORITY puts 'seq' after heads/kvheads/mlp, so it only fires when
    # those fail divisibility.
    "seq": ("model",),
    "kv_seq": ("model",),  # decode caches: shard seq when heads cannot
    "heads": ("model",),
    "kvheads": ("model",),
    "head_dim": (),
    "embed": (),
    "mlp": ("model",),
    "vocab": ("model",),
    "expert": ("model",),
    # dispatch capacity dim = (examples x per-example slots): the major
    # factor is the batch, so 'data' sharding stays representable; without
    # it the dispatch buffers replicate when E can't take 'model'
    # (qwen2-moe: 5.4 GB/device -> 335 MB).
    "capacity": ("data",),
    # Expert FFN weights: out-dim takes the first free of model/data, the
    # in (contraction) dim stays replicated.  With E | model (llama4,
    # jamba) experts are then fully (expert x data)-sharded with NO FSDP
    # gather — tokens move to experts (EP all-to-all), not weights to
    # tokens.  With E unshardable (qwen2-moe 60) this degrades gracefully
    # to per-expert TP on 'model'.
    "expert_out": ("model", "data"),
    "expert_in": (),
    "mamba_inner": ("model",),
    "xl_inner": ("model",),
    "state": (),
    "conv": (),
    "stack": (),
    "layers": (),
    "scales": (),
    "none": (),
}

# Param tables: 2D FSDP x TP — big output dims on 'model', the residual
# ('embed') dim additionally on 'data' (ZeRO-3).  Expert FFN weights get
# the mlp dim on 'data' when 'model' is already taken by the expert dim.
PARAM_RULES: dict[str, tuple[str, ...]] = dict(
    ACT_RULES,
    embed=("data",),
    batch=(),
    kv_seq=(),
)

# A rule-set bundle selectable per run (cfg.logical_rules).
RULE_SETS = {
    "default": (ACT_RULES, PARAM_RULES),
    # serving at batch=1 (long_500k): nothing to gain from data-parallel
    # activations; keep params TP-only so no all-gathers on the hot path.
    "serve_tp": (
        dict(ACT_RULES, batch=()),
        dict(PARAM_RULES, embed=()),
    ),
    # batched serving (the continuous engine): activations keep the full
    # default table (batch over data, kvheads over model), but params
    # drop the embed/data FSDP dim — weights are TP-resident, so the
    # sharded quantized linears (repro_torch.dispatch.shard) see their
    # storage sharding exactly match their local shapes and the hot path
    # issues no per-layer FSDP gathers.
    "serve": (ACT_RULES, dict(PARAM_RULES, embed=())),
}


# The mesh axis tensor parallelism runs over: every rule that shards a
# weight's heads, hidden or channel dim maps it to 'model'.
TP_AXIS = "model"


class _Ctx(threading.local):
    mesh = None
    rules: str = "default"
    # the mesh axis (or folded axes, major first) a step's batch rows
    # split over
    rows: str | tuple | None = None


_CTX = _Ctx()


@contextlib.contextmanager
def use(mesh, rules: str = "default"):
    """Activate a mesh + rule set for logical constraints."""
    if rules not in RULE_SETS:
        raise ValueError(f"rules={rules!r}: one of {sorted(RULE_SETS)}")
    prev = (_CTX.mesh, _CTX.rules)
    _CTX.mesh, _CTX.rules = mesh, rules
    try:
        with compat.set_mesh(mesh):
            yield
    finally:
        _CTX.mesh, _CTX.rules = prev


def active_mesh():
    return _CTX.mesh


def active_rules() -> str:
    return _CTX.rules


def tp_size(mesh=None) -> int:
    """The size of :data:`TP_AXIS` on ``mesh`` (default the active one);
    1 without a mesh or without that axis."""
    mesh = mesh or _CTX.mesh
    return 1 if mesh is None else compat.axes_of(mesh).get(TP_AXIS, 1)


def _resolve(axes: tuple, shape: tuple, mesh, table: dict) -> tuple:
    """Greedy shape-aware logical->mesh resolution."""
    sizes = compat.axes_of(mesh)
    order = sorted(
        range(len(axes)),
        key=lambda i: PRIORITY.index(axes[i]) if axes[i] in PRIORITY else 99,
    )
    used: set[str] = set()
    out: list = [None] * len(axes)
    for i in order:
        name = axes[i]
        if name is None or name == "none":
            continue
        fold = name == "batch"  # only batch folds ('pod' x 'data')
        for cand in table.get(name, ()):
            if cand not in sizes or cand in used:
                continue
            if shape[i] % sizes[cand] == 0:
                out[i] = cand if out[i] is None else tuple(
                    (out[i] if isinstance(out[i], tuple) else (out[i],))
                    + (cand,))
                used.add(cand)
                if not fold:
                    break  # fallback semantics: first available candidate
        # combined divisibility for folded axes
        if isinstance(out[i], tuple):
            total = math.prod(sizes[a] for a in out[i])
            if shape[i] % total != 0:
                out[i] = out[i][0]
    return tuple(out)


def spec_for(axes: tuple, shape: tuple, *, mesh=None, kind: str = "act",
             rules: str | None = None) -> tuple:
    """The spec of a tensor of logical ``axes`` and ``shape``; ``()``
    without a mesh (the reference's ``P()``)."""
    mesh = mesh or _CTX.mesh
    if mesh is None:
        return ()
    act, par = RULE_SETS[rules or _CTX.rules]
    return _resolve(tuple(axes), tuple(shape), mesh,
                    act if kind == "act" else par)


def residual_axis(S: int, *, mesh=None) -> str | None:
    """The mesh axis the residual stream's ``S`` positions split over
    between blocks, or None (whole on every rank): the 'seq' entry of
    ``spec_for(("batch", "seq", "embed"), (1, S, 1))`` under the active
    rules, as the reference pins the residual after the embedding and
    after each block.  'embed' takes no mesh axis, so 'seq' gets 'model'
    wherever S divides its size (never at decode, S = 1)."""
    mesh = mesh or _CTX.mesh
    if mesh is None:
        return None
    return spec_for(("batch", "seq", "embed"), (1, S, 1), mesh=mesh)[1]


def seq_block(S: int, axis: str | None, mesh=None) -> tuple[int, int]:
    """(first position, length) of this rank's block of ``S`` positions
    split over ``axis`` (None: every position)."""
    if axis is None:
        return 0, S
    mesh = mesh or _CTX.mesh
    n = S // compat.axes_of(mesh)[axis]
    return coord(mesh, axis) * n, n


# ------------------------------------------------------ per-rank tensors
def coord(mesh, axis: str) -> int:
    """This rank's index along ``axis``."""
    return int(mesh.get_local_rank(axis))


def _names(entry) -> tuple:
    return () if entry is None else (
        entry if isinstance(entry, tuple) else (entry,))


def local_slice(x: torch.Tensor, spec: tuple, mesh, *,
                skip=()) -> torch.Tensor:
    """This rank's block of a whole tensor ``x`` under ``spec`` (dims in
    ``skip`` left whole); a view where it can be one."""
    sizes = compat.axes_of(mesh)
    for dim, entry in enumerate(spec):
        if dim in skip:
            continue
        for name in _names(entry):  # a folded entry splits major-first
            n = sizes[name]
            if n == 1:
                continue
            size = x.shape[dim] // n
            x = x.narrow(dim, coord(mesh, name) * size, size)
    return x


def local_index(shape: tuple, spec: tuple, mesh, *, coords=None):
    """This rank's block (or the one at ``coords``, {axis: index}) of a
    whole ``shape`` under ``spec`` as a tuple of slices (a folded entry
    splits major-first, as :func:`local_slice`); None when a dim does not
    divide by its axes."""
    sizes = compat.axes_of(mesh)
    out = []
    for dim, s in enumerate(shape):
        start, size = 0, s
        entry = spec[dim] if dim < len(spec) else None
        for name in _names(entry):
            if size % sizes[name]:
                return None
            size //= sizes[name]
            c = coords[name] if coords is not None else coord(mesh, name)
            start += c * size
        out.append(slice(start, start + size))
    return tuple(out)


def whole_shape(shape: tuple, spec: tuple, mesh) -> tuple:
    """The whole shape of a block of ``shape`` under ``spec``."""
    sizes = compat.axes_of(mesh)
    return tuple(s * math.prod(sizes[a] for a in _names(e))
                 for s, e in zip(shape, tuple(spec) + (None,) * len(shape)))


def _spec_axes(spec: tuple) -> set:
    return {a for e in spec for a in _names(e)}


def writes_block(spec: tuple, mesh) -> bool:
    """Whether this rank is the one that writes its block of a leaf under
    ``spec``: coordinate 0 on every axis that does not split it."""
    split = _spec_axes(spec)
    return all(coord(mesh, a) == 0 for a in compat.axes_of(mesh)
               if a not in split)


def block_owners(spec: tuple, mesh) -> list:
    """(global rank, {axis: coordinate}) of each rank that writes a block
    of a leaf under ``spec`` (:func:`writes_block`): one a block."""
    import numpy as np

    axes, split = list(compat.axes_of(mesh)), _spec_axes(spec)
    ranks = mesh.mesh.cpu().numpy()
    out = []
    for idx in np.ndindex(ranks.shape):
        coords = dict(zip(axes, idx))
        if all(coords[a] == 0 for a in axes if a not in split):
            out.append((int(ranks[idx]), coords))
    return out


def local_shape(shape: tuple, spec: tuple, mesh) -> tuple:
    """The shape of this rank's block of a ``shape`` tensor under
    ``spec``."""
    sizes = compat.axes_of(mesh)
    return tuple(s // math.prod(sizes[a] for a in _names(e))
                 for s, e in zip(shape, spec))


def _batch_dims(axes: tuple) -> tuple:
    return tuple(i for i, a in enumerate(axes) if a == "batch")


def constrain(x: torch.Tensor, *axes):
    """This rank's slice of the whole tensor ``x`` along the dims the
    active rules shard (no communication), the counterpart of the
    reference's ``with_sharding_constraint``; the 'batch' dim is left as
    it is (the engine places rows, :func:`split_rows`).  Without a mesh
    returns ``x`` itself."""
    mesh = _CTX.mesh
    if mesh is None:
        return x
    if len(axes) != x.ndim:
        raise ValueError(f"axes {axes} vs shape {tuple(x.shape)}")
    spec = spec_for(axes, _whole_shape(x.shape, axes, mesh), mesh=mesh)
    return local_slice(x, spec, mesh, skip=_batch_dims(axes))


def _whole_shape(shape, axes, mesh) -> tuple:
    """The shape whose rules decide a constraint: a split batch dim counts
    at its whole size."""
    if _CTX.rows is None:
        return tuple(shape)
    n = rows_factor()
    return tuple(s * n if a == "batch" else s for s, a in zip(shape, axes))


@contextlib.contextmanager
def split_rows(axis):
    """While active, a step's batch rows are split over ``axis`` (a mesh
    axis, or a tuple of them folded major first as a 'batch' spec entry
    folds them; None: whole on every rank): the engine and
    ``runtime.serve.generate`` set it around a step whose inputs they
    placed so."""
    prev, _CTX.rows = _CTX.rows, axis
    try:
        yield
    finally:
        _CTX.rows = prev


def row_axis():
    return _CTX.rows if _CTX.mesh is not None else None


def rows_factor() -> int:
    """How many ranks share the step's batch rows (1: rows whole)."""
    axis = row_axis()
    sizes = compat.axes_of(_CTX.mesh) if axis is not None else {}
    return math.prod(sizes[a] for a in _names(axis))


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Every rank's batch rows (dim 0) of a step whose rows are split;
    ``x`` itself otherwise."""
    axis = row_axis()
    if axis is None:
        return x
    from repro_torch.distributed import collectives as coll

    for name in reversed(_names(axis)):  # minor axis first
        x = coll.all_gather(x, name, dim=0, mesh=_CTX.mesh)
    return x


def psum_rows(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the ranks that split a step's batch rows (a
    count over the whole batch); ``x`` itself when the rows are whole."""
    axis = row_axis()
    if axis is None:
        return x
    from repro_torch.distributed import collectives as coll

    for name in _names(axis):
        x = coll.psum(x, name, mesh=_CTX.mesh)
    return x


# ---------------------------------------------------------------------------
# Param-tree spec inference
# ---------------------------------------------------------------------------
# Each linear/param leaf lives under a descriptive key; the table maps that
# key to logical axes of the *dense* (out, in) orientation.  Quantized
# layouts ('idx', 'u8', 'scales') inherit the same logical axes (their
# second dim is a packed function of 'in').  Leading stacked dims
# ('layers', 'expert') are prepended by the tree walker based on depth.

LINEAR_AXES: dict[str, tuple] = {
    "wq": ("heads", "embed"),
    "wk": ("kvheads", "embed"),
    "wv": ("kvheads", "embed"),
    "wo": ("embed", "heads"),
    "up": ("mlp", "embed"),
    "gate": ("mlp", "embed"),
    "down": ("embed", "mlp"),
    "router": ("expert", "embed"),
    "lm_head": ("vocab", "embed"),
    "in_proj": ("mamba_inner", "embed"),
    "x_proj": ("none", "mamba_inner"),
    "dt_proj": ("mamba_inner", "none"),
    "out_proj": ("embed", "mamba_inner"),
    "xl_up": ("xl_inner", "embed"),
    "xl_o": ("xl_inner", "embed"),
    "xl_gates": ("none", "xl_inner"),
    "xl_down": ("embed", "xl_inner"),
    "sl_w": ("embed", "none"),
    "sl_r": ("embed", "none"),
}
VECTOR_AXES: dict[str, tuple] = {
    "embedding": ("vocab", "embed"),
    "scale": ("none",),
    "bias": ("none",),
    "A_log": ("mamba_inner", "state"),
    "D": ("mamba_inner",),
    "conv_w": ("conv", "mamba_inner"),
    "conv_b": ("mamba_inner",),
    "xl_conv_w": ("conv", "xl_inner"),
    "xl_conv_b": ("xl_inner",),
    "xl_q": ("heads", "head_dim", "head_dim"),
    "xl_k": ("heads", "head_dim", "head_dim"),
    "xl_v": ("heads", "head_dim", "head_dim"),
}


def _leaf_axes(names: list, leaf_ndim: int) -> tuple:
    """Logical axes of the leaf at path ``names`` (its module and buffer
    names, outermost first)."""
    anc = None
    for n in reversed(names):
        if n in LINEAR_AXES or n in VECTOR_AXES:
            anc = n
            break
    leaf = names[-1]
    is_expert = any(n == "experts" for n in names)
    if anc in LINEAR_AXES:
        base = LINEAR_AXES[anc]
        if is_expert and anc in ("up", "gate", "down"):
            base = ("expert_out", "expert_in")
        if leaf in ("w", "idx", "u8"):
            axes = base
        elif leaf == "scales":
            axes = (base[0], "scales")
        elif leaf == "codebook":
            axes = ("scales",)  # 16-entry value table: replicated
        elif leaf in ("b", "bias"):
            axes = (base[0],)
        else:
            axes = base
    elif anc in VECTOR_AXES:
        axes = VECTOR_AXES[anc]
    else:
        axes = ("none",) * leaf_ndim
    # prepend stacked dims (experts; the port has no scan groups)
    extra = leaf_ndim - len(axes)
    if extra < 0:
        axes = axes[-leaf_ndim:] if leaf_ndim else ()
        extra = 0
    prefix = []
    for e in range(extra):
        if is_expert and e == extra - 1 and anc in ("up", "gate", "down"):
            prefix.append("expert")
        else:
            prefix.append("layers")
    return tuple(prefix) + tuple(axes)


def _leaves(tree) -> dict:
    """{dotted name: shape} of a module's buffers, or of a dict of
    tensors / shapes."""
    if isinstance(tree, torch.nn.Module):
        return {n: tuple(t.shape) for n, t in tree.named_buffers()}
    return {n: tuple(getattr(t, "shape", t)) for n, t in tree.items()}


def param_specs(params, mesh, rules: str = "default") -> dict:
    """{buffer name: spec} of a model (or a dict of name -> tensor or
    shape)."""
    return {name: spec_for(_leaf_axes(name.split("."), len(shape)), shape,
                           mesh=mesh, kind="param", rules=rules)
            for name, shape in _leaves(params).items()}


def shardings(params, mesh, rules: str = "default") -> dict:
    """{buffer name: DTensor placements} of :func:`param_specs`."""
    return {name: compat.placements(spec, mesh)
            for name, spec in param_specs(params, mesh, rules).items()}


# Decode/prefill cache leaves.
CACHE_AXES: dict[str, tuple] = {
    "k": ("batch", "kv_seq", "kvheads", "head_dim"),
    "v": ("batch", "kv_seq", "kvheads", "head_dim"),
    "cross_k": ("batch", "kv_seq", "kvheads", "head_dim"),
    "cross_v": ("batch", "kv_seq", "kvheads", "head_dim"),
    "ssm": ("batch", "mamba_inner", "state"),
    "conv": ("batch", "conv", "mamba_inner"),
    "C": ("batch", "heads", "head_dim", "head_dim"),
    "n": ("batch", "heads", "head_dim"),
    "m": ("batch", "heads"),
    "h": ("batch", "embed"),
    "c": ("batch", "embed"),
}


def cache_specs(cache, mesh, rules: str = "default") -> list[dict]:
    """Specs of a ``transformer.init_cache`` list (one dict a layer)."""

    def one(name, shape):
        axes = CACHE_AXES.get(name, ("none",) * len(shape))
        if len(axes) != len(shape):  # xlstm 'm' vs mamba trees etc.
            axes = ("none",) * len(shape)
        return spec_for(axes, shape, mesh=mesh, kind="act", rules=rules)

    return [{n: one(n, s) for n, s in _leaves(layer).items()}
            for layer in cache]


def static_cache_specs(cache, kinds, mesh, rules: str = "serve",
                       whole=()) -> list[dict]:
    """The specs the port's static engine holds a cache under: those of
    :func:`cache_specs`, except for the layers whose mixer each rank runs
    whole (their state keeps only its batch split).  ``kinds``: each
    layer's block kind; ``whole``: the kinds run whole on this mesh.  An
    sLSTM is always one of them: its state (B, d) is the 'embed' axis,
    whole under the serve rules, where the reference's table names its
    ``m`` by 'heads' for GSPMD to reshard."""
    specs = cache_specs(cache, mesh, rules)
    for layer, kind, spec in zip(cache, kinds, specs):
        if kind == "slstm" or kind in whole:
            for name, shape in _leaves(layer).items():
                spec[name] = spec_for(
                    ("batch",) + ("none",) * (len(shape) - 1), shape,
                    mesh=mesh, kind="act", rules=rules)
    return specs


# Paged-serving KV block pools (runtime.serve.init_paged_cache): the
# reference's leaves are (G, num_blocks, block_size, Hk, Dh), the port's
# one pool a layer without the leading 'layers' entry.  The pool has no
# batch dim — sequences own block subsets via host-side tables — so only
# the kvheads/head_dim tail shards (kvheads over 'model' per ACT_RULES);
# the block and slot dims stay replicated: scatter/gather by flat slot id
# must find every sequence's blocks on every data shard.
PAGED_CACHE_AXES: dict[str, tuple] = {
    # full-precision values *or* quantized u8 codes (last dim Dh or the
    # packed Dhp — 'head_dim' maps to () in serve rules, so both shard
    # identically: replicated tail, kvheads on 'model')
    "k": ("layers", "none", "none", "kvheads", "head_dim"),
    "v": ("layers", "none", "none", "kvheads", "head_dim"),
    # quantized-pool scale leaves (repro_torch.kvq.pool): (nb, bs, Hk)
    # f32, same (block, slot) replication + kvheads placement as the
    # codes so a flat slot id addresses codes and scales on the same shard
    "k_scale": ("layers", "none", "none", "kvheads"),
    "v_scale": ("layers", "none", "none", "kvheads"),
}


def paged_cache_specs(pool, mesh, rules: str = "default") -> list[dict]:
    """Specs of a ``runtime.serve.init_paged_cache`` list."""

    def one(name, shape):
        axes = PAGED_CACHE_AXES.get(
            name, ("layers",) + ("none",) * len(shape))[1:]
        return spec_for(axes, shape, mesh=mesh, kind="act", rules=rules)

    return [{n: one(n, s) for n, s in _leaves(layer).items()}
            for layer in pool]


def batch_specs(batch, mesh, rules: str = "default") -> dict:
    """Specs of data batches / serve inputs by rank."""

    def one(name, shape):
        if name in ("token", "pos"):
            axes = ("batch",)
        else:
            axes = {1: ("batch",), 2: ("batch", "seq"),
                    3: ("batch", "seq", "embed")}[len(shape)]
        return spec_for(axes, shape, mesh=mesh, kind="act", rules=rules)

    return {n: one(n, s) for n, s in _leaves(batch).items()}


# ---------------------------------------------------------------------------
# Training on a mesh: the state's shards, the FSDP gather
# ---------------------------------------------------------------------------
# Axes a training step's batch rows split over (the 'batch' rule folds
# them): each rank holds its rows; the rest of the mesh ('model') holds
# them all.
BATCH_AXES = ("pod", "data")


def batch_axes(mesh) -> tuple:
    """The axes of ``mesh`` that split a train step's batch rows (size >
    1 only), major first."""
    sizes = compat.axes_of(mesh)
    return tuple(a for a in BATCH_AXES if sizes.get(a, 1) > 1)


def local_rows(x, mesh, microbatches: int = 1):
    """This rank's rows (dim 0) of a whole batch tensor ``x`` (numpy or
    torch) of ``B`` rows: of each of the ``microbatches`` blocks of B / A
    rows (the step's microbatches, in order), this rank's block of its
    rows (:func:`batch_rows`), concatenated.  So microbatch i of the
    rank's rows is its share of the global microbatch i, which the
    single-device step takes whole; with one microbatch, rows ``first``
    to ``first + n``.  ValueError unless the rows divide."""
    B, A = x.shape[0], microbatches
    if B % A:
        raise ValueError(f"{B} rows do not split into {A} microbatches")
    first, n = batch_rows(B // A, mesh)
    per = x.reshape((A, B // A) + tuple(x.shape[1:]))[:, first:first + n]
    return per.reshape((A * n,) + tuple(x.shape[1:]))


def batch_rows(batch: int, mesh) -> tuple[int, int]:
    """(first row, row count) of this rank's rows of a ``batch``-row global
    batch: block ``pod_coord * data + data_coord`` of ``pod x data``.
    ValueError unless the batch divides over those axes."""
    sizes = compat.axes_of(mesh)
    axes = batch_axes(mesh)
    n = math.prod(sizes[a] for a in axes)
    if batch % n:
        raise ValueError(f"a global batch of {batch} rows does not split "
                         f"over {dict((a, sizes[a]) for a in axes)}")
    block = 0
    for a in axes:
        block = block * sizes[a] + coord(mesh, a)
    return block * (batch // n), batch // n


# Leaves whose rows hold two halves (x and z) of one projection: on a
# mesh that splits their rows, a rank's block is its block of each half
# ([x_r, z_r]), as the model code and serving (runtime.serve.
# shard_params) read it.  The whole leaf is kept in the single-device
# order; :func:`to_blocks` reorders its rows so that the contiguous cut
# of :func:`local_slice` gives those blocks, :func:`from_blocks` undoes
# it.
HALVES = ("in_proj", "xl_up")


def is_halves(name: str) -> bool:
    """Whether the buffer ``name`` (dotted) is a two-halves leaf."""
    parts = name.split(".")
    return len(parts) >= 2 and parts[-2] in HALVES and parts[-1] == "w"


def halves_parts(spec: tuple, mesh, dim: int = 0) -> int:
    """How many blocks ``spec`` cuts ``dim`` of a leaf into on ``mesh``."""
    entry = spec[dim] if dim < len(spec) else None
    return math.prod(compat.axes_of(mesh)[a] for a in _names(entry))


def _reorder(t, dim: int, lead: tuple, order):
    """``t`` with ``dim`` viewed as ``lead + (rest,)`` and those lead
    dims permuted by ``order`` (numpy or torch), flattened back."""
    shape = tuple(t.shape)
    view = t.reshape(shape[:dim] + lead + (-1,) + shape[dim + 1:])
    perm = list(range(view.ndim))
    perm[dim:dim + len(lead)] = [dim + i for i in order]
    view = view.transpose(*perm) if not isinstance(t, torch.Tensor) \
        else view.permute(*perm)
    return view.reshape(shape)


def to_blocks(t, parts: int, dim: int = 0):
    """A two-halves leaf's rows along ``dim`` (single-device order [x,
    z]) reordered to [x_0, z_0, x_1, z_1, ...] over ``parts`` blocks, so
    block p of a contiguous cut is [x_p, z_p]; ``t`` itself for one
    part.  ValueError unless each half divides."""
    if parts == 1:
        return t
    if t.shape[dim] % (2 * parts):
        raise ValueError(f"two halves of {t.shape[dim] // 2} rows do not "
                         f"split into {parts} blocks")
    return _reorder(t, dim, (2, parts), (1, 0))


def from_blocks(t, parts: int, dim: int = 0):
    """The inverse of :func:`to_blocks` (differentiable on torch)."""
    if parts == 1:
        return t
    return _reorder(t, dim, (parts, 2), (1, 0))


def _cut(t: torch.Tensor, name: str, spec: tuple, mesh) -> torch.Tensor:
    """This rank's block of the whole leaf ``t`` named ``name`` (a
    two-halves leaf's from both halves), a contiguous copy."""
    if is_halves(name):
        t = to_blocks(t, halves_parts(spec, mesh))
    return local_slice(t, spec, mesh).contiguous().clone()


STACKS = ("up", "gate", "down")  # an Experts module's stacked linears


def is_stack(name: str) -> bool:
    """Whether the buffer ``name`` (dotted) is a leaf of an expert stack."""
    parts = name.split(".")
    return len(parts) >= 3 and parts[-3] == "experts" and \
        parts[-2] in STACKS


def record_stacks(module: torch.nn.Module, cut) -> None:
    """Record on every ``Experts`` module under ``module`` (one with a
    ``data_out`` attribute) which of its stacks are held cut over 'data'
    along their out dim: those with a leaf among ``cut`` (buffer names
    relative to ``module``)."""
    for prefix, mod in module.named_modules():
        if hasattr(mod, "data_out"):
            head = f"{prefix}." if prefix else ""
            mod.data_out = tuple(
                n for n in STACKS
                if any(k.startswith(f"{head}{n}.") for k in cut))


def _owner(module: torch.nn.Module, name: str):
    """(the module holding buffer ``name``, its leaf name)."""
    path, _, leaf = name.rpartition(".")
    return (module.get_submodule(path) if path else module), leaf


def shard_model(model: torch.nn.Module, mesh, rules: str = "default"
                ) -> dict:
    """Cut every buffer of ``model`` (whole) to this rank's block under
    ``param_specs`` (in place, each block a contiguous copy; a two-halves
    leaf's block from both halves, :data:`HALVES`), and record the specs
    on the model and on each of its blocks, the encoder's too
    (``shard_specs``, names relative to the module) for
    :func:`constrain_params`.  Returns {buffer name: spec}."""
    specs = param_specs(model, mesh, rules)
    for name, spec in specs.items():
        mod, leaf = _owner(model, name)
        mod._buffers[leaf] = _cut(mod._buffers[leaf], name, spec, mesh)
    model.shard_specs = specs
    record_stacks(model, [n for n, s in specs.items()
                          if is_stack(n) and _splits(s, "data", mesh)])
    for prefix, mod in model.named_modules():
        if prefix.rpartition(".")[0] in ("blocks", "encoder.blocks"):
            mod.shard_specs = {n[len(prefix) + 1:]: s
                               for n, s in specs.items()
                               if n.startswith(prefix + ".")}
    return specs


MOMENTS = ("m", "v", "residual")  # per-leaf optimizer trees


class TreeSharding(NamedTuple):
    """How a tree's leaves lie on a mesh: ``specs`` maps a leaf's
    flattened name (nested keys joined with '/', as the checkpoint
    manager names them) to its spec; a leaf it does not name is whole on
    every rank.  ``halves`` maps a two-halves leaf (:data:`HALVES`) to the
    dim that holds its halves: its blocks are cut from both."""

    mesh: object
    specs: dict
    halves: dict = {}


def is_lead(mesh) -> bool:
    """Whether this rank is the mesh's first (coordinate 0 on every
    axis): the one that writes what all of them hold."""
    return all(coord(mesh, a) == 0 for a in compat.axes_of(mesh))


def mesh_barrier(mesh) -> None:
    """Return once every rank of ``mesh`` has called it: a host scalar
    summed over each axis in turn (a sum over the whole mesh)."""
    from repro_torch.distributed import collectives as coll

    t = torch.zeros(())
    for a in compat.axes_of(mesh):
        t = coll.psum(t, a, mesh=mesh)


def shard_state(state: dict, mesh, rules: str = "default") -> dict:
    """A whole train state (``runtime.train``) cut to this rank's blocks
    in place: the model's buffers (:func:`shard_model`) and the per-leaf
    optimizer trees under the same specs; ``count`` and ``step`` stay
    whole.  Records ``state["mesh"]`` and ``state["specs"]``."""
    specs = shard_model(state["params"], mesh, rules)
    for key in MOMENTS:
        if key in state["opt"]:
            state["opt"][key] = {n: _cut(t, n, specs[n], mesh)
                                 for n, t in state["opt"][key].items()}
    state["mesh"], state["specs"] = mesh, specs
    return state


def gather_leaf(x: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """The whole tensor of this rank's block ``x`` under ``spec`` (every
    rank calls it and gets it): the inverse of :func:`local_slice`."""
    from repro_torch.distributed import collectives as coll

    for dim, entry in enumerate(spec):
        for name in reversed(_names(entry)):  # minor axis first
            x = coll.all_gather(x, name, dim=dim, mesh=mesh)
    return x


def gather_state(state: dict) -> dict:
    """A sharded train state gathered whole, as the checkpoint tree of the
    single-device state: {"params": {name: tensor}, "opt": {"m", "v",
    ("residual",) "count"}, "step"}.  Every rank calls it (collectives)
    and gets it; a leaf whole on every rank (and every leaf without
    ``state["mesh"]``) is the state's own tensor, not a copy."""
    mesh, specs = state.get("mesh"), state.get("specs")

    def whole(name, t):
        if mesh is None:
            return t
        t = gather_leaf(t, specs[name], mesh)
        return from_blocks(t, halves_parts(specs[name], mesh)) \
            if is_halves(name) else t

    params = {n: whole(n, t) for n, t in state["params"].state_dict().items()}
    opt = {k: ({n: whole(n, t) for n, t in v.items()} if k in MOMENTS else v)
           for k, v in state["opt"].items()}
    return {"params": params, "opt": opt, "step": state["step"]}


def _map_buffers(module: torch.nn.Module, fn, prefix: str = ""):
    """A shallow copy of ``module`` (and its submodules) whose buffers are
    ``fn(name, buffer)`` (names relative to ``module``); ``module`` is
    untouched."""
    import copy

    new = copy.copy(module)
    new.__dict__["_buffers"] = {n: fn(prefix + n, t)
                                for n, t in module._buffers.items()}
    new.__dict__["_modules"] = {
        n: _map_buffers(m, fn, f"{prefix}{n}.")
        for n, m in module._modules.items()}
    return new


def _splits(spec: tuple, axis: str, mesh) -> bool:
    """Whether ``spec`` cuts a dim over ``axis``, an axis of more than one
    rank on ``mesh``."""
    return axis in _spec_axes(spec) and compat.axes_of(mesh)[axis] > 1


def _gather_fsdp(t: torch.Tensor, name: str, spec: tuple, mesh,
                 int8: bool):
    from repro_torch.distributed import collectives as coll

    dim = coll.spec_dim(spec, "data")
    if dim is None or compat.axes_of(mesh).get("data", 1) == 1 \
            or is_stack(name):  # a stack stays cut: the tokens move
        return t
    if int8 and t.is_floating_point():
        return coll.int8_all_gather(t, mesh, spec, axis="data")
    return coll.ad_all_gather(t, "data", dim=dim, mesh=mesh)


def constrain_params(tree, *, int8_gather: bool = False, specs=None):
    """A param (sub)tree with its FSDP ('data'-sharded) dims gathered, at
    the top of a layer group (the reference pins the group to its storage
    sharding there), but for the expert stacks, which stay cut
    (:func:`is_stack`: ``moe.moe_apply_tp`` moves the tokens to them).
    ``tree``: a module of a sharded model (its ``shard_specs``,
    :func:`shard_model`) or a dict of tensors with their ``specs``.  Each
    gathered leaf's gradient is reduce-scattered back to this rank's
    block (``collectives.ad_all_gather``); with ``int8_gather`` a float
    leaf crosses in int8 (``collectives.int8_all_gather``).  Without a
    mesh returns ``tree`` itself."""
    mesh = _CTX.mesh
    if mesh is None:
        return tree
    if isinstance(tree, torch.nn.Module):
        specs = tree.shard_specs if specs is None else specs
        return _map_buffers(tree, lambda n, t: _gather_fsdp(
            t, n, specs[n], mesh, int8_gather))
    return {n: _gather_fsdp(t, n, specs[n], mesh, int8_gather)
            for n, t in tree.items()}


# ---------------------------------------------------------------------------
# Serving with FSDP weight storage (the 'default' rules)
# ---------------------------------------------------------------------------
FSDP_AXIS = "data"
# the modules a serving copy gathers its 'data' blocks for: each block
# (the encoder's too) at the top of the block, an untied head before it
# runs; the embedding table is read in its blocks (models.transformer)
FSDP_MODULES = ("blocks", "encoder.blocks")


def fsdp_store(model: torch.nn.Module, specs: dict, mesh) -> dict:
    """Cut, in place, this rank's 'data' block of every leaf of ``model``
    (a serving copy, its leaves in the 'serve' layout) whose spec in
    ``specs`` (``param_specs(whole model, mesh, "default")``) puts 'data'
    on a dim (:func:`fsdp_cut`), and record the cut dims on the modules
    that gather them (:func:`fsdp_record`): each block, the encoder's
    too, and ``lm_head``; the table's own is ``model.fsdp["embedding"]``.
    Returns {buffer name: dim} of every cut leaf."""
    cut = fsdp_cut(model, specs, mesh)
    if compat.axes_of(mesh).get(FSDP_AXIS, 1) == 1:
        return cut
    owners = [p for p, _ in model.named_modules()
              if p.rpartition(".")[0] in FSDP_MODULES or p == "lm_head"]
    for prefix in owners:
        fsdp_record(model.get_submodule(prefix),
                    {k[len(prefix) + 1:]: d for k, d in cut.items()
                     if k.startswith(prefix + ".")})
    model.fsdp = {k: d for k, d in cut.items()
                  if not any(k.startswith(p + ".") for p in owners)}
    if set(model.fsdp) - {"embedding"}:
        raise ValueError(f"'data' cuts leaves no module gathers: "
                         f"{sorted(set(model.fsdp) - {'embedding'})}")
    return cut


def fsdp_cut(module: torch.nn.Module, specs: dict, mesh) -> dict:
    """Cut, in place, this rank's 'data' block of every leaf of ``module``
    that ``specs`` ({buffer name relative to ``module``: its whole leaf's
    spec under the 'default' rules}) cuts over 'data', each block a
    contiguous copy.  The cut is made on the leaf as it is stored, so it
    keeps the packed layout whole: a packed column is a msGeMM d-tuple or
    an int4 byte of two codes, and a scale leaf is cut only where its
    rows are the model dim; 'data' never takes a two-halves leaf's rows
    (``mamba_inner`` and ``xl_inner`` map to 'model' alone).  A leaf
    whose stored dim does not divide stays whole, the reference's
    divisibility rule; it is counted in
    ``serve_fsdp_whole_leaves_total``.  Returns {name: dim} of every cut
    leaf."""
    from repro_torch import obs
    from repro_torch.distributed import collectives as coll

    n = compat.axes_of(mesh).get(FSDP_AXIS, 1)
    cut: dict = {}
    if n == 1:
        return cut
    c = coord(mesh, FSDP_AXIS)
    for name, spec in specs.items():
        dim = coll.spec_dim(spec, FSDP_AXIS)
        if dim is None:
            continue
        if is_halves(name) and dim == 0:
            raise ValueError(f"{name}: 'data' cuts a two-halves leaf's rows")
        mod, leaf = _owner(module, name)
        t = mod._buffers[leaf]
        if t.shape[dim] % n:
            obs.registry().counter(
                "serve_fsdp_whole_leaves_total",
                help="leaves whose 'data' dim does not divide, stored "
                     "whole under the 'default' rules").inc()
            continue
        size = t.shape[dim] // n
        mod._buffers[leaf] = t.narrow(dim, c * size, size).contiguous() \
            .clone()
        cut[name] = dim
    return cut


def fsdp_record(owner: torch.nn.Module, cut: dict) -> None:
    """Record on ``owner`` (a block or ``lm_head``) the leaves of ``cut``
    ({name relative to ``owner``: dim}) that :func:`gather_fsdp` gathers
    for a step: ``owner.fsdp``, every cut leaf but the expert stacks',
    which stay cut (their out dim is 'data'; :func:`record_stacks`)."""
    owner.fsdp = {k: d for k, d in cut.items() if not is_stack(k)}
    record_stacks(owner, [k for k in cut if is_stack(k)])


def gather_fsdp(module: torch.nn.Module) -> torch.nn.Module:
    """``module`` with its 'data' blocks (its ``fsdp`` record,
    :func:`fsdp_store`) gathered whole over 'data' (counted as
    ``fsdp_gather``): a shallow copy in the 'serve' layout, held for one
    step and freed after it; ``module`` itself when it stores nothing cut
    or no mesh is active."""
    fsdp = getattr(module, "fsdp", None)
    mesh = _CTX.mesh
    if not fsdp or mesh is None:
        return module
    from repro_torch.distributed import collectives as coll

    return _map_buffers(module, lambda n, t: coll.all_gather(
        t, FSDP_AXIS, dim=fsdp[n], mesh=mesh, kind="fsdp_gather")
        if n in fsdp else t)


def rows_block(x: torch.Tensor) -> torch.Tensor:
    """This rank's batch rows (dim 0) of the whole batch ``x`` of a step
    whose rows are split (the inverse of :func:`gather_rows`); ``x``
    itself otherwise."""
    axis = row_axis()
    return x if axis is None else local_slice(x, (axis,), _CTX.mesh)
