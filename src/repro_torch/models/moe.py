"""Mixture-of-Experts FFN: top-k routing, capacity-bounded sort-free
dispatch (one-hot cumsum positions + scatter), shared experts, aux terms;
port of repro.models.moe.

Expert weights are stacked (E, d_ff, d) in one :class:`QLinear` per
projection, and each projection of all E experts runs as one call: on
the card one launch of the int4 kernel over the stack (``dispatch``'s
expert axis), where the reference vmaps ``linear_apply`` over the
experts.  The dispatch is per example, as the reference's (``moe_groups``
only shapes the reference's sharding), and has no data-dependent shape,
no ``.item()`` and no ``nonzero``, so a step that runs it can be captured
as a CUDA graph.

``MoE.route_counts`` (int64 (2,) on the router's device: routed slots
kept, routed slots in all) adds up every ``moe_apply`` of the module, a
CUDA graph's replays included, but not a training forward's remat
recompute; :func:`dropped_frac` reads it over a run and
:func:`reset_route_counts` zeroes it.

Serving on a mesh (:func:`expert_layout`, recorded as
``Experts.layout``; the reference's priority:
'expert' takes 'model' before 'expert_out'): every rank routes every
token alike, on the router it keeps whole (an (E, d) f32 weight: no
gather of router logits is needed), so its counters read as one
device's (a step whose rows split over 'data' sums its counts over
them).  Where 'model' divides E the block is expert-parallel: a rank
holds E/M experts and runs them in one launch a projection over their
slots.  Otherwise, where it divides the experts' hidden dim, each expert
is tensor-parallel: up and gate hold this rank's block of the hidden dim
and ``down`` the matching block of its contraction
(``runtime.serve.shard_params``; whole where the packed storage cannot
split there, and then the hidden block is gathered).  Either way a
rank's combine is a partial sum of the experts' outputs, and one psum
over 'model' ends it.  A shared expert runs as any MLP on a mesh.  A
training step on a mesh runs the same layouts on the stacks
``sharding.shard_model`` cut (:func:`moe_apply_tp`), its aux terms the
whole batch's.

Where a stack's out dim lies over 'data' (the reference's
'expert_out', ``sharding.PARAM_RULES``: 'ep' on (data, model), as
llama4, jamba and qwen2-moe at model=2, and every mesh with no 'model'
axis) the stack stays cut there, in training and under the 'default'
serving rules, and the tokens move to the experts, as the reference pins
the dispatched slots to ``("expert", "capacity", "expert_in")`` and the
hidden to ``("expert", "capacity", "expert_out")``
(:class:`_ToExperts`): a rank gathers its experts' slots from every
'data' rank (the tokens), runs up and gate on its block of the hidden
dim, gathers the hidden whole over 'data' for ``down`` (whose
contraction is whole in its leaf), runs ``down`` on its block of d, and
returns each 'data' rank's slots with all d columns to it in one
all-to-all; the psum over 'model' ends the combine as before.  No stack
leaf is gathered; ``Experts.data_out`` names the stacks held so.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.core import linear as qlinear
from repro_torch.core.spec import expert_spec
from repro_torch.distributed import collectives as coll
from repro_torch.distributed import compat, sharding
from repro_torch.models import common
from repro_torch.quant.quantize import stack_experts


class Experts(nn.Module):
    """The stacked up / down (+ gate for GeGLU/SwiGLU) expert linears.
    What ``runtime.serve.shard_params`` cut on a mesh: ``layout``, the
    :func:`expert_layout` (None: whole), and ``down_local``, whether
    ``down`` holds this rank's block of its contraction ('tp');
    ``data_out``, the stacks held cut over 'data' along their out dim
    (``sharding.record_stacks``: the 'default' rules' serving copy, a
    training step's model), which the tokens move to."""

    layout = None
    down_local = False
    data_out = ()

    def __init__(self, up, down, gate=None):
        super().__init__()
        self.up, self.down = up, down
        if gate is not None:
            self.gate = gate


class MoE(nn.Module):
    """router (``w`` (E, d) f32, never quantized), the expert stacks, and
    the shared experts' fused MLP when the config has them."""

    def __init__(self, router: qlinear.QLinear, experts: Experts,
                 shared: common.MLP | None = None):
        super().__init__()
        self.router, self.experts = router, experts
        if shared is not None:
            self.shared = shared
        # a plain attribute, not a buffer: run-time counters are no weight
        self.route_counts = torch.zeros(2, dtype=torch.int64,
                                        device=router.w.device)


def _stack_init(E: int, in_dim: int, out_dim: int, cfg, quant, *,
                generator, device) -> qlinear.QLinear:
    """E experts' linears, each drawn as ``common.linear_init`` draws one
    and stored under ``expert_spec(quant)`` (``quantize.stack_experts``:
    no more than one expert's dense weight exists at a time)."""
    return qlinear.QLinear(stack_experts(
        E, lambda e: qlinear.init(in_dim, out_dim, generator=generator,
                                  device=device)["w"],
        quant, dtype=getattr(torch, cfg.param_dtype)))


def moe_init(cfg, *, generator: torch.Generator, device=None,
             quant=None) -> MoE:
    """Random router, experts and shared MLP.  The experts are drawn one at
    a time and, with ``quant`` (or a quantized ``cfg.quant``), quantized
    under ``expert_spec`` right after each is drawn; the shared MLP follows
    ``cfg.quant`` (``init_params`` quantizes it with the block)."""
    d = cfg.d_model
    mdff = cfg.moe_d_ff or cfg.d_ff
    E = cfg.num_experts
    kw = dict(generator=generator, device=device)
    w = torch.empty((E, d), device=device)
    nn.init.trunc_normal_(w, a=-2.0, b=2.0, generator=generator)
    router = qlinear.QLinear({"w": w * d**-0.5})
    spec = quant if quant is not None else cfg.quant
    gated = cfg.mlp_activation in ("swiglu", "geglu")
    experts = Experts(_stack_init(E, d, mdff, cfg, spec, **kw),
                      _stack_init(E, mdff, d, cfg, spec, **kw),
                      _stack_init(E, d, mdff, cfg, spec, **kw)
                      if gated else None)
    shared = None
    if cfg.num_shared_experts:
        sdff = cfg.shared_expert_d_ff or cfg.num_shared_experts * mdff
        shared = common.mlp_init(cfg, sdff, **kw)
    return MoE(router, experts, shared)


def expert_layout(cfg, mesh) -> str | None:
    """How the ranks of 'model' on ``mesh`` hold the expert stacks: 'ep'
    (E/M experts a rank), 'tp' (a block of every expert's hidden dim) or
    None (whole)."""
    M = sharding.tp_size(mesh)
    if M == 1:
        return None
    if cfg.num_experts % M == 0:
        return "ep"
    return "tp" if (cfg.moe_d_ff or cfg.d_ff) % M == 0 else None


def _expert_ffn(pe: Experts, x: torch.Tensor, cfg) -> torch.Tensor:
    """x (E, C, d) -> (E, C, d) through the stacked linears, each one call
    for all experts.  Quantized experts run ``int4_dequant`` in msgemm mode
    too (``expert_spec``): an expert's m is below 16^d, so the LUT
    produce cannot amortize, and each expert would need its own LUT over
    its routed activations.  The 'moe_' tags keep the experts' input
    statistics apart from the dense MLPs' in the calibration observer; the
    activation rides the linear's fused epilogue."""
    q = expert_spec(cfg.quant)
    act_name = {"swiglu": "silu", "geglu": "gelu",
                "gelu": "gelu"}[cfg.mlp_activation]

    def lin(name, h, act="none"):
        return common.linear_apply(getattr(pe, name), h, q,
                                   in_dim=h.shape[-1], tag=f"moe_{name}",
                                   act=act)

    moved = _ToExperts(pe, x.shape[1], split=_rows_over_data())
    x = moved.tokens(x)
    if hasattr(pe, "gate"):
        up = lin("up", x)
        h = lin("gate", x, act_name) * up
    else:
        h = lin("up", x, act_name)
    h = moved.hidden(h)
    if pe.layout == "tp" and not pe.down_local:
        h = coll.all_gather(h, sharding.TP_AXIS, dim=-1)  # whole down
    return moved.back(lin("down", h))


def _rows_over_data() -> bool:
    """Whether a serving step's batch rows are split over 'data'."""
    axis = sharding.row_axis()
    return sharding.FSDP_AXIS in (axis if isinstance(axis, tuple)
                                  else (axis,))


class _ToExperts:
    """The tokens' way to the stacks held cut over 'data' along their out
    dim (``pe.data_out``; the identity where none is), for slots
    (El, n, d) of this rank's experts: :meth:`tokens` gathers every
    'data' rank's slots (``split``: the step's rows, so its slots, are
    split over 'data'; otherwise every rank holds them all),
    :meth:`hidden` gathers a hidden cut along its dim whole for
    ``down``, :meth:`back` returns each rank's slots with all d columns
    to it.  ``train``: the autograd forms (a gather's backward
    reduce-scatters: each rank's cotangent is its weight block's part of
    the gradient; the all-to-all's is the reverse all-to-all)."""

    def __init__(self, pe: Experts, n: int, *, split: bool,
                 train: bool = False):
        self.pe, self.n, self.train = pe, n, train
        self.split = split and bool(pe.data_out)
        self.c = sharding.coord(sharding.active_mesh(), sharding.FSDP_AXIS) \
            if self.split else 0

    def _gather(self, t, dim, kind):
        if self.train:
            return coll.ad_all_gather(t, sharding.FSDP_AXIS, dim=dim,
                                      kind=kind)
        return coll.all_gather(t, sharding.FSDP_AXIS, dim=dim, kind=kind)

    def tokens(self, x):
        return self._gather(x, 1, "expert_tokens") if self.split else x

    def hidden(self, h):
        return self._gather(h, -1, "expert_hidden") \
            if "up" in self.pe.data_out else h

    def back(self, y):
        if "down" in self.pe.data_out:
            if not self.split:
                return self._gather(y, -1, "expert_return")
            a2a = coll.ad_all_to_all if self.train else coll.all_to_all
            return a2a(y, sharding.FSDP_AXIS, split_dim=1, concat_dim=-1,
                       kind="expert_return")
        if self.split:  # this rank's slots of outputs computed for all
            return y.narrow(1, self.c * self.n, self.n)
        return y


def route(p: MoE, x: torch.Tensor, cfg, *, capacity: int | None = None,
          weight: torch.Tensor | None = None) -> dict:
    """The routing of x (B, S, d) (by ``weight``, default the router's
    own): f32 router ``logits`` (B, S, E), the
    top-k experts ``eidx`` (B, S, K) and their softmaxed ``gates``, the
    per-example ``capacity`` C, the (B, S*K, E) ``onehot`` of the slots'
    experts in (s, k) order, ``keep`` (B, S*K: the slot's position in its
    expert is below C) and ``dest`` (B, S*K: ``e·C + pos``, or the
    sentinel E·C for a dropped slot)."""
    B, S, _ = x.shape
    E, K = cfg.num_experts, cfg.num_experts_per_tok
    w = p.router.w if weight is None else weight
    logits = torch.einsum("bsd,ed->bse", x.to(torch.float32),
                          w.to(torch.float32))
    gates, eidx = torch.topk(logits, K, dim=-1)  # sorted, as lax.top_k
    gates = torch.softmax(gates, dim=-1)
    if capacity is None:
        capacity = max(int(S * K / E * cfg.capacity_factor), 4)
    C = capacity
    flat = eidx.reshape(B, S * K)
    oh = (flat[..., None] == torch.arange(E, device=x.device)).to(
        torch.int32)
    pos = ((torch.cumsum(oh, dim=1) - 1) * oh).sum(-1)
    keep = pos < C
    return dict(logits=logits, gates=gates, eidx=eidx, capacity=C,
                onehot=oh, keep=keep,
                dest=torch.where(keep, flat * C + pos, E * C))


def moe_apply(p: MoE, x: torch.Tensor, cfg, *, capacity: int | None = None,
              seq: str | None = None):
    """x (B, S, d) -> (y (B, S, d), aux dict of 0-d f32 tensors).
    ``seq``: the residual's positions lie over that axis, ``x`` is this
    rank's block of them and so is ``y``: the block is gathered and
    routed whole (the capacity is per example over its whole sequence),
    and the combine's sum over 'model' is reduce-scattered over the
    positions (a combine every rank computes whole is cut to the block).

    Switch-style capacity dispatch, one group per example as the
    reference's: top-k over the f32 router logits, softmax over the k;
    each (token, k) slot's position in its expert from a one-hot cumsum
    in (s, k) order; slot ``e·C + pos`` of an (E·C + 1, d) buffer per
    example, the last row the sentinel that takes every dropped slot
    (pos >= C) and is dropped.  Only the sentinel row receives duplicate
    indices, so the scatter (``index_copy_``) is deterministic wherever
    it is read.  The experts see (E, B·C, d); their outputs are gathered
    back per slot, weighted by the kept gates and summed over k; the
    shared MLP adds on.  ``aux``: the Switch ``load_balance`` term and
    ``dropped_frac``, the share of slots past capacity."""
    x = common.seq_gather(x, seq)
    B, S, _ = x.shape
    E, K = cfg.num_experts, cfg.num_experts_per_tok
    r = route(p, x, cfg, capacity=capacity)
    C, keep = r["capacity"], r["keep"]
    dispatched, slots = _dispatch(x, r, E)

    lay = p.experts.layout
    if lay == "ep":  # this rank's experts; the others' rows stay zero
        El = E // sharding.tp_size()
        e0 = sharding.coord(sharding.active_mesh(), sharding.TP_AXIS) * El
        mine = _expert_ffn(p.experts, dispatched[e0:e0 + El], cfg)
        out = mine.new_zeros((E,) + mine.shape[1:])
        out[e0:e0 + El] = mine
    else:
        out = _expert_ffn(p.experts, dispatched, cfg)  # (E, B*C, d)
    gathered = _slot_rows(out, slots, B, S, K, C)
    w = r["gates"] * keep.reshape(B, S, K)
    if lay == "ep" or (lay == "tp" and p.experts.down_local):
        # each rank's part of the sum, summed over the ranks in f32 (onto
        # this rank's positions where the residual splits)
        y = torch.einsum("bskd,bsk->bsd", gathered.to(torch.float32), w)
        y = (coll.psum(y, sharding.TP_AXIS) if seq is None else
             common.seq_scatter(y, seq, partial=True)).to(gathered.dtype)
    else:
        y = common.seq_scatter(torch.einsum(
            "bskd,bsk->bsd", gathered, w.to(gathered.dtype)), seq,
            partial=False)

    if hasattr(p, "shared"):
        y = y + common.mlp_apply(p.shared, x, cfg, seq=seq,
                                 gathered=True).to(y.dtype)

    probs = torch.softmax(r["logits"], dim=-1)
    me = probs.mean(dim=(0, 1))
    ce = _expert_counts(r, B, S, K, E).mean(dim=(0, 1))
    aux = {"load_balance": E * torch.sum(me * ce),
           "dropped_frac": 1.0 - keep.to(torch.float32).mean()}
    if not qlinear.replaying():  # a remat recompute counts no slot twice
        if sharding.row_axis() is None:
            p.route_counts[0] += keep.sum()
            p.route_counts[1] += keep.numel()
        else:  # every rank's rows
            p.route_counts += sharding.psum_rows(torch.stack(
                [keep.sum(), torch.tensor(keep.numel(), device=x.device)]))
    return y.to(x.dtype), aux


def _dispatch(x: torch.Tensor, r: dict, E: int):
    """(the (E, B·C, d) rows each expert sees, the flat slot of every
    (token, k) in the (B·(E·C + 1), d) buffer): each slot's token row
    written to ``e·C + pos`` of its example's rows, the last row the
    sentinel that takes every dropped slot."""
    B, S, d = x.shape
    C, K = r["capacity"], r["eidx"].shape[-1]
    rows = E * C + 1
    slots = (torch.arange(B, device=x.device)[:, None] * rows
             + r["dest"]).reshape(-1)
    xr = x[:, :, None, :].expand(B, S, K, d).reshape(B * S * K, d)
    buf = x.new_zeros((B * rows, d))
    buf.index_copy_(0, slots, xr)
    return (buf.view(B, rows, d)[:, :E * C].reshape(B, E, C, d)
            .transpose(0, 1).reshape(E, B * C, d)), slots


def _slot_rows(out: torch.Tensor, slots, B: int, S: int, K: int, C: int):
    """The experts' outputs (E, B·C, d) read back per (token, k) slot:
    (B, S, K, d), a dropped slot's row zero."""
    E, d = out.shape[0], out.shape[-1]
    out = out.reshape(E, B, C, d).transpose(0, 1).reshape(B, E * C, d)
    padded = torch.cat([out, out.new_zeros((B, 1, d))], dim=1)
    return padded.reshape(B * (E * C + 1), d).index_select(0, slots) \
        .reshape(B, S, K, d)


def _expert_counts(r: dict, B: int, S: int, K: int, E: int):
    """(B, S, E) f32: how many of each token's k slots chose each
    expert."""
    return r["onehot"].reshape(B, S, K, E).sum(2).to(torch.float32)


def train_layout(pe: Experts, cfg, mesh) -> str | None:
    """The layout of the expert stacks in a training step on ``mesh`` (a
    model cut by ``sharding.shard_model``, gathered over 'data'): the
    :func:`expert_layout` of ``cfg``, decided as serving decides it.
    NotImplementedError where the stacks' leaves are not cut so (the
    rules gave 'model' to another dim)."""
    lay = expert_layout(cfg, mesh)
    E, mdff = cfg.num_experts, cfg.moe_d_ff or cfg.d_ff
    M = sharding.tp_size(mesh)
    want = {"ep": (E // M, mdff), "tp": (E, mdff // M), None: (E, mdff)}[lay]
    if "up" in pe.data_out:  # its out dim held cut over 'data' too
        want = (want[0], want[1] // compat.axes_of(mesh)[sharding.FSDP_AXIS])
    got = tuple(pe.up.w.shape[:2])
    if got != want:
        raise NotImplementedError(
            f"{cfg.name}: the expert stacks' leaves {got} (experts, hidden) "
            f"are not cut as the {lay!r} layout on model={M} needs "
            f"({want}; rules {sharding.active_rules()!r})")
    return lay


def moe_apply_tp(p: MoE, x: torch.Tensor, cfg, *, axis: str = "model",
                 seq: str | None = None):
    """:func:`moe_apply` of a training step on a mesh (its context
    active), on this rank's rows and its weights gathered over 'data':
    (y, aux), aux this rank's shares of the whole batch's terms (their
    sum over 'pod' x 'data' is the single device's).  ``seq``: the
    residual's positions lie over that axis, and ``x`` and ``y`` are
    this rank's block of them: the block is gathered whole at entry
    (its backward takes this rank's block of the whole gradient, which
    every rank holds) and routed whole, since the capacity is per
    example over its whole sequence, so the routing, the drops and the
    aux terms are one device's; the combine's psum becomes a
    reduce-scatter over the positions (a combine every rank computes
    whole is cut to the block), and so does the shared experts'.

    The router is whole on every rank (gathered over ``axis`` where its
    rows split), so every rank routes its rows alike and the routing,
    the gates and the aux terms run replicated over ``axis``.  In the
    :func:`train_layout` 'ep' (E/M experts a rank) or 'tp' (a block of
    every expert's hidden dim, ``down`` row-parallel on the matching
    columns, cut from its whole stack) each rank computes a part of the
    combine: the dispatched rows and the gates enter through
    ``ad_identity`` (their gradients sum the ranks' parts) and the
    combine ends in one ``ad_psum`` over ``axis`` in f32; with neither,
    each rank runs every expert whole.  Stacks held cut over 'data'
    (``Experts.data_out``) take the tokens of every 'data' rank
    (:class:`_ToExperts`, its autograd forms): their gradients are this
    rank's block's whole, and no reduce-scatter follows.  The shared
    experts run through ``common.mlp_apply_tp``.

    ``load_balance`` is E·Σ me·ce with ``me`` and ``ce`` the whole
    batch's means: the rows' sums (and the kept and routed slot counts)
    summed over the batch axes in one psum whose backward sums the
    ranks' cotangents too, so each rank's rows get their part of the
    gradient once; each rank hands on 1/n of the term and of
    ``dropped_frac`` (n the ranks sharing the rows), which the step's
    psum of the metrics adds back up.  ``route_counts`` adds the whole
    batch's slots on every rank."""
    x = common.seq_gather(x, seq)
    B, S, d = x.shape
    E, K = cfg.num_experts, cfg.num_experts_per_tok
    mesh = sharding.active_mesh()
    M = sharding.tp_size(mesh)
    lay = train_layout(p.experts, cfg, mesh)
    router = common.whole_rows(p.router.w, E, 0, axis, partial=False)
    r = route(p, x, cfg, weight=router)
    C, keep = r["capacity"], r["keep"]
    pe = p.experts
    act = {"swiglu": "silu", "geglu": "gelu",
           "gelu": "gelu"}[cfg.mlp_activation]
    xd = coll.ad_identity(x, axis) if lay else x
    dispatched, slots = _dispatch(xd, r, E)
    if lay == "ep":
        El = E // M
        e0 = sharding.coord(mesh, axis) * El
        dispatched = dispatched[e0:e0 + El]
        down = pe.down.w
    elif lay == "tp":
        mdff = cfg.moe_d_ff or cfg.d_ff
        n = mdff // M
        down = common.whole_rows(pe.down.w, d, 1, axis, partial=True
                                 ).narrow(2, sharding.coord(mesh, axis) * n, n)
    elif "down" in pe.data_out:
        down = pe.down.w
    else:
        down = common.whole_rows(pe.down.w, d, 1, axis, partial=False)
    moved = _ToExperts(pe, dispatched.shape[1], split=True, train=True)
    dispatched = moved.tokens(dispatched)
    if hasattr(pe, "gate"):  # as _expert_ffn, each stack one call
        up = common.local_linear(pe.up.w, dispatched, tag="moe_up")
        h = common.local_linear(pe.gate.w, dispatched, tag="moe_gate",
                                act=act) * up
    else:
        h = common.local_linear(pe.up.w, dispatched, tag="moe_up", act=act)
    mine = moved.back(common.local_linear(down, moved.hidden(h),
                                          tag="moe_down"))
    if lay == "ep":
        out = mine.new_zeros((E,) + mine.shape[1:])
        out[e0:e0 + El] = mine
    else:
        out = mine
    gathered = _slot_rows(out, slots, B, S, K, C)
    w = r["gates"] * keep.reshape(B, S, K)
    if lay:
        w = coll.ad_identity(w, axis)
        y = torch.einsum("bskd,bsk->bsd", gathered.to(torch.float32), w)
        y = (coll.ad_psum(y, axis) if seq is None else
             common.seq_scatter(y, seq, partial=True)).to(gathered.dtype)
    else:
        y = common.seq_scatter(torch.einsum(
            "bskd,bsk->bsd", gathered, w.to(gathered.dtype)), seq,
            partial=False)
    if hasattr(p, "shared"):
        sdff = cfg.shared_expert_d_ff or cfg.num_shared_experts * (
            cfg.moe_d_ff or cfg.d_ff)
        y = y + common.mlp_apply_tp(p.shared, x, cfg, residual=None,
                                    d_ff=sdff, axis=axis, seq=seq,
                                    gathered=True).to(y.dtype)
    probs = torch.softmax(r["logits"], dim=-1)
    counts = _expert_counts(r, B, S, K, E)
    stats = torch.cat([probs.sum(dim=(0, 1)), counts.sum(dim=(0, 1)),
                       torch.stack([keep.sum().to(torch.float32),
                                    torch.tensor(float(keep.numel()),
                                                 device=x.device)])])
    ranks = 1
    for a in sharding.batch_axes(mesh):
        stats = coll.ad_psum(stats, a, partial=True)
        ranks *= compat.axes_of(mesh)[a]
    me, ce = stats[:E] / (B * S * ranks), stats[E:2 * E] / (B * S * ranks)
    kept, slots_all = stats[2 * E], stats[2 * E + 1]
    aux = {"load_balance": E * torch.sum(me * ce) / ranks,
           "dropped_frac": (1.0 - kept / slots_all) / ranks}
    if not qlinear.replaying():  # a remat recompute counts no slot twice
        p.route_counts += torch.stack([kept, slots_all]).detach().to(
            torch.int64)
    return y.to(x.dtype), aux


def _moes(model: nn.Module):
    return [m for m in model.modules() if isinstance(m, MoE)]


def reset_route_counts(model: nn.Module) -> None:
    """Zero every MoE block's routed-slot counters."""
    for m in _moes(model):
        m.route_counts.zero_()


def dropped_frac(model: nn.Module) -> float | None:
    """Slots dropped past capacity over every MoE block and call since the
    last reset (pads and idle engine rows included, as the reference's
    aux term counts them); None for a model without MoE blocks or
    before any routing."""
    counts = [m.route_counts for m in _moes(model)]
    if not counts:
        return None
    kept, total = (int(v) for v in torch.stack(counts).sum(0).tolist())
    return None if total == 0 else 1.0 - kept / total
