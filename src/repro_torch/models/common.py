"""Shared building blocks — norms, linear glue, soft-cap, MLP, the
recurrences' chunked scan, rematerialization (:func:`remat`) for
training; port of repro.models.common.  Serving on a mesh runs each
linear by the layout ``runtime.serve.shard_params`` cut and recorded on
it (``QLinear.axes``, from ``distributed.sharding.LINEAR_AXES``), so
under an active mesh it runs sharded (``dispatch.shard``), in the
training layout: where shard_params split the
MLP's hidden dim over 'model' (:func:`col_sharded`), up and gate keep
their outputs sharded into a row-parallel ``down`` (``x_axis``), whose
collective resolves the sum with the residual in its epilogue once.

Training on a mesh runs the MLP tensor-parallel instead
(:func:`mlp_apply_tp`, on the weights ``constrain_params`` gathered over
'data'): up and gate column-parallel over 'model', their outputs kept
sharded into a row-parallel ``down`` and one psum, each linear a plain
product of this rank's block (:func:`local_linear`).
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.core import linear as qlinear
from repro_torch.core.epilogue import Epilogue, act_fn, apply_epilogue
from repro_torch.distributed import collectives as coll
from repro_torch.distributed import sharding


def truncated_normal(shape, scale: float, *, generator: torch.Generator,
                     device=None) -> torch.Tensor:
    """A normal draw truncated to [-2, 2], times ``scale`` (f32)."""
    t = torch.empty(shape, device=device)
    nn.init.trunc_normal_(t, a=-2.0, b=2.0, generator=generator)
    return t * scale


class Tree(nn.Module):
    """One module per dict of the reference's param tree: each key a child
    module (a linear, a norm, an MLP) or a tensor buffer (the plain
    weights of a recurrent block), under the reference's name."""

    def __init__(self, **parts):
        super().__init__()
        for name, v in parts.items():
            if isinstance(v, nn.Module):
                self.add_module(name, v)
            else:
                self.register_buffer(name, v)


class Norm(nn.Module):
    """RMSNorm (``scale``) or LayerNorm (``scale`` + ``bias``) weights."""

    def __init__(self, scale: torch.Tensor, bias: torch.Tensor | None = None):
        super().__init__()
        self.register_buffer("scale", scale)
        if bias is not None:
            self.register_buffer("bias", bias)


def norm_init(d: int, kind: str, *, device=None) -> Norm:
    return Norm(torch.ones(d, device=device),
                torch.zeros(d, device=device) if kind == "layernorm" else None)


def norm_apply(p: Norm, x: torch.Tensor, kind: str, *,
               rms_offset: bool = False, eps: float = 1e-6) -> torch.Tensor:
    """Computed in float32, cast back to x's dtype; gemma scales by (1 + w)."""
    xf = x.to(torch.float32)
    if kind == "rmsnorm":
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + eps)
        w = (1.0 + p.scale) if rms_offset else p.scale
        return (y * w).to(x.dtype)
    mean = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * p.scale + p.bias).to(x.dtype)


def linear_init(in_dim: int, out_dim: int, cfg, quant=qlinear.DENSE, *,
                generator: torch.Generator, device=None, scale=None
                ) -> qlinear.QLinear:
    return qlinear.QLinear(qlinear.init(
        in_dim, out_dim, quant, generator=generator, device=device,
        dtype=getattr(torch, cfg.param_dtype), init_scale=scale))


def linear_apply(p, x, quant=qlinear.DENSE, *, in_dim=None, tag=None,
                 act="none", bias=None, residual=None, out_dtype=None,
                 local: bool = False, x_axis: str | None = None,
                 seq: str | None = None) -> torch.Tensor:
    """``act``/``bias``/``residual``/``out_dtype`` describe the tail
    ``y = act(Wx + bias) + residual`` (cast to ``out_dtype``); it becomes an
    Epilogue that the msGeMM kernel fuses into its final write.  ``tag``
    names the linear for the calibration observer (core.linear.apply).
    Under an active mesh the plan shards the linear by the logical axes
    ``runtime.serve.shard_params`` recorded on it (``QLinear.axes``; a
    linear it left whole, an expert stack among them, runs whole).  On a
    mesh ``local`` keeps a column-parallel output as this rank's block,
    and ``x_axis`` says ``x`` is this rank's block of k over that axis;
    ``seq`` returns this rank's block of the output's positions (dim 1)
    over that axis, ``residual`` being that block (``dispatch.execute``:
    a row-parallel linear's partial sums reduce-scattered over them)."""
    ep = None
    if act != "none" or bias is not None or residual is not None \
            or out_dtype is not None:
        ep = Epilogue(act=act, bias=bias is not None,
                      residual=residual is not None, out_dtype=out_dtype)
    return qlinear.apply(p, x, quant, in_dim=in_dim, tag=tag, epilogue=ep,
                         bias=bias, residual=residual,
                         shard_axes=getattr(p, "axes", None),
                         keep_local=local, x_axis=x_axis, seq_axis=seq)


def out_rows(p) -> int:
    """A linear's whole output dim: ``out_dim`` where its leaves are this
    rank's shard, else its leaves' rows."""
    if p.out_dim is not None:
        return p.out_dim
    lead = p.w if hasattr(p, "w") else p.scales
    return lead.shape[-2]


def col_sharded(p) -> bool:
    """Whether a linear's leaves hold this rank's block of its output
    rows (``runtime.serve.shard_params`` cut it column-parallel)."""
    lead = p.w if hasattr(p, "w") else p.scales
    return p.out_dim is not None and lead.shape[-2] < p.out_dim


def activation(name: str):
    """The activation function ``name`` (gelu, silu, relu); gelu is the
    tanh approximation, as the reference's ``jax.nn.gelu``."""
    if name not in ("gelu", "silu", "relu"):
        raise KeyError(name)
    return act_fn(name)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """gemma2 logit soft-capping: cap * tanh(x / cap)."""
    return cap * torch.tanh(x / cap) if cap else x


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (tuple, list)):
        for t in tree:
            yield from _tensors(t)


def needs_grad(*args) -> bool:
    """Whether a backward pass can reach ``args``: grad mode is on and a
    tensor among them (tuples searched) requires grad."""
    return torch.is_grad_enabled() and any(
        t.requires_grad for t in _tensors(args))


def _dots_policy(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy

    return (CheckpointPolicy.MUST_SAVE
            if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _dots_context():
    from torch.utils.checkpoint import create_selective_checkpoint_contexts

    return create_selective_checkpoint_contexts(_dots_policy)


def remat(fn, *args, policy: str = "nothing"):
    """``fn(*args)`` with its activations recomputed in the backward pass
    (``torch.utils.checkpoint``, non-reentrant), as the reference's
    ``jax.checkpoint``.  ``policy`` 'nothing' saves only the inputs;
    'dots' also saves the outputs of the 2-D matmuls (the reference's
    ``dots_with_no_batch_dims_saveable``: the linears, not the batched
    attention einsums).  The recompute runs with
    ``core.linear.replaying()`` set, so the forward's side effects (the
    calibration observer, MoE route counts) happen once."""
    from torch.utils.checkpoint import checkpoint

    if policy not in ("nothing", "dots"):
        raise ValueError(f"remat policy {policy!r}: 'nothing' or 'dots'")
    calls = [0]

    def once(*a):
        calls[0] += 1
        prev = qlinear.set_replaying(calls[0] > 1 or qlinear.replaying())
        try:
            return fn(*a)
        finally:
            qlinear.set_replaying(prev)

    kw = {"context_fn": _dots_context} if policy == "dots" else {}
    return checkpoint(once, *args, use_reentrant=False, **kw)


def local_linear(w: torch.Tensor, x: torch.Tensor, *, tag=None,
                 act: str = "none") -> torch.Tensor:
    """``act(x @ w.T)`` for this rank's dense weight block ``w`` (out,
    in), as a plain product whatever mesh is active (the training
    mesh's tensor-parallel linears; ``tag`` still reaches the calibration
    observer)."""
    ep = Epilogue(act=act) if act != "none" else None
    return qlinear.apply({"w": w}, x, qlinear.DENSE, in_dim=w.shape[-1],
                         tag=tag, epilogue=ep)


def whole_rows(w: torch.Tensor, rows: int, dim: int, axis: str, *,
               partial: bool) -> torch.Tensor:
    """``w`` whole along ``dim`` (``rows`` long) in a training step on a
    mesh: as it is when it is whole, else gathered over ``axis``.
    ``partial``: the consumers on this rank use part of it (their
    gradients sum over the ranks: a reduce-scatter back); otherwise they
    run replicated (this rank's block of the whole gradient, which every
    rank holds: summing it again would count it once a rank).  A whole
    weight with ``partial`` consumers enters through ``ad_identity``, so
    its gradient sums the ranks' parts too."""
    if w.shape[dim] != rows:
        return coll.ad_all_gather(w, axis, dim=dim, reduce_grad=partial)
    return coll.ad_identity(w, axis) if partial else w


def add_residual(y: torch.Tensor, residual: torch.Tensor) -> torch.Tensor:
    """``y + residual`` as the fused residual epilogue computes it (f32,
    cast back)."""
    return apply_epilogue(y, Epilogue(residual=True), residual=residual)


def seq_gather(x: torch.Tensor, axis: str | None, *,
               partial: bool = False) -> torch.Tensor:
    """A block's input whole over its positions (dim 1), from this rank's
    block of the residual over ``axis`` (``sharding.residual_axis``;
    None: ``x`` is whole), counted as ``collectives.SEQ_IN``.  In a
    training step its backward reduce-scatters the cotangent where
    ``partial`` (this rank's consumers each make a part of the whole
    input's gradient: its heads, channels or hidden block), or else
    takes this rank's block of it (they ran replicated)."""
    if axis is None:
        return x
    return coll.ad_all_gather(x, axis, dim=1, reduce_grad=partial,
                              kind=coll.SEQ_IN)


def seq_scatter(y: torch.Tensor, axis: str | None, *,
                partial: bool) -> torch.Tensor:
    """A block's output back on this rank's block of the positions over
    ``axis`` (None: ``y`` as it is): ``partial`` sums of a row-parallel
    region reduce-scattered (``collectives.SEQ_OUT``; its backward
    all-gathers), or this rank's block of a ``y`` every rank computed
    whole (its backward all-gathers the cotangent)."""
    if axis is None:
        return y
    if partial:
        return coll.ad_psum_scatter(y, axis, dim=1, kind=coll.SEQ_OUT)
    return coll.ad_block(y, axis, dim=1)


def norm_block(p: Norm, x: torch.Tensor, kind: str, axis: str | None, *,
               rms_offset: bool = False) -> torch.Tensor:
    """:func:`norm_apply` of this rank's block of the positions over
    ``axis``: the scale (and bias), whole on every rank, enter through
    ``collectives.ad_identity`` when a backward pass can reach them, so
    their gradient sums the ranks' positions."""
    if axis is not None and needs_grad(p.scale):
        bias = getattr(p, "bias", None)
        p = Norm(coll.ad_identity(p.scale, axis),
                 None if bias is None else coll.ad_identity(bias, axis))
    return norm_apply(p, x, kind, rms_offset=rms_offset)


def chunked_scan(step, carry, xs: tuple, *, chunk: int):
    """Run ``carry, y = step(carry, x_t)`` over the leading (time) axis T of
    the tensors ``xs``; returns (carry, ys stacked on a leading T axis).
    T is a multiple of ``chunk`` when ``chunk < T``.  As the reference's
    two-level ``lax.scan``, with a backward pass to come
    (:func:`needs_grad`) each chunk of steps is rematerialized: the carry
    is saved once a chunk, not once a step, and the chunk's steps are
    recomputed in the backward pass.  Values do not change."""
    T = xs[0].shape[0]
    if chunk < T and T % chunk:
        raise ValueError(f"T={T} is not a multiple of chunk={chunk}")

    def run(carry, *xc):
        ys = []
        for t in range(xc[0].shape[0]):
            carry, y = step(carry, tuple(x[t] for x in xc))
            ys.append(y)
        return carry, torch.stack(ys)

    if not (chunk < T and needs_grad(carry, xs)):
        return run(carry, *xs)
    ys = []
    for s in range(0, T, chunk):
        carry, y = remat(run, carry, *(x[s:s + chunk] for x in xs))
        ys.append(y)
    return carry, torch.cat(ys)


class MLP(nn.Module):
    """up / down (+ gate for GeGLU/SwiGLU) linears."""

    def __init__(self, up, down, gate=None):
        super().__init__()
        self.up, self.down = up, down
        if gate is not None:
            self.gate = gate


def mlp_init(cfg, d_ff: int, quant=None, *, generator: torch.Generator,
             device=None) -> MLP:
    q = quant if quant is not None else cfg.quant
    d = cfg.d_model
    kw = dict(generator=generator, device=device)
    up = linear_init(d, d_ff, cfg, q, **kw)
    down = linear_init(d_ff, d, cfg, q, **kw)
    gate = (linear_init(d, d_ff, cfg, q, **kw)
            if cfg.mlp_activation in ("swiglu", "geglu") else None)
    return MLP(up, down, gate)


def mlp_apply(p: MLP, x: torch.Tensor, cfg, quant=None, *,
              residual=None, seq: str | None = None,
              gathered: bool = False) -> torch.Tensor:
    """MLP with the element-wise tail folded into the linears' epilogues:
    the (gate's) activation into its projection, ``residual`` (the block
    input) into the down projection.  On a mesh whose ranks hold blocks
    of the hidden dim (:func:`col_sharded`), up and gate return this
    rank's block and ``down`` takes it as its k slice (row-parallel, or
    gathered whole where its packed storage cannot split there).
    ``seq``: the residual's positions lie over that axis; ``x`` (unless
    ``gathered``: whole already) and ``residual`` are this rank's block,
    ``x`` is gathered whole and the output comes back as the block
    (``down``'s partial sums reduce-scattered over the positions)."""
    q = quant if quant is not None else cfg.quant
    act_name = {"swiglu": "silu", "geglu": "gelu",
                "gelu": "gelu"}[cfg.mlp_activation]
    if not gathered:
        x = seq_gather(x, seq)
    local = col_sharded(p.up)
    kw = dict(in_dim=cfg.d_model, local=local)
    if hasattr(p, "gate"):
        up = linear_apply(p.up, x, q, tag="up", **kw)
        gate = linear_apply(p.gate, x, q, tag="gate", act=act_name, **kw)
        h = gate * up
    else:
        h = linear_apply(p.up, x, q, tag="up", act=act_name, **kw)
    return linear_apply(p.down, h, q, in_dim=out_rows(p.up), tag="down",
                        residual=residual,
                        x_axis=sharding.TP_AXIS if local else None, seq=seq)


def mlp_apply_tp(p: MLP, x: torch.Tensor, cfg, *, residual, d_ff: int,
                 axis: str = "model", seq: str | None = None,
                 gathered: bool = False) -> torch.Tensor:
    """:func:`mlp_apply` of a training step on a mesh, on this rank's
    weights (gathered over 'data').  When they hold a block of the
    hidden dim (``d_ff`` split over ``axis``), up and gate are
    column-parallel and their product stays sharded into a row-parallel
    ``down`` that ends in a psum; ``x`` enters through
    ``collectives.ad_identity``, whose backward sums the ranks' parts of
    its gradient.  Otherwise every rank runs the whole MLP.  ``residual``
    None: the MLP's output alone (a MoE block's shared experts).

    ``seq``: the residual's positions lie over that axis, and ``x``
    (unless ``gathered``: whole already, every rank holding its whole
    gradient) and ``residual`` are this rank's block.  ``x`` is gathered
    whole at entry (:func:`seq_gather`, whose backward reduce-scatters
    where the hidden splits), and ``down``'s partials end in a
    reduce-scatter over the positions instead of the psum; a whole MLP's
    output is cut to the block (:func:`seq_scatter`)."""
    act_name = {"swiglu": "silu", "geglu": "gelu",
                "gelu": "gelu"}[cfg.mlp_activation]
    tp = p.up.w.shape[0] != d_ff
    if seq is not None and not gathered:
        x = seq_gather(x, seq, partial=tp)
    elif tp:
        x = coll.ad_identity(x, axis)
    if hasattr(p, "gate"):
        h = local_linear(p.gate.w, x, tag="gate", act=act_name) \
            * local_linear(p.up.w, x, tag="up")
    else:
        h = local_linear(p.up.w, x, tag="up", act=act_name)
    y = local_linear(p.down.w, h, tag="down")
    if seq is not None:
        y = seq_scatter(y, seq, partial=tp)
    elif tp:
        y = coll.ad_psum(y, axis)
    return y if residual is None else add_residual(y, residual)
