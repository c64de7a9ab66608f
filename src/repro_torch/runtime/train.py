"""The training step: loss, gradients, AdamW — with microbatched gradient
accumulation and remat (in the model's block groups); port of
repro.runtime.train.

The train state is a dict ``{"params": <the port's Transformer>, "opt":
{"m", "v", "count"}, "step"}``.  The trainable leaves are the model's
float buffers (:func:`trainable`): exactly the leaves of the reference's
param tree, one per layer where the reference stacks them (``convert.
port_path`` maps one onto the other).  ``m`` and ``v`` are flat dicts
under the same names; ``count`` and ``step`` are 0-d int32 tensors.  A
step takes the gradients with ``torch.autograd.grad`` over those leaves
and updates them, and the moments, in place.  Quantized models cannot be
trained (the reference cannot differentiate its integer leaves either):
:func:`init_state` and :func:`train_step` refuse them.

On a mesh (``init_state(..., mesh=)`` or ``distributed.sharding.
shard_state``; one process a mesh device, ``launch.mesh.run_ranks``)
each rank holds its block of every leaf and moment (FSDP x TP under
``cfg.logical_rules``), ``state["mesh"]`` and ``state["specs"]``, and
its rows of the global batch (``SyntheticStream.device_batch(...,
mesh=)``).  A step computes what the single-device step computes on the
whole batch: the cross-entropy and z-loss divide by the global count of
labels (a psum over 'pod' x 'data'), the log-partition of logits split
over the vocab takes a pmax and a psum over 'model'; each rank
differentiates its share of the loss; the FSDP gathers' backward
reduce-scatters over 'data', leaves whole over 'data' are psummed over
it, and the mean over 'pod' goes through ``optim.compression`` with
``grad_compression="int8_pod"`` (its error-feedback residual in
``state["opt"]["residual"]``).  The clip's norm counts every element
once (``optim.adamw.global_norm``).  A MoE block's ``load_balance`` is
the product of the whole batch's means, each rank handing the loss its
share (``moe.moe_apply_tp``), and ``dropped_frac`` the whole batch's
share, so both equal the single device's.  Every model family trains so;
a mesh that cannot split a layout is refused
(``transformer.check_train_mesh``); on a 1x1 mesh, or none, the step is
the single-device one.  With ``microbatches`` A, a rank's microbatch i
is its share of the single device's microbatch i when its rows are
placed so (``SyntheticStream.device_batch(..., microbatches=A)``).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field

import torch

from repro_torch.data.pipeline import IGNORE
from repro_torch.device import resolve
from repro_torch.distributed import collectives as coll
from repro_torch.distributed import compat, sharding
from repro_torch.launch.mesh import mesh_devices
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim.compression import compressed_pmean_tree

GRAD_COMPRESSION = ("none", "int8_pod")


@dataclass(frozen=True)
class TrainConfig:
    optimizer: AdamWConfig = field(default_factory=AdamWConfig)
    microbatches: int = 1  # gradient accumulation steps per train step
    grad_accum_dtype: str = "float32"  # bfloat16 halves the grad buffer
    z_loss: float = 1e-4
    router_aux_weight: float = 0.01
    # the gradient mean over 'pod' in int8 with error feedback
    # (optim.compression): every reduction of the port's mesh step is
    # explicit, so it applies wherever the mesh's 'pod' axis is above 1
    grad_compression: str = "none"  # none | int8_pod

    def __post_init__(self):
        if self.grad_compression not in GRAD_COMPRESSION:
            raise ValueError(f"grad_compression={self.grad_compression!r}: "
                             f"one of {GRAD_COMPRESSION}")


def _psum_axes(t: torch.Tensor, axes, mesh) -> torch.Tensor:
    for a in axes:
        t = coll.psum(t, a, mesh=mesh)
    return t


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, *,
                  mesh=None, vocab_axis: str | None = None):
    """Masked CE with z-loss.  logits (B, S, V) f32, labels (B, S) int.
    Returns (mean nll, mean squared log-partition) over unmasked labels.
    On ``mesh`` (this rank's rows): this rank's shares of the global
    means, whose sum over 'pod' x 'data' they are, each divided by the
    global count of labels; ``vocab_axis``: the logits hold this rank's
    block of the vocab along it."""
    mask = (labels != IGNORE).to(torch.float32)
    labels_safe = torch.where(labels == IGNORE, 0, labels).long()
    if vocab_axis is None:
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, labels_safe[..., None])[..., 0]
    else:
        top = coll.pmax(logits.detach().amax(dim=-1), vocab_axis, mesh=mesh)
        lse = top + torch.log(coll.ad_psum(
            torch.exp(logits - top[..., None]).sum(dim=-1), vocab_axis,
            mesh=mesh))
        rows = logits.shape[-1]
        local = labels_safe - sharding.coord(mesh, vocab_axis) * rows
        mine = (local >= 0) & (local < rows)
        ll = torch.gather(logits, -1,
                          torch.where(mine, local, 0)[..., None])[..., 0]
        ll = coll.ad_psum(torch.where(mine, ll, 0.0), vocab_axis, mesh=mesh)
    nll = (lse - ll) * mask
    count = mask.sum()
    if mesh is not None:
        count = _psum_axes(count, sharding.batch_axes(mesh), mesh)
    denom = count.clamp_min(1.0)
    zl = (lse.square() * mask).sum() / denom
    return nll.sum() / denom, zl


def trainable(model: torch.nn.Module) -> dict[str, torch.Tensor]:
    """The model's trainable leaves by module path: its float buffers, the
    leaves of the reference's param tree (a MoE block's ``route_counts``
    is an attribute, not a buffer).  ValueError for a model with
    quantized (integer, scale or codebook) leaves."""
    leaves = dict(model.named_buffers())
    quantized = [n for n, b in leaves.items()
                 if n.rsplit(".", 1)[-1] in ("idx", "u8", "scales", "codebook")
                 or not b.is_floating_point()]
    if quantized:
        raise ValueError(
            f"cannot train a quantized model ({len(quantized)} quantized "
            f"leaves, e.g. {quantized[0]!r}): train dense weights, then "
            "quantize them (quant.quantize_model)")
    return leaves


def loss_fn(model, cfg: ModelConfig, tcfg: TrainConfig, batch: dict, *,
            mesh=None):
    """(loss, metrics): the masked CE plus ``z_loss`` times the mean
    squared log-partition, plus for a MoE config ``router_aux_weight``
    times the summed ``load_balance`` over (MoE blocks in the pattern x
    groups); metrics ``ce``, ``z_loss``, ``load_balance``,
    ``dropped_frac``.  On ``mesh`` (its context active), this rank's
    shares of them (:func:`cross_entropy`, ``moe.moe_apply_tp``)."""
    logits, aux = transformer.forward(model, cfg, batch, return_aux=True)
    split = mesh is not None and logits.shape[-1] != cfg.vocab_size
    ce, zl = cross_entropy(logits, batch["labels"], mesh=mesh,
                           vocab_axis="model" if split else None)
    loss = ce + tcfg.z_loss * zl
    if cfg.num_experts:
        loss = loss + tcfg.router_aux_weight * aux["load_balance"] / max(
            sum(k in ("moe", "mamba_moe") for k in cfg.block_pattern)
            * cfg.num_groups, 1)
    return loss, {"ce": ce, "z_loss": zl, **aux}


def _value_and_grad(model, names, leaves, cfg, tcfg, batch, mesh=None):
    loss, metrics = loss_fn(model, cfg, tcfg, batch, mesh=mesh)
    # on a mesh each pod differentiates its pods-many-fold share, so the
    # mean over 'pod' of the pods' gradients is the gradient
    pods = compat.axes_of(mesh).get("pod", 1) if mesh is not None else 1
    grads = torch.autograd.grad(loss * pods if pods > 1 else loss, leaves,
                                allow_unused=True)
    # a leaf the loss does not reach gets a zero gradient, as in JAX
    grads = [torch.zeros_like(t) if g is None else g
             for g, t in zip(grads, leaves)]
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            dict(zip(names, grads)))


def _grads(model, names: list[str], cfg, tcfg, batch, *, mesh=None,
           specs=None):
    """(loss, metrics, grads by name) of ``batch``; with ``microbatches``
    A > 1, the batch is cut into A along its first axis and loss/A,
    metrics/A and grads/A (cast to ``grad_accum_dtype``) are summed from
    zeros, in the reference's order.  On ``mesh`` (``specs`` the leaves'),
    of this rank's rows: loss and metrics global, and this rank's block
    of its pod's gradients, which :func:`_pod_mean` averages over 'pod'
    (on a mesh without 'pod', the gradients)."""
    if mesh is None:
        return _grads_local(model, names, cfg, tcfg, batch)
    with sharding.use(mesh, cfg.logical_rules):
        loss, metrics, grads = _grads_local(model, names, cfg, tcfg, batch,
                                            mesh)
        axes = sharding.batch_axes(mesh)
        keys = list(metrics)
        total = _psum_axes(torch.stack([loss] + [metrics[k] for k in keys]),
                           axes, mesh)
        loss, metrics = total[0], dict(zip(keys, total[1:]))
        if "data" in axes:  # leaves whole over 'data': each rank's rows
            grads = {n: g if coll.spec_dim(specs[n], "data") is not None
                     else coll.psum(g, "data", mesh=mesh)
                     for n, g in grads.items()}
    return loss, metrics, grads


def _pod_mean(grads: dict, mesh, tcfg: TrainConfig, residual=None):
    """(the mean over 'pod' of the pods' gradients, the new residual):
    a psum over 'pod' divided by its size, or with ``int8_pod`` the
    compressed error-feedback mean (``residual`` the state's)."""
    pods = compat.axes_of(mesh).get("pod", 1)
    if pods == 1:
        return grads, residual
    if tcfg.grad_compression == "int8_pod":
        return compressed_pmean_tree(grads, "pod", residual, mesh=mesh)
    return {n: coll.psum(g, "pod", mesh=mesh) / pods
            for n, g in grads.items()}, residual


def _grads_local(model, names, cfg, tcfg, batch, mesh=None):
    bufs = dict(model.named_buffers())
    leaves = [bufs[n] for n in names]
    for t in leaves:
        t.requires_grad_(True)
    try:
        if tcfg.microbatches == 1:
            return _value_and_grad(model, names, leaves, cfg, tcfg, batch,
                                   mesh)
        A = tcfg.microbatches
        adt = getattr(torch, tcfg.grad_accum_dtype)
        dev = leaves[0].device
        acc_loss = torch.zeros((), dtype=torch.float32, device=dev)
        acc_metrics = {k: torch.zeros((), dtype=torch.float32, device=dev)
                       for k in ("ce", "z_loss", "load_balance",
                                 "dropped_frac")}
        acc_grads = {n: torch.zeros(t.shape, dtype=adt, device=dev)
                     for n, t in zip(names, leaves)}
        for i in range(A):
            mb = {k: v.reshape(A, v.shape[0] // A, *v.shape[1:])[i]
                  for k, v in batch.items()}
            loss, metrics, grads = _value_and_grad(model, names, leaves, cfg,
                                                   tcfg, mb, mesh)
            acc_loss = acc_loss + loss / A
            acc_metrics = {k: a + metrics[k] / A
                           for k, a in acc_metrics.items()}
            acc_grads = {n: a + (grads[n] / A).to(adt)
                         for n, a in acc_grads.items()}
            del grads
        return acc_loss, acc_metrics, acc_grads
    finally:
        for t in leaves:
            t.requires_grad_(False)


def train_mesh(mesh, cfg: ModelConfig):
    """``mesh`` when it spans more than one device (NotImplementedError
    where ``cfg`` cannot train on it, ``transformer.check_train_mesh``),
    None for none or a 1x1 mesh."""
    if mesh is None or mesh_devices(mesh) == 1:
        return None
    transformer.check_train_mesh(cfg, mesh)
    return mesh


def init_state(cfg: ModelConfig, tcfg: TrainConfig | None = None, *,
               generator: torch.Generator, device=None, mesh=None) -> dict:
    """A model from ``generator`` (``transformer.init_params``), zero
    moments in the optimizer's ``state_dtype`` and step 0.  On ``mesh``,
    this rank's blocks (the whole model is drawn, then cut, so every
    mesh starts from the single-device weights)."""
    if cfg.quant.mode != "bf16":
        raise ValueError(f"cannot train a quantized model "
                         f"(quant.mode={cfg.quant.mode!r}): train dense "
                         "weights, then quantize them")
    mesh = train_mesh(mesh, cfg)
    dev = resolve(device)
    model = transformer.init_params(cfg, generator=generator, device=dev)
    if mesh is None:
        return state_for(model, tcfg)
    specs = sharding.shard_model(model, mesh, cfg.logical_rules)
    return dict(state_for(model, tcfg), mesh=mesh, specs=specs)


def state_for(model, tcfg: TrainConfig | None = None) -> dict:
    """The train state of an existing dense ``model``: zero moments under
    the names of :func:`trainable`, count and step 0; with ``int8_pod``
    also a zero f32 ``residual`` a leaf."""
    leaves = trainable(model)
    ocfg = tcfg.optimizer if tcfg is not None else None
    dev = next(iter(leaves.values())).device
    opt = adamw_init(leaves, ocfg)
    if tcfg is not None and tcfg.grad_compression == "int8_pod":
        opt["residual"] = {n: torch.zeros_like(t, dtype=torch.float32)
                           for n, t in leaves.items()}
    return {"params": model, "opt": opt,
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def train_step(state: dict, batch: dict, cfg: ModelConfig,
               tcfg: TrainConfig) -> tuple[dict, dict]:
    """One optimizer step on ``batch`` (tensors on the model's device;
    on a mesh, this rank's rows).  Updates the params and moments in
    place and returns (state, metrics): ``loss``, ``ce``, ``z_loss``,
    ``load_balance``, ``dropped_frac``, ``grad_norm``, ``lr``, each a 0-d
    tensor (no host sync), the whole batch's on every rank."""
    if cfg.quant.mode != "bf16":
        raise ValueError(f"cannot train a quantized model "
                         f"(quant.mode={cfg.quant.mode!r})")
    model = state["params"]
    names = list(state["opt"]["m"])
    mesh, specs = state.get("mesh"), state.get("specs")
    loss, metrics, grads = _grads(model, names, cfg, tcfg, batch, mesh=mesh,
                                  specs=specs)
    if mesh is not None:
        grads, residual = _pod_mean(grads, mesh, tcfg,
                                    state["opt"].get("residual"))
        if residual is not None:
            state["opt"]["residual"] = residual
    bufs = dict(model.named_buffers())
    _, opt, om = adamw_update(grads, state["opt"],
                              {n: bufs[n] for n in names}, tcfg.optimizer,
                              specs=specs, mesh=mesh)
    del grads
    state["opt"] = {**state["opt"], **opt}
    state["step"] = state["step"] + 1
    return state, {"loss": loss, **metrics, **om}


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig):
    return functools.partial(train_step, cfg=cfg, tcfg=tcfg)
