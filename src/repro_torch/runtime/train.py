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
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field

import torch

from repro_torch.data.pipeline import IGNORE
from repro_torch.device import resolve
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update

@dataclass(frozen=True)
class TrainConfig:
    optimizer: AdamWConfig = field(default_factory=AdamWConfig)
    microbatches: int = 1  # gradient accumulation steps per train step
    grad_accum_dtype: str = "float32"  # bfloat16 halves the grad buffer
    z_loss: float = 1e-4
    router_aux_weight: float = 0.01
    # int8 cross-pod gradient reduction comes with the multi-GPU slice
    grad_compression: str = "none"

    def __post_init__(self):
        if self.grad_compression != "none":
            raise NotImplementedError(
                f"grad_compression={self.grad_compression!r} needs the "
                "multi-GPU slice; only 'none' is ported")


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor):
    """Masked CE with z-loss.  logits (B, S, V) f32, labels (B, S) int.
    Returns (mean nll, mean squared log-partition) over unmasked labels."""
    mask = (labels != IGNORE).to(torch.float32)
    labels_safe = torch.where(labels == IGNORE, 0, labels).long()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels_safe[..., None])[..., 0]
    nll = (lse - ll) * mask
    denom = mask.sum().clamp_min(1.0)
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


def loss_fn(model, cfg: ModelConfig, tcfg: TrainConfig, batch: dict):
    """(loss, metrics): the masked CE plus ``z_loss`` times the mean
    squared log-partition, plus for a MoE config ``router_aux_weight``
    times the summed ``load_balance`` over (MoE blocks in the pattern x
    groups); metrics ``ce``, ``z_loss``, ``load_balance``,
    ``dropped_frac``."""
    logits, aux = transformer.forward(model, cfg, batch, return_aux=True)
    ce, zl = cross_entropy(logits, batch["labels"])
    loss = ce + tcfg.z_loss * zl
    if cfg.num_experts:
        loss = loss + tcfg.router_aux_weight * aux["load_balance"] / max(
            sum(k in ("moe", "mamba_moe") for k in cfg.block_pattern)
            * cfg.num_groups, 1)
    return loss, {"ce": ce, "z_loss": zl, **aux}


def _value_and_grad(model, names, leaves, cfg, tcfg, batch):
    loss, metrics = loss_fn(model, cfg, tcfg, batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    # a leaf the loss does not reach gets a zero gradient, as in JAX
    grads = [torch.zeros_like(t) if g is None else g
             for g, t in zip(grads, leaves)]
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            dict(zip(names, grads)))


def _grads(model, names: list[str], cfg, tcfg, batch):
    """(loss, metrics, grads by name) of ``batch``; with ``microbatches``
    A > 1, the batch is cut into A along its first axis and loss/A,
    metrics/A and grads/A (cast to ``grad_accum_dtype``) are summed from
    zeros, in the reference's order."""
    bufs = dict(model.named_buffers())
    leaves = [bufs[n] for n in names]
    for t in leaves:
        t.requires_grad_(True)
    try:
        if tcfg.microbatches == 1:
            return _value_and_grad(model, names, leaves, cfg, tcfg, batch)
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
                                                   tcfg, mb)
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


def init_state(cfg: ModelConfig, tcfg: TrainConfig | None = None, *,
               generator: torch.Generator, device=None) -> dict:
    """A dense model from ``generator`` (``transformer.init_params``), zero
    moments in the optimizer's ``state_dtype`` and step 0."""
    if cfg.quant.mode != "bf16":
        raise ValueError(f"cannot train a quantized model "
                         f"(quant.mode={cfg.quant.mode!r}): train dense "
                         "weights, then quantize them")
    dev = resolve(device)
    model = transformer.init_params(cfg, generator=generator, device=dev)
    return state_for(model, tcfg)


def state_for(model, tcfg: TrainConfig | None = None) -> dict:
    """The train state of an existing dense ``model``: zero moments under
    the names of :func:`trainable`, count and step 0."""
    leaves = trainable(model)
    ocfg = tcfg.optimizer if tcfg is not None else None
    dev = next(iter(leaves.values())).device
    return {"params": model, "opt": adamw_init(leaves, ocfg),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def train_step(state: dict, batch: dict, cfg: ModelConfig,
               tcfg: TrainConfig) -> tuple[dict, dict]:
    """One optimizer step on ``batch`` (tensors on the model's device).
    Updates the params and moments in place and returns (state, metrics):
    ``loss``, ``ce``, ``z_loss``, ``load_balance``, ``dropped_frac``,
    ``grad_norm``, ``lr``, each a 0-d tensor (no host sync)."""
    if cfg.quant.mode != "bf16":
        raise ValueError(f"cannot train a quantized model "
                         f"(quant.mode={cfg.quant.mode!r})")
    model = state["params"]
    names = list(state["opt"]["m"])
    loss, metrics, grads = _grads(model, names, cfg, tcfg, batch)
    bufs = dict(model.named_buffers())
    _, opt, om = adamw_update(grads, state["opt"],
                              {n: bufs[n] for n in names}, tcfg.optimizer)
    del grads
    state["opt"] = opt
    state["step"] = state["step"] + 1
    return state, {"loss": loss, **metrics, **om}


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig):
    return functools.partial(train_step, cfg=cfg, tcfg=tcfg)
