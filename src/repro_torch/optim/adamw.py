"""AdamW with global-norm clipping; port of repro.optim.adamw.

Params, gradients and the moments are flat dicts ``{name: tensor}`` with
the same keys (the train step's are the model's trainable buffers, one
leaf a layer).  The update is the reference's op order, computed in f32:

    g = g * min(1, clip / (|g| + 1e-9))
    m = b1·m + (1 - b1)·g          v = b2·v + (1 - b2)·g²
    step = (m / (1 - b1^count)) / (sqrt(v / (1 - b2^count)) + eps)
    step += wd·p                    (when ``weight_decay`` is set)
    p = p - lr·step

``torch.optim.AdamW`` is another order (it decays ``p`` first and adds
``eps`` to ``sqrt(v)/sqrt(1 - b2^count)``), so it is not used.  ``m`` and
``v`` are stored in ``state_dtype``, each param in its own dtype; integer
leaves are frozen.  Weight decay applies to every float leaf, norms and
embedding included, as in the reference.  The reference processes leaves
above 2^24 elements slice by slice (``_scannable``) only to bound XLA's
temporaries; here every leaf is one layer's already, and per-element
results are the same.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import torch

from repro_torch.optim import schedules


@dataclass(frozen=True)
class AdamWConfig:
    lr: Callable = field(default_factory=lambda: schedules.constant(1e-3))
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float = 1.0
    state_dtype: str = "float32"  # 'bfloat16' halves m/v bytes


def adamw_init(params: dict, cfg: AdamWConfig | None = None) -> dict:
    """Zero moments in ``cfg.state_dtype`` (f32 without a config) and a
    0-d int32 ``count`` on the params' device."""
    dt = getattr(torch, cfg.state_dtype) if cfg is not None else torch.float32
    dev = next(iter(params.values())).device if params else None
    return {"m": {k: torch.zeros_like(p, dtype=dt) for k, p in params.items()},
            "v": {k: torch.zeros_like(p, dtype=dt) for k, p in params.items()},
            "count": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree: dict, *, specs: dict | None = None,
                mesh=None) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's f32 sum of squares.  On
    ``mesh`` the leaves are this rank's blocks under ``specs``: each
    leaf's squares are summed once across the mesh, by a psum over
    exactly the axes that split it (a leaf whole on an axis is counted
    once, not once a rank)."""
    sq = {n: torch.sum(torch.square(g.to(torch.float32)))
          for n, g in tree.items()}
    if mesh is None:
        return torch.sqrt(torch.sum(torch.stack(list(sq.values()))))
    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed import compat

    sizes = compat.axes_of(mesh)
    groups: dict[tuple, list] = {}
    for n, v in sq.items():
        axes = tuple(a for a in sizes if sizes[a] > 1
                     and coll.spec_dim(specs[n], a) is not None)
        groups.setdefault(axes, []).append(v)
    total = []
    for axes, vs in groups.items():
        t = torch.sum(torch.stack(vs))
        for a in axes:
            t = coll.psum(t, a, mesh=mesh)
        total.append(t)
    return torch.sqrt(torch.sum(torch.stack(total)))


@torch.no_grad()
def adamw_update(grads: dict, state: dict, params: dict, cfg: AdamWConfig,
                 *, specs: dict | None = None, mesh=None):
    """One step.  Writes the new params and moments into ``params`` and
    ``state``'s tensors in place; returns (params, new state dict (its
    ``count`` incremented), {"grad_norm", "lr"}), as the reference's
    (new_params, new_state, metrics).  On ``mesh`` every leaf is this
    rank's block under ``specs``, and the clip's norm the whole tree's
    (:func:`global_norm`)."""
    count = state["count"] + 1
    gnorm = global_norm(grads, specs=specs, mesh=mesh)
    scale = (torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
             if cfg.grad_clip else None)
    lr = cfg.lr(count)
    cf = count.to(torch.float32)
    bc1 = 1 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32,
                                     device=cf.device), cf)
    bc2 = 1 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32,
                                     device=cf.device), cf)
    for name, p in params.items():
        if not p.is_floating_point():
            continue  # frozen integer (quantized) leaves
        m, v = state["m"][name], state["v"][name]
        g = grads[name].to(torch.float32)
        if scale is not None:
            g = g * scale
        m32 = cfg.b1 * m.to(torch.float32) + (1 - cfg.b1) * g
        v32 = cfg.b2 * v.to(torch.float32) + (1 - cfg.b2) * g * g
        del g
        step = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps)
        m.copy_(m32)
        v.copy_(v32)
        del m32, v32
        if cfg.weight_decay:
            step = step + cfg.weight_decay * p.to(torch.float32)
        p.copy_(p.to(torch.float32) - lr * step)
    return params, {"m": state["m"], "v": state["v"], "count": count}, \
        {"grad_norm": gnorm, "lr": lr}
