"""Epilogue — the element-wise tail fused into a quantized GeMM; port of
repro.core.epilogue.

The op order is fixed::

    y = act(acc + bias) + residual      # then cast to out_dtype

GELU is the tanh approximation (``jax.nn.gelu``'s default), not PyTorch's
exact-erf default.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

ACTIVATIONS = ("none", "relu", "gelu", "silu")


def act_fn(name: str):
    return {"none": lambda v: v, "relu": F.relu,
            "gelu": lambda v: F.gelu(v, approximate="tanh"),
            "silu": F.silu}[name]


def torch_dtype(name: str | None):
    """``'bfloat16'`` -> ``torch.bfloat16``; None stays None."""
    if name is None:
        return None
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype name {name!r}")
    return dt


@dataclass(frozen=True)
class Epilogue:
    """act: ``none | relu | gelu | silu``; bias: add a per-output-row (m,)
    vector before the activation; residual: add a tensor shaped like the
    output after it; out_dtype: output dtype name, None keeps the input's."""

    act: str = "none"
    bias: bool = False
    residual: bool = False
    out_dtype: str | None = None

    def __post_init__(self):
        if self.act not in ACTIVATIONS:
            raise ValueError(
                f"unknown epilogue activation {self.act!r}; "
                f"one of {ACTIVATIONS}")
        torch_dtype(self.out_dtype)  # eager validation

    @property
    def is_identity(self) -> bool:
        return (self.act == "none" and not self.bias and not self.residual
                and self.out_dtype is None)

    def act_fn(self):
        return act_fn(self.act)


def apply_epilogue(y: torch.Tensor, ep: Epilogue | None,
                   bias: torch.Tensor | None = None,
                   residual: torch.Tensor | None = None) -> torch.Tensor:
    """Unfused tail in the model's row-major (..., m) layout, computed at
    float32-or-better, then cast back (to ``ep.out_dtype`` if set)."""
    if ep is None or ep.is_identity:
        return y
    in_dtype = y.dtype
    compute = torch.promote_types(in_dtype, torch.float32)
    y = y.to(compute)
    if ep.bias:
        if bias is None:
            raise ValueError("Epilogue.bias set but no bias array given")
        y = y + bias.to(compute)
    y = ep.act_fn()(y)
    if ep.residual:
        if residual is None:
            raise ValueError(
                "Epilogue.residual set but no residual array given")
        y = y + residual.to(compute)
    return y.to(torch_dtype(ep.out_dtype) or in_dtype)
