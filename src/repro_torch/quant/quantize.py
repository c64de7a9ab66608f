"""Model-level weight quantization; port of repro.quant.quantize.

Walks a model and converts every :class:`~repro_torch.core.linear.QLinear`
whose attribute name is in ``QUANTIZABLE`` from its dense ``w`` to the
target int4 format, in place and on the weights' own device.  Layers are
converted one at a time and each dense weight is dropped as soon as its
quantized leaves exist, so a caller that initializes and quantizes block
by block (``models.transformer.init_params(..., quant=...)``) never holds
more than one block's dense weights.  Norms, embeddings and the MoE
router stay floating point: msGeMM targets GeMMs (paper §2).

A stacked weight ``w`` (E, out, in), a MoE block's experts, is converted
expert by expert under ``core.spec.expert_spec``: int4 codes two a byte
in every quantized mode (the reference keeps msgemm-mode experts as LUT
indices and runs them int4; the codes and scales are the same).
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.core import linear as qlinear
from repro_torch.core.spec import QuantSpec, expert_spec

QUANTIZABLE = {
    "wq", "wk", "wv", "wo", "up", "gate", "down", "lm_head",
    "in_proj", "x_proj", "out_proj",
    "xl_up", "xl_o", "xl_down",
}


def _codebook_for(codebooks, path: str):
    if codebooks is None:
        return None
    if isinstance(codebooks, dict):
        cb = codebooks.get(path)
        return None if cb is None else torch.as_tensor(cb)
    return torch.as_tensor(codebooks)  # one table shared by every leaf


def quantize_model(model: nn.Module, quant: QuantSpec, *, codebooks=None
                   ) -> nn.Module:
    """Quantize ``model``'s linears in place for ``quant`` serving and
    return it.  ``codebooks``: one (16,) table for every leaf, or a dict
    from the leaf's module path ('blocks.0.attn.wq') to its table."""
    if quant.mode == "bf16":
        return model
    for path, mod in list(model.named_modules()):
        leaf = path.rsplit(".", 1)[-1]
        if not (isinstance(mod, qlinear.QLinear) and leaf in QUANTIZABLE
                and "w" in mod.params()):
            continue
        w = mod.params()["w"]
        cb = _codebook_for(codebooks, path)
        if cb is not None:
            cb = cb.to(w.device)
        mod.load(convert_dense(w, quant, codebook=cb))
        del w
    return model


def convert_dense(w: torch.Tensor, quant: QuantSpec, *, codebook=None
                  ) -> dict:
    """One linear's quantized leaves from its dense ``w``: (out, in), or
    an expert stack (E, out, in) converted one expert at a time
    (:func:`stack_experts`; ``codebook``: one (16,) table, or (E, 16)
    tables, one an expert)."""
    if w.dim() == 2:
        return qlinear.from_dense(w, quant, codebook=codebook)
    return stack_experts(w.shape[0], lambda e: w[e], quant,
                         codebook=codebook)


def stack_experts(num_experts: int, expert, quant: QuantSpec, *,
                  dtype=torch.float32, codebook=None) -> dict:
    """The stacked leaves (E, ...) of an expert stack under
    ``expert_spec(quant)``: ``expert(e)`` gives expert e's dense (out, in)
    weight, which is converted right away and written into leaves
    allocated once, so no more than one expert's dense weight exists at a
    time.  ``codebook``: one (16,) table, or (E, 16) tables, one an
    expert."""
    spec = expert_spec(quant)
    stacked = None
    for e in range(num_experts):
        cb = (codebook[e] if codebook is not None and codebook.dim() == 2
              else codebook)
        part = qlinear.from_dense(expert(e), spec, dtype=dtype, codebook=cb)
        if stacked is None:
            stacked = {n: torch.empty((num_experts, *t.shape),
                                      dtype=t.dtype, device=t.device)
                       for n, t in part.items()}
        for n, t in part.items():
            stacked[n][e] = t
        del part
    return stacked


def quantized_size_bytes(model: nn.Module) -> int:
    return sum(t.numel() * t.element_size() for t in model.buffers())
