"""Model-level weight quantization; port of repro.quant.quantize.

Walks a model and converts every :class:`~repro_torch.core.linear.QLinear`
whose attribute name is in ``QUANTIZABLE`` from its dense ``w`` to the
target int4 format, in place and on the weights' own device.  Layers are
converted one at a time and each dense weight is dropped as soon as its
quantized leaves exist, so a caller that initializes and quantizes block
by block (``models.transformer.init_params(..., quant=...)``) never holds
more than one block's dense weights.  Norms and embeddings stay floating
point: msGeMM targets GeMMs (paper §2).
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.core import linear as qlinear
from repro_torch.core.spec import QuantSpec

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
        mod.load(qlinear.from_dense(w, quant, codebook=cb))
        del w
    return model


def quantized_size_bytes(model: nn.Module) -> int:
    return sum(t.numel() * t.element_size() for t in model.buffers())
