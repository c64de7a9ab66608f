"""Weights from the JAX reference's param tree into the port's modules.

The bridge is numpy (and plain attributes for the config): the caller turns the reference's tree into numpy
leaves (``jax.tree.map(np.asarray, params)``) and hands it here, so the
port never imports JAX.  Blocks stacked ``(G, ...)`` along the scan axis
under ``blocks["{i}:{kind}"]`` become one module per layer (layer
``g * len(pattern) + i``); so do a calibrated tree's stacked ``(G, 16)``
codebooks, one ``(16,)`` table per layer.  A ``{i}:moe`` (or
``{i}:mamba_moe``) block's router, expert stacks ``(E, ...)`` and shared
MLP become a ``models.moe.MoE``; quantized experts are stored two codes a
byte (``core.spec.expert_spec``): the reference's msgemm-mode expert
indices are unpacked to their codes and repacked, the same codes and
scales in the int4 kernel's layout.  A ``{i}:mamba``, ``{i}:mlstm`` or
``{i}:slstm`` block's dicts become ``common.Tree`` modules under the
reference's names (``mamba.Mamba``, ``xlstm.MLSTM``, ``xlstm.SLSTM``).
An encoder-decoder tree's ``encoder`` becomes ``transformer.Encoder``
(one block a layer) and its decoder blocks keep ``ln_cross``/``cross``.
:func:`port_path` maps a reference param path (a calibration report's or
codebook's key; expert leaves included) and its slice to the port's
module path.  :func:`state_from_jax` carries a whole train state across:
the params, the AdamW moments (each in the params' structure, so through
the same mapping), ``count`` and ``step``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import packing
from repro_torch.core.linear import QLinear
from repro_torch.core.spec import QuantSpec
from repro_torch.device import resolve
from repro_torch.kvq.spec import KVQuantSpec
from repro_torch.models import (common, layers, mamba, moe, transformer,
                                xlstm)
from repro_torch.models.config import ModelConfig
from repro_torch.quant.quantize import QUANTIZABLE


# the reference's paged-attention backends and their port counterparts
KV_BACKENDS = {"paged_attn_jnp": "paged_attn_torch",
               "paged_attn_pallas": "paged_attn_cuda"}


def config_from_jax(jcfg) -> ModelConfig:
    """The port's config from a reference ``ModelConfig`` (read by
    attribute; the fields the port's decoder uses)."""
    names = {f.name for f in dataclasses.fields(ModelConfig)} \
        - {"quant", "kv_quant"}
    q, kq = jcfg.quant, jcfg.kv_quant
    kv = None if kq is None else KVQuantSpec(
        bits=kq.bits, codebook=kq.codebook,
        backend=KV_BACKENDS.get(kq.backend, kq.backend))
    return ModelConfig(**{n: getattr(jcfg, n) for n in names},
                       quant=QuantSpec(mode=q.mode, d=q.d,
                                       scale_block=q.scale_block,
                                       storage=q.storage, codebook=q.codebook),
                       kv_quant=kv)


def _t(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a)).to(device)  # a writable copy


def _linear(tree: dict, device) -> QLinear:
    return QLinear({k: _t(v, device) for k, v in tree.items()})


def _norm(tree: dict, device) -> common.Norm:
    return common.Norm(_t(tree["scale"], device),
                       _t(tree["bias"], device) if "bias" in tree else None)


def _mlp(m: dict, device) -> common.MLP:
    return common.MLP(_linear(m["up"], device), _linear(m["down"], device),
                      _linear(m["gate"], device) if "gate" in m else None)


def _experts(tree: dict, k: int, cfg: ModelConfig, device) -> QLinear:
    """An expert stack's leaves; LUT indices (E, m, ceil(k/d)) become the
    codes two a byte (E, m, ceil(k/2)) that ``expert_spec`` stores."""
    if "idx" not in tree:
        return _linear(tree, device)
    leaves = {n: _t(v, device) for n, v in tree.items() if n != "idx"}
    idx = _t(tree["idx"], device)
    d = cfg.quant.resolve_d(k, idx.shape[-2])
    leaves["u8"] = packing.storage_from_indices(idx, d, k).contiguous()
    return QLinear(leaves)


def _moe(tree: dict, cfg: ModelConfig, device) -> moe.MoE:
    ex = tree["experts"]
    d, mdff = cfg.d_model, cfg.moe_d_ff or cfg.d_ff
    experts = moe.Experts(
        _experts(ex["up"], d, cfg, device),
        _experts(ex["down"], mdff, cfg, device),
        _experts(ex["gate"], d, cfg, device) if "gate" in ex else None)
    return moe.MoE(_linear(tree["router"], device), experts,
                   _mlp(tree["shared"], device) if "shared" in tree
                   else None)


def _parts(tree: dict, device) -> dict:
    """A recurrent block's dict, key by key: norms, the MLP, the linears
    of the weight kernels (``QUANTIZABLE``), the other dicts of plain
    weights (``dt_proj``, ``xl_q``, ``sl_w``, ...) and tensors."""
    out = {}
    for k, v in tree.items():
        if k.startswith("norm"):
            out[k] = _norm(v, device)
        elif k == "mlp":
            out[k] = _mlp(v, device)
        elif k in QUANTIZABLE:
            out[k] = _linear(v, device)
        elif isinstance(v, dict):
            out[k] = common.Tree(**{n: _t(a, device) for n, a in v.items()})
        else:
            out[k] = _t(v, device)
    return out


def _ffn(tree: dict, cfg: ModelConfig, device) -> dict:
    return (dict(moe=_moe(tree["moe"], cfg, device)) if "moe" in tree
            else dict(mlp=_mlp(tree["mlp"], device)))


def _block(tree: dict, kind: str, cfg: ModelConfig, device):
    if kind == "mlstm":
        return xlstm.MLSTM(**_parts(tree, device))
    if kind == "slstm":
        return xlstm.SLSTM(**_parts(tree, device))
    if kind in ("mamba", "mamba_moe"):
        return transformer.Block(
            ln1=_norm(tree["ln1"], device),
            mamba=mamba.Mamba(**_parts(tree["mamba"], device)),
            ln2=_norm(tree["ln2"], device), **_ffn(tree, cfg, device))
    cross = (dict(ln_cross=_norm(tree["ln_cross"], device),
                  cross=_attention(tree["cross"], device))
             if "cross" in tree else {})
    return transformer.Block(ln1=_norm(tree["ln1"], device),
                             attn=_attention(tree["attn"], device),
                             ln2=_norm(tree["ln2"], device),
                             **_ffn(tree, cfg, device), **cross)


def _attention(a: dict, device) -> layers.Attention:
    norms = ((_norm(a["q_norm"], device), _norm(a["k_norm"], device))
             if "q_norm" in a else ())
    return layers.Attention(*(_linear(a[n], device)
                              for n in ("wq", "wk", "wv", "wo")), *norms)


def _index(tree, g: int):
    if isinstance(tree, dict):
        return {k: _index(v, g) for k, v in tree.items()}
    return np.asarray(tree)[g]


def params_from_jax(tree: dict, cfg: ModelConfig, *, device=None
                    ) -> transformer.Transformer:
    """Build the port's model from the reference's numpy param tree (an
    encoder-decoder tree's ``encoder`` blocks, stacked ``encoder_layers``
    deep under ``0:attn``, and ``pos_embedding`` too)."""
    dev = resolve(device)
    pattern = cfg.block_pattern
    blocks = []
    for layer in range(cfg.num_layers):
        g, i = divmod(layer, len(pattern))
        blocks.append(_block(_index(tree["blocks"][f"{i}:{pattern[i]}"], g),
                             pattern[i], cfg, dev))
    head = _linear(tree["lm_head"], dev) if "lm_head" in tree else None
    encoder = pos = None
    if "encoder" in tree:
        enc = tree["encoder"]
        encoder = transformer.Encoder(
            blocks=torch.nn.ModuleList(
                _block(_index(enc["blocks"]["0:attn"], g), "attn", cfg, dev)
                for g in range(cfg.encoder_layers)),
            final_norm=_norm(enc["final_norm"], dev))
        pos = _t(tree["pos_embedding"], dev)
    return transformer.Transformer(_t(tree["embedding"], dev),
                                   _norm(tree["final_norm"], dev), blocks,
                                   head, encoder, pos)


def port_path(path: str, g: int, cfg: ModelConfig) -> str:
    """The port's module path of slice ``g`` of the reference param path
    ``path``: ``blocks/{i}:{kind}/attn/wq`` -> ``blocks.{layer}.attn.wq``
    with layer ``g * len(cfg.block_pattern) + i`` (an expert stack,
    ``blocks/{i}:moe/moe/experts/up`` -> ``blocks.{layer}.moe.experts.up``,
    keeps its expert axis; ``blocks/{i}:mamba/mamba/in_proj`` ->
    ``blocks.{layer}.mamba.in_proj``, ``blocks/{i}:mlstm/xl_up`` ->
    ``blocks.{layer}.xl_up``; the encoder's ``encoder/blocks/0:attn/attn/
    wq`` -> ``encoder.blocks.{g}.attn.wq``); an unstacked path
    (``lm_head``) keeps its name (and g is 0)."""
    parts = path.split("/")
    if "blocks" not in parts[:2]:
        return ".".join(parts)
    at = parts.index("blocks")  # 1 under "encoder", whose period is 1
    period = len(cfg.block_pattern) if at == 0 else 1
    layer = g * period + int(parts[at + 1].split(":")[0])
    return ".".join([*parts[:at], "blocks", str(layer), *parts[at + 2:]])


def _f32_tree(tree):
    """``tree`` with f32 numpy leaves (the moments may be bf16 arrays,
    which torch cannot take from numpy)."""
    if isinstance(tree, dict):
        return {k: _f32_tree(v) for k, v in tree.items()}
    return np.asarray(tree, dtype=np.float32)


def state_from_jax(state: dict, cfg: ModelConfig, *, device=None) -> dict:
    """The port's train state (``runtime.train``) from the reference's,
    as numpy trees: ``params`` through :func:`params_from_jax`; ``opt.m``
    and ``opt.v`` the same way, kept under the names of the trainable
    leaves and cast to the reference's moment dtype; ``opt.count`` and
    ``step`` as 0-d int32 tensors."""
    from repro_torch.runtime.train import trainable

    dev = resolve(device)
    model = params_from_jax(state["params"], cfg, device=dev)
    names = list(trainable(model))
    opt = state["opt"]
    moments = {}
    for key in ("m", "v"):
        dt = (torch.bfloat16 if np.asarray(opt[key]["embedding"]).dtype.name
              == "bfloat16" else torch.float32)
        got = dict(params_from_jax(_f32_tree(opt[key]), cfg,
                                   device=dev).named_buffers())
        moments[key] = {n: got[n].to(dt) for n in names}

    def scalar(a):
        return torch.tensor(int(np.asarray(a)), dtype=torch.int32, device=dev)

    return {"params": model,
            "opt": {**moments, "count": scalar(opt["count"])},
            "step": scalar(state["step"])}
