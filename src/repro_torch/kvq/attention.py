"""Paged-attention backends over the quantized KV pool; port of
repro.kvq.attention.

Two peers register in the dispatch registry under mode ``"paged_attn"``
(duck-typed query: ``Backend.supports`` reads only ``mode``, ``storage``
and ``codebook``):

* ``paged_attn_torch``  gather codes and scales by view slot, dequantize
                        the whole view in device memory, then the exact
                        ``models.layers._sdpa`` math (the counterpart of
                        ``paged_attn_jnp``); runs anywhere;
* ``paged_attn_cuda``   kernels/paged_attention.py (the counterpart of
                        ``paged_attn_pallas``): block tables, dequantize
                        on chip, online softmax.  Auto-selected on a CUDA
                        device; forced by name on the CPU it runs the
                        kernel's plain version.

``KVQuantSpec.backend`` forces one by name.  Under an active mesh
(``distributed.sharding.use``) :func:`select` pins ``paged_attn_torch``,
as the reference pins its jnp route: each rank attends over its own
heads of its pool shard.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import obs
from repro_torch.dispatch import registry
from repro_torch.distributed.sharding import active_mesh
from repro_torch.kernels import paged_attention as pa
from repro_torch.kvq.quantize import codebook_tensor, kv_dequantize
from repro_torch.kvq.spec import KVQuantSpec

KV_STORAGE = "kv_u8"


class _AttnQuery(NamedTuple):
    """Duck-typed stand-in for QuantSpec in registry capability checks."""
    mode: str
    storage: str
    codebook: str


def run_torch(spec: KVQuantSpec, cfg, q, pool, view_slots, positions, *,
              window: int = 0):
    """Reference: gather and dequantize the view, dense sdpa.

    q (B, C, H, Dh); pool the layer's quantized tensors (nb, bs, Hk, ...);
    view_slots (B, W) flat slots; positions (B, C).  Returns (B, C, H*Dh).
    """
    from repro_torch.models import layers  # lazy: layers imports kvq

    nb, bs, hk, dhp = pool["k"].shape
    dh = q.shape[-1]
    vs = view_slots.long()
    kc = obs.mark_begin(pool["k"].view(nb * bs, hk, dhp), "kv_dequant")
    k_view = kv_dequantize(kc[vs], pool["k_scale"].view(nb * bs, hk)[vs],
                           spec, dh)
    v_view = kv_dequantize(pool["v"].view(nb * bs, hk, dhp)[vs],
                           pool["v_scale"].view(nb * bs, hk)[vs], spec, dh)
    v_view = obs.mark_end(v_view, "kv_dequant", cat="kv",
                          hist="kv_dequant_s")
    m = layers.view_mask(view_slots.shape[1], positions, window=window)
    return layers._sdpa(cfg, q, k_view, v_view, m[:, None])


def run_cuda(spec: KVQuantSpec, cfg, q, pool, view_slots, positions, *,
             window: int = 0):
    """Dequantize inside the kernel.  Block tables come from the slot view
    (view position w·bs starts block w, and slot // bs is its block id:
    exact because the scheduler builds views from whole blocks)."""
    bs = pool["k"].shape[1]
    B, C, H, dh = q.shape
    block_tables = (view_slots[:, ::bs] // bs).to(torch.int32).contiguous()
    out = pa.paged_attention(
        q.contiguous(), pool["k"], pool["k_scale"], pool["v"],
        pool["v_scale"], block_tables,
        positions.to(torch.int32).contiguous(), bits=spec.bits,
        codebook=(None if spec.codebook is None
                  else codebook_tensor(spec.codebook, q.device)),
        block_size=bs, window=window,
        softcap=float(cfg.attn_logit_softcap or 0.0))
    return out.reshape(B, C, H * dh)


registry.register_backend(
    "paged_attn_torch", modes=("paged_attn",), run=run_torch, priority=50,
    storages=(KV_STORAGE,), codebooks=("none", "learned"),
    description="gather and dequantize the view in device memory, dense "
                "sdpa (reference)",
    overwrite=True)
registry.register_backend(
    "paged_attn_cuda", modes=("paged_attn",), run=run_cuda, priority=60,
    is_available=lambda dev: dev == "cuda",
    storages=(KV_STORAGE,), codebooks=("none", "learned"),
    description="hand-written Hopper paged attention, dequantize on chip",
    overwrite=True)


def select(spec: KVQuantSpec, device_type: str = "cuda") -> str:
    """The backend serving ``spec`` on ``device_type`` (forced override >
    mesh pin > registry priority)."""
    if spec.backend is not None:
        be = registry.get_backend(spec.backend)
        if "paged_attn" not in be.modes:
            raise ValueError(
                f"backend {spec.backend!r} is not a paged-attention "
                f"backend (modes={be.modes})")
        return spec.backend
    if active_mesh() is not None:
        return "paged_attn_torch"
    query = _AttnQuery("paged_attn", KV_STORAGE, spec.codebook_kind)
    return registry.select_backend(query, 1, device_type).name


def run(spec: KVQuantSpec, cfg, q, pool, view_slots, positions, *,
        window: int = 0):
    """One paged-attention step through the backend selected for q's
    device."""
    be = registry.get_backend(select(spec, q.device.type))
    return be.run(spec, cfg, q, pool, view_slots, positions, window=window)


def dequant_hbm_bytes(spec: KVQuantSpec, cfg, max_slots: int,
                      view_width: int, device_type: str = "cuda") -> int:
    """Device bytes of dequantized K/V one layer-step materializes with
    the selected backend (0 for the kernel, whose f32 tiles live only in
    shared memory)."""
    if select(spec, device_type) == "paged_attn_cuda":
        return 0
    return 2 * max_slots * view_width * cfg.num_kv_heads * cfg.head_dim * 4
