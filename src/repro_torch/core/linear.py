"""QuantizedLinear — msGeMM as a linear-layer execution mode; port of
repro.core.linear (the spec path and the calibration observer; the
deprecated ``QuantConfig`` shim is not ported).

A layer's weights are registered buffers of a :class:`QLinear`:

* ``bf16`` mode: ``w`` (out, in) dense;
* quantized modes: ``idx`` int32 (out, ceil(in/d)) LUT indices (storage
  ``packed_idx``) or ``u8`` (out, ceil(in/2)) two codes a byte
  (``packed_u8``), ``scales`` f32 (out, ceil(in/scale_block)) and the
  optional ``codebook`` (16,).

Activations are row-major ``x (..., in) -> y (..., out)``; the weight is
the paper's ``M (out, in)``.  How a linear runs is decided per shape by
``repro_torch.dispatch``.
"""

from __future__ import annotations

from dataclasses import replace

import torch
from torch import nn

from repro_torch import dispatch
from repro_torch.core import packing, scales
from repro_torch.core.spec import DENSE, QuantSpec


class QLinear(nn.Module):
    """One linear's weight leaves, held as buffers (the train step turns
    gradients on for the dense float ones while it runs).  On a mesh
    ``runtime.serve.shard_params`` records the layout it cut: ``axes``,
    the logical axes the plan shards the linear by (None: every rank
    runs it whole), and ``out_dim``, the whole output dim where the
    leaves are this rank's shard (None when they are whole)."""

    axes: tuple | None = None
    out_dim: int | None = None

    def __init__(self, params: dict[str, torch.Tensor]):
        super().__init__()
        self.load(params)

    def load(self, params: dict[str, torch.Tensor]) -> None:
        """Replace every leaf with ``params`` (quantize_model swaps a dense
        ``w`` for ``idx``/``scales`` in place)."""
        for name in list(self._buffers):
            del self._buffers[name]
        for name, t in params.items():
            self.register_buffer(name, t)

    def params(self) -> dict[str, torch.Tensor]:
        return dict(self._buffers)


# Optional activation-statistics observer (repro_torch.calib.stats installs
# one during calibration through set_observer; None costs nothing).  Kept
# here so core never imports calib.
_OBSERVER = None
# True while a rematerialized forward is recomputed for the backward pass
# (models.common.remat): side effects of the forward (the observer, MoE
# route counts) are skipped then, so each counts once a forward.  A plain
# global, not a thread-local: autograd may recompute on its own thread.
_REPLAY = False


def replaying() -> bool:
    """Whether the forward now running is a remat recompute."""
    return _REPLAY


def set_replaying(flag: bool) -> bool:
    """Set the recompute flag; returns its previous value."""
    global _REPLAY
    prev, _REPLAY = _REPLAY, flag
    return prev


def set_observer(obs) -> None:
    """Install (or clear, with None) the linear-input observer.  While set,
    every tagged :func:`apply` reports its input activations to
    ``obs.record(tag, x)``, before the GeMM runs."""
    global _OBSERVER
    _OBSERVER = obs


def init(in_dim: int, out_dim: int, spec: QuantSpec = DENSE, *,
         generator: torch.Generator, device=None, dtype=torch.float32,
         init_scale: float | None = None) -> dict:
    """Random params: a normal (out, in) weight scaled by ``in_dim**-0.5``,
    quantized per ``spec``.  ``generator`` must live on ``device``."""
    scale = init_scale if init_scale is not None else in_dim**-0.5
    w = torch.randn((out_dim, in_dim), generator=generator,
                    device=device or generator.device) * scale
    return from_dense(w, spec, dtype=dtype)


def from_dense(w: torch.Tensor, spec: QuantSpec = DENSE, *,
               dtype=torch.float32, codebook=None) -> dict:
    """This layer's params from a dense (out, in) weight.  With
    ``spec.codebook == 'learned'`` and no table, the uniform int4 values
    are stored as a placeholder, as the reference does."""
    if spec.mode == "bf16":
        return {"w": w.to(dtype)}
    if codebook is None and spec.codebook == "learned":
        codebook = packing.b_values(torch.float32, w.device)
    if codebook is not None:
        qt = scales.quantize_codebook(w, codebook, spec.scale_block)
    else:
        qt = scales.quantize_int4(w, spec.scale_block)
    return from_quantized(qt, spec)


def from_quantized(qt: scales.QuantizedTensor, spec: QuantSpec) -> dict:
    out_dim, in_dim = qt.shape
    p = {"scales": qt.scales.to(torch.float32).contiguous()}
    if spec.storage == "packed_idx":
        p["idx"] = packing.pack_indices(
            qt.codes, spec.resolve_d(in_dim, out_dim)).contiguous()
    else:
        p["u8"] = packing.pack_storage(qt.codes).contiguous()
    if qt.codebook is not None:
        p["codebook"] = torch.as_tensor(qt.codebook, dtype=torch.float32)
    return p


def apply(params, x: torch.Tensor, spec: QuantSpec = DENSE, *,
          in_dim: int | None = None, tag: str | None = None, plan=None,
          epilogue=None, bias=None, residual=None,
          shard_axes: tuple | None = None, keep_local: bool = False,
          x_axis: str | None = None,
          seq_axis: str | None = None) -> torch.Tensor:
    """x (..., in) -> y (..., out) through the dispatch registry.
    ``params`` is a dict of leaves or a :class:`QLinear`.  ``tag`` names
    this linear for the activation-statistics observer (calibration); it
    does not change the computation, and a remat recompute does not
    report again.  ``shard_axes``: the weight's logical axes, which make
    it run sharded under an active mesh (``dispatch.execute``, which also
    takes ``keep_local``, ``x_axis`` and ``seq_axis``)."""
    if _OBSERVER is not None and tag is not None and not _REPLAY:
        _OBSERVER.record(tag, x)
    out_dim = None
    if isinstance(params, QLinear):
        out_dim = params.out_dim
        params = params.params()
    return dispatch.execute(params, x, spec, in_dim=in_dim,
                            plan_override=plan, epilogue=epilogue, bias=bias,
                            residual=residual, shard_axes=shard_axes,
                            out_dim=out_dim, keep_local=keep_local,
                            x_axis=x_axis, seq_axis=seq_axis)


def serving_config(cfg: QuantSpec, mode: str) -> QuantSpec:
    """A layer's serving-time spec: ``cfg`` with its mode replaced."""
    return replace(cfg, mode=mode)
