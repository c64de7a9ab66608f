"""repro_torch.dispatch — GeMM execution behind a stable front end; port of
repro.dispatch (registry, heuristic plans, ``execute``).

``QuantSpec`` says what the weights are; the registry holds the execution
paths; ``plan()`` maps (spec, m, k, batch, device) to a frozen
:class:`ExecPlan` by heuristic; ``execute()`` runs one linear through it.
Autotuning, the plan cache, sharding and quarantine wait for their slices.

Each ``execute`` reports through ``repro_torch.obs`` under the reference's
names: ``dispatch_epilogue_total{fused}`` once per call that carries a
non-identity epilogue (the reference counts once per traced call site;
here that is once per eager call and once per CUDA graph capture), and a
device mark ``gemm.<backend>.m<m>.k<k>.b<b>`` around the backend call,
observed into ``kernel_gemm_s`` when tracing is on.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from repro_torch import obs
from repro_torch.core.epilogue import Epilogue, apply_epilogue
from repro_torch.core.spec import QuantSpec
from repro_torch.dispatch.registry import (  # noqa: F401
    Backend, available_backends, backend_names, get_backend,
    register_backend, select_backend,
)
from repro_torch.dispatch import backends as _backends  # noqa: F401 (registers)
from repro_torch.kernels import ops
from repro_torch.kernels.int4_matmul import Int4Tiles
from repro_torch.kernels.msgemm import Tiles


@dataclass(frozen=True)
class ExecPlan:
    """backend: registered backend name.  tiles: the msGeMM or int4
    kernel's work split (None: the kernel wrapper's heuristic)."""

    backend: str
    tiles: Tiles | Int4Tiles | None = None


def plan_d(spec: QuantSpec, m: int, k: int) -> int:
    """The resolved LUT depth for msgemm, the declared d otherwise."""
    if spec.mode == "msgemm":
        return spec.resolve_d(k, m)
    return int(spec.d) if isinstance(spec.d, int) else 0


def heuristic_plan(spec: QuantSpec, d: int, m: int, k: int, batch: int,
                   backend: str) -> ExecPlan:
    if backend == "msgemm_cuda":
        return ExecPlan(backend=backend, tiles=ops.msgemm_tiles(
            m, math.ceil(k / d), batch, d, spec.scale_block))
    if backend == "int4_cuda":
        return ExecPlan(backend=backend, tiles=ops.int4_tiles(m, k, batch))
    return ExecPlan(backend=backend)


def plan(spec: QuantSpec, m: int, k: int, batch: int = 1, *,
         device_type: str = "cuda", backend: str | None = None) -> ExecPlan:
    """Resolve the execution of one (spec, shape): ``backend`` forces a
    registered backend, else the highest-priority capable one."""
    d = plan_d(spec, m, k)
    be = (get_backend(backend) if backend is not None
          else select_backend(spec, d, device_type))
    return heuristic_plan(spec, d, m, k, batch, be.name)


def _infer_k(params: dict, spec: QuantSpec) -> int:
    if spec.mode == "bf16":
        return params["w"].shape[-1]
    if spec.storage == "packed_u8":
        return params["u8"].shape[-1] * 2
    if spec.d != "adaptive":
        return params["idx"].shape[-1] * int(spec.d)
    raise ValueError(
        "cannot infer the input dim of an adaptive-d 'packed_idx' linear "
        "from its params; pass in_dim explicitly")


def execute(params: dict, x, spec: QuantSpec, *, in_dim: int | None = None,
            plan_override: ExecPlan | None = None,
            epilogue: Epilogue | None = None, bias=None, residual=None):
    """Run one linear ``x (..., k) -> y (..., m)`` through the registry.

    ``epilogue`` describes ``y = act(y + bias) + residual`` (then cast).
    A backend that can fuses it (``msgemm_cuda``, ``int4_cuda``); otherwise
    the same ops
    run after the GeMM (``apply_epilogue``).
    ``bias`` is (m,); ``residual`` matches the output (..., m).
    """
    k = in_dim if in_dim is not None else _infer_k(params, spec)
    m = (params["w"].shape[0] if spec.mode == "bf16"
         else params["scales"].shape[0])
    batch = math.prod(x.shape[:-1]) if x.ndim > 1 else 1
    p = plan_override or plan(spec, m, k, batch, device_type=x.device.type)
    be = get_backend(p.backend)
    d = plan_d(spec, m, k)
    if not be.supports(spec, d):
        raise ValueError(
            f"plan backend {be.name!r} cannot execute mode={spec.mode!r} "
            f"d={d} storage={spec.storage!r} codebook={spec.codebook!r}")
    # an array without its Epilogue flag would be silently ignored
    if bias is not None and (epilogue is None or not epilogue.bias):
        raise ValueError("bias array given but the epilogue does not "
                         "declare bias=True")
    if residual is not None and (epilogue is None or not epilogue.residual):
        raise ValueError("residual array given but the epilogue does not "
                         "declare residual=True")
    fuse = (epilogue is not None and not epilogue.is_identity
            and be.epilogue_ok(epilogue))
    if epilogue is not None and not epilogue.is_identity:
        obs.registry().counter(
            "dispatch_epilogue_total",
            help="non-identity epilogues by fused/unfused execution",
            fused="true" if fuse else "false").inc()
    mark = f"gemm.{be.name}.m{m}.k{k}.b{batch}"
    labels = {"backend": be.name, "m": m, "k": k, "b": batch,
              "mode": spec.mode, "d": d, "sb": spec.scale_block}
    x = obs.mark_begin(x, mark)
    if fuse:
        y = be.run(spec, p, params, x, k=k, epilogue=epilogue, bias=bias,
                   residual=residual)
        return obs.mark_end(y, mark, cat="gemm", hist="kernel_gemm_s",
                            hist_labels=labels)
    y = be.run(spec, p, params, x, k=k)
    y = obs.mark_end(y, mark, cat="gemm", hist="kernel_gemm_s",
                     hist_labels=labels)
    return apply_epilogue(y, epilogue, bias=bias, residual=residual)
