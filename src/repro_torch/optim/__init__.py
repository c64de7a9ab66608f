"""Optimizer and schedules; port of repro.optim (``compression``, the
int8 cross-pod gradient reduction, comes with the multi-GPU slice)."""

from repro_torch.optim import schedules  # noqa: F401
from repro_torch.optim.adamw import (  # noqa: F401
    AdamWConfig,
    adamw_init,
    adamw_update,
    global_norm,
)
