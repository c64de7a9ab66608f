"""Optimizer, schedules and the int8 cross-pod gradient reduction
(``compression``); port of repro.optim."""

from repro_torch.optim import compression, schedules  # noqa: F401
from repro_torch.optim.adamw import (  # noqa: F401
    AdamWConfig,
    adamw_init,
    adamw_update,
    global_norm,
)
