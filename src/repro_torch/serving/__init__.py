"""Continuous-batching serving over the paged KV pool; port of
repro.serving (engine with its resilience layer, scheduler, block pool,
requests)."""

from repro_torch.serving.engine import Engine  # noqa: F401
from repro_torch.serving.kv_blocks import BlockPool  # noqa: F401
from repro_torch.serving.request import (  # noqa: F401
    Phase, Request, Sequence, detokenize, poisson_stream,
)
from repro_torch.serving.scheduler import Scheduler  # noqa: F401
