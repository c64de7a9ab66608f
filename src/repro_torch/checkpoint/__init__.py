"""Checkpointing; port of repro.checkpoint (see :mod:`.manager`)."""

from repro_torch.checkpoint.manager import (  # noqa: F401
    CheckpointCorrupt,
    CheckpointManager,
)
