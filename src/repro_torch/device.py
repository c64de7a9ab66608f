"""Device resolution for the port's entry points.

Entry points default to the GPU.  They run on the CPU only when the caller
asks for it (``device="cpu"``, as the tests do); with no GPU present and no
explicit CPU request they raise instead of quietly running elsewhere.
"""

from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """``None`` -> ``cuda``; a CUDA device must exist, a CPU one always does.
    ``meta`` (shapes and dtypes, no storage) serves the dry run's state."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device found; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev!s}; use 'cuda' or 'cpu'")
    return dev


def generator(seed: int, device=None) -> torch.Generator:
    """A seeded ``torch.Generator`` on ``device`` (random draws on the GPU
    need a generator that lives there)."""
    return torch.Generator(device=resolve(device)).manual_seed(int(seed))


def is_fake(t: torch.Tensor) -> bool:
    """Whether ``t`` is a fake tensor (shape and dtype, no storage: the
    dry run's)."""
    from torch._subclasses.fake_tensor import FakeTensor

    return isinstance(t, FakeTensor)
