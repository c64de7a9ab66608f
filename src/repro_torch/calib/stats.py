"""Activation statistics for calibration; port of repro.calib.stats.

A :class:`StatsCollector` installs itself as the ``core.linear`` observer
(core.linear.set_observer) and records, for every tagged linear apply,
the input second moments over a small calibration stream:

* diag: per-input-channel ``E[x_j^2]`` (k,), the activation-aware error
  weights for codebook fitting;
* full: also the second-moment matrix ``E[x x^T]`` (k, k), the Hessian
  proxy GPTQ-lite's error feedback needs.

Stats are keyed by ``(tag, k)``: the tag is the linear's name ("wq",
"up", "lm_head", ...) and k its input width.  Every layer's ``wq`` shares
one entry, as the reference's scan over layers gives all layers one tag.

Precision as the reference's: each call's sums are taken in float32 on
the activations' device (``xf*xf`` summed over rows; ``xf.T @ xf`` with
TF32 off), then accumulated across calls in float64 there.  The reference
records through ``jax.debug.callback`` so it works under ``jit``; here
:meth:`StatsCollector.record` refuses to run inside a CUDA graph capture
(a host-side accumulation cannot be replayed), and the engine never
captures with an observer installed.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import torch

from repro_torch.core import linear as qlinear
from repro_torch.device import resolve
from repro_torch.models import transformer


def model_device(model, device=None) -> torch.device:
    """The device calibration runs on: ``device`` (default: the card),
    which must be where ``model`` lives."""
    want = resolve(device)
    have = model.embedding.device
    if have.type != want.type:
        raise ValueError(f"the model lives on {have}, not on {want}; "
                         f"build it there or pass device={have.type!r}")
    return have


@dataclass
class TagStats:
    """Accumulated input moments for one (tag, k)."""

    k: int
    count: int = 0
    sumsq: torch.Tensor | None = None   # (k,) f64 sum of x_j^2
    outer: torch.Tensor | None = None   # (k, k) f64 sum of x x^T ('full')
    device: torch.device | None = None

    @property
    def second_moment(self) -> torch.Tensor:
        """diag E[x^2] (k,) f64; ones if nothing was recorded."""
        if self.count == 0 or self.sumsq is None:
            return torch.ones((self.k,), dtype=torch.float64,
                              device=self.device)
        return self.sumsq / self.count

    @property
    def hessian(self) -> torch.Tensor | None:
        """E[x x^T] (k, k) f64, or None when collected in diag mode."""
        if self.outer is None or self.count == 0:
            return None
        return self.outer / self.count


def _gram(xf: torch.Tensor) -> torch.Tensor:
    """xf.T @ xf in full float32 (TF32 off for the product)."""
    if not xf.is_cuda:
        return xf.T @ xf
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return xf.T @ xf
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


class StatsCollector:
    """Observer object for core.linear.set_observer."""

    def __init__(self, mode: str = "diag", device=None):
        if mode not in ("diag", "full"):
            raise ValueError(f"stats mode {mode!r}; one of ('diag', 'full')")
        self.mode = mode
        self.device = device  # where an entry that saw nothing answers
        self.stats: dict[tuple[str, int], TagStats] = {}

    def record(self, tag: str, x: torch.Tensor) -> None:
        if x.is_cuda and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"calibration observer called for {tag!r} inside a CUDA "
                "graph capture: statistics cannot accumulate in a replay")
        k = x.shape[-1]
        xf = x.to(torch.float32).reshape(-1, k)
        e = self._entry(tag, k, xf.device)
        ss = (xf * xf).sum(0).to(torch.float64)
        e.sumsq = ss if e.sumsq is None else e.sumsq + ss
        e.count += xf.shape[0]
        if self.mode == "full":
            o = _gram(xf).to(torch.float64)
            e.outer = o if e.outer is None else e.outer + o

    def _entry(self, tag: str, k: int, device=None) -> TagStats:
        key = (tag, k)
        if key not in self.stats:
            self.stats[key] = TagStats(k=k, device=device or self.device)
        return self.stats[key]

    def get(self, tag: str, k: int) -> TagStats:
        return self.stats.get((tag, k), TagStats(k=k, device=self.device))

    def second_moment(self, tag: str, k: int) -> torch.Tensor:
        return self.get(tag, k).second_moment


def batches_from(data, steps: int, *, device=None) -> list:
    """A calibration or eval data source as a list of batch dicts of
    tensors on ``device`` (default: the card): a SyntheticStream-like
    object (has ``host_batch``), one batch dict, or an iterable of batch
    dicts (numpy arrays or tensors)."""
    dev = resolve(device)
    if hasattr(data, "host_batch"):
        batches = [data.host_batch(s) for s in range(steps)]
    elif isinstance(data, dict):
        batches = [data]
    else:
        batches = list(data)
    return [{k: torch.as_tensor(v, device=dev) for k, v in b.items()}
            for b in batches]


@contextlib.contextmanager
def observing(collector: StatsCollector):
    """Install ``collector`` as the linear observer for the with-block."""
    qlinear.set_observer(collector)
    try:
        yield collector
    finally:
        qlinear.set_observer(None)


@torch.no_grad()
def collect(model, cfg, batches, *, mode: str = "diag",
            device=None) -> StatsCollector:
    """Run calibration batches through the dense model and collect
    per-linear input moments.  ``batches``: an iterable of batch dicts
    (``{"tokens": (B, S)}``), e.g. a few steps of a SyntheticStream;
    ``device`` (default: the card) is where the model lives."""
    dev = model_device(model, device)
    collector = StatsCollector(mode=mode, device=dev)
    with observing(collector):
        for batch in batches:
            tokens = torch.as_tensor(batch["tokens"], device=dev)
            transformer.forward(model, cfg, tokens)
    return collector
