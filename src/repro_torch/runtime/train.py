"""Training-side helpers; port of repro.runtime.train (the loss only: the
quality harness of repro_torch.calib needs it; the train step comes with
the training slice)."""

from __future__ import annotations

import torch

IGNORE = -100  # label id excluded from the loss


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor):
    """Masked CE with z-loss.  logits (B, S, V) f32, labels (B, S) int.
    Returns (mean nll, mean squared log-partition) over unmasked labels."""
    mask = (labels != IGNORE).to(torch.float32)
    labels_safe = torch.where(labels == IGNORE, 0, labels).long()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels_safe[..., None])[..., 0]
    nll = (lse - ll) * mask
    denom = mask.sum().clamp_min(1.0)
    zl = (lse.square() * mask).sum() / denom
    return nll.sum() / denom, zl
