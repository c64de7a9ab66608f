"""Fit the 16-entry KV codebook from real K/V activations; port of
repro.kvq.fit.

Reuses calib's weighted Lloyd k-means (entry 0 pinned at 0, started at
the uniform int4 grid, so the learned table never does worse than uniform
on the fitted samples).  The samples are the scale-normalized K/V values
the pool stores: a dense-cache prefill of calibration batches, every
layer's K/V read out of the cache, each (token, head) row divided by its
``amax / 7`` write scale (kvq.quantize.kv_quantize's input at bits=4).

Fitting runs in float64 on the model's device; only the 16 floats ride
the hot path, inside KVQuantSpec.
"""

from __future__ import annotations

import torch

from repro_torch.calib.stats import model_device
from repro_torch.kvq.quantize import kv_dequantize, kv_quantize
from repro_torch.kvq.spec import KVQuantSpec

INT4_MAX = 7


@torch.no_grad()
def collect_kv_samples(model, cfg, batches, *, max_samples: int = 1 << 20,
                       seed: int = 0, device=None) -> torch.Tensor:
    """Scale-normalized K/V values from a dense-cache prefill of each
    batch, flat float64 on the model's device (subsampled to
    ``max_samples``).

    The values come in the reference's order: per batch, per pattern
    position i, k then v, each over layers i, i+P, i+2P, ... (the
    reference's cache group ``(G, B, S, Hk, Dh)``), so the same seed draws
    the same samples."""
    from repro_torch.calib.fit import _choice
    from repro_torch.models import transformer

    dev = model_device(model, device)
    P = len(cfg.block_pattern)
    chunks = []
    for batch in batches:
        tokens = torch.as_tensor(batch["tokens"], device=dev)
        B, S = tokens.shape
        cache = transformer.init_cache(cfg, B, S, torch.float32, device=dev)
        transformer.prefill(model, cfg, tokens, cache)
        for i in range(P):
            for name in ("k", "v"):
                a = torch.stack([cache[layer][name] for layer in
                                 range(i, cfg.num_layers, P)])
                a = a.to(torch.float64)  # (G, B, S, Hk, Dh)
                amax = a.abs().amax(-1, keepdim=True)
                z = a / torch.where(amax > 0, amax / INT4_MAX, 1.0)
                chunks.append(z.reshape(-1))
        del cache
    z = (torch.cat(chunks) if chunks
         else torch.zeros((0,), dtype=torch.float64, device=dev))
    if z.numel() > max_samples:
        z = z[_choice(z.numel(), max_samples, seed, dev)]
    return z


def fit_kv_codebook(model, cfg, batches=None, *, tokens=None,
                    iters: int = 25, max_samples: int = 1 << 20,
                    seed: int = 0, device=None) -> tuple[float, ...]:
    """Fit the 16-entry KV value table, as a KVQuantSpec-ready tuple.
    ``batches`` is an iterable of {'tokens': (B, S)} dicts; without one
    (and without ``tokens``) a (2, min(32, max_seq_len)) batch is drawn
    from a ``torch.Generator`` seeded with ``seed`` on the model's device
    (the reference draws it with ``jax.random``, which the port cannot
    reproduce)."""
    from repro_torch.calib.fit import fit_codebook

    dev = model_device(model, device)
    if batches is None:
        if tokens is None:
            g = torch.Generator(device=dev).manual_seed(int(seed))
            S = min(32, cfg.max_seq_len)
            tokens = torch.randint(0, cfg.vocab_size, (2, S), generator=g,
                                   device=dev, dtype=torch.int32)
        batches = [{"tokens": tokens}]
    z = collect_kv_samples(model, cfg, batches, max_samples=max_samples,
                           seed=seed, device=dev)
    cb = fit_codebook(z, iters=iters, sample_limit=max_samples, seed=seed)
    return tuple(float(v) for v in cb.cpu())


@torch.no_grad()
def kv_reconstruction_error(model, cfg, batches, spec: KVQuantSpec, *,
                            max_samples: int = 1 << 18, seed: int = 0,
                            device=None) -> float:
    """Mean squared quantize -> dequantize error over real K/V samples
    (the value-space analogue of calib's weighted error; on the fitting
    samples learned <= uniform holds by construction)."""
    z = collect_kv_samples(model, cfg, batches, max_samples=max_samples,
                           seed=seed, device=device)
    x = z.to(torch.float32).reshape(1, -1)
    if x.shape[-1] % 2:  # an even row for 4-bit packing
        x = torch.nn.functional.pad(x, (0, 1))
    codes, scales = kv_quantize(x, spec)
    back = kv_dequantize(codes, scales, spec, x.shape[-1])
    return float(((back - x) ** 2).mean())
