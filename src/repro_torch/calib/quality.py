"""Quality harness: compare quantization recipes on the same footing; port
of repro.calib.quality.

Metrics over a shared stream (a SyntheticStream or explicit batches),
always against the dense reference model:

* perplexity   exp(masked token cross-entropy) on the stream's labels;
* logit_mse    mean squared error of full-sequence logits vs reference;
* top1_agree   fraction of positions whose argmax token matches reference.

``compare`` evaluates named (model, cfg) variants (uniform int4, learned
codebooks, GPTQ, ...) side by side; ``compare_kv`` does the same for KV
pool storage through the paged serving path.  Every function takes
``device`` (default: the card), where the models live.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.calib.stats import batches_from as _batches_from
from repro_torch.calib.stats import model_device
from repro_torch.models import transformer
from repro_torch.runtime.train import cross_entropy


def _forward(model, cfg, batch) -> torch.Tensor:
    return transformer.forward(model, cfg, batch["tokens"])


def _metrics(got, ref, labels, acc) -> None:
    ce, _ = cross_entropy(got, labels)
    acc["ce"].append(float(ce))
    acc["mse"].append(float(((got - ref) ** 2).mean()))
    acc["agree"].append(float((got.argmax(-1) == ref.argmax(-1))
                              .to(torch.float32).mean()))


def _summary(acc) -> dict:
    return {"perplexity": float(np.exp(np.mean(acc["ce"]))),
            "logit_mse": float(np.mean(acc["mse"])),
            "top1_agree": float(np.mean(acc["agree"]))}


@torch.no_grad()
def perplexity(model, cfg, data, *, steps: int = 2, device=None) -> float:
    """exp(mean masked CE) over the stream (batches need 'labels')."""
    dev = model_device(model, device)
    ces = []
    for batch in _batches_from(data, steps, device=dev):
        ce, _ = cross_entropy(_forward(model, cfg, batch), batch["labels"])
        ces.append(float(ce))
    return float(np.exp(np.mean(ces)))


@torch.no_grad()
def evaluate(model_ref, cfg_ref, model_q, cfg_q, data, *, steps: int = 2,
             device=None) -> dict:
    """One variant against the dense reference.  Returns the metric dict."""
    dev = model_device(model_ref, device)
    acc = {"ce": [], "mse": [], "agree": []}
    for batch in _batches_from(data, steps, device=dev):
        ref = _forward(model_ref, cfg_ref, batch)
        got = _forward(model_q, cfg_q, batch)
        _metrics(got, ref, batch["labels"], acc)
    return _summary(acc)


def compare(model_ref, cfg_ref, variants: dict, data, *, steps: int = 2,
            device=None) -> dict:
    """variants: name -> (model, cfg).  Returns name -> metric dict,
    with the reference itself under 'bf16'."""
    out = {"bf16": evaluate(model_ref, cfg_ref, model_ref, cfg_ref, data,
                            steps=steps, device=device)}
    for name, (m, c) in variants.items():
        out[name] = evaluate(model_ref, cfg_ref, m, c, data, steps=steps,
                             device=device)
    return out


# ------------------------------------------------------ KV-cache quality
def _paged_arrays(B: int, S: int, block_size: int):
    """Contiguous per-row block tables and the (write, view) slot arrays
    of one full-sequence paged forward: row b owns blocks [1 + b*n,
    1 + (b+1)*n) of a pool sized exactly for the batch."""
    from repro_torch.serving import kv_blocks

    n = -(-S // block_size)
    ws, vs = [], []
    for b in range(B):
        blocks = [1 + b * n + i for i in range(n)]
        ws.append(kv_blocks.write_slots(blocks, 0, S, S, block_size))
        vs.append(kv_blocks.view_slots(blocks, n, block_size))
    return np.stack(ws), np.stack(vs), 1 + B * n


def _forward_paged(model, cfg, batch, *, block_size: int = 8):
    """Full-sequence logits through the paged serving path in one (B, S)
    chunk: each attention layer writes the (quantized) K/V before it reads
    the view, so every position's logits see quantized-KV attention."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    dev = tokens.device
    ws, vs, num_blocks = _paged_arrays(B, S, block_size)
    pool = transformer.init_paged_cache(cfg, num_blocks, block_size,
                                        device=dev)
    positions = torch.arange(S, device=dev, dtype=torch.int32).expand(B, S)
    logits, _ = transformer.forward_paged(
        model, cfg, tokens, pool, positions,
        torch.as_tensor(ws, device=dev), torch.as_tensor(vs, device=dev))
    return logits


@torch.no_grad()
def evaluate_kv(model, cfg, kv_spec, data, *, steps: int = 2,
                block_size: int = 8, device=None) -> dict:
    """One KV-storage variant against the dense forward, same weights.
    ``kv_spec`` None runs the paged path with a full-precision pool: its
    metrics certify the harness (logit_mse 0, top1_agree 1 up to float
    noise)."""
    dev = model_device(model, device)
    cfg_q = cfg.replace(kv_quant=kv_spec)
    acc = {"ce": [], "mse": [], "agree": []}
    for batch in _batches_from(data, steps, device=dev):
        ref = _forward(model, cfg, batch)
        got = _forward_paged(model, cfg_q, batch, block_size=block_size)
        _metrics(got, ref, batch["labels"], acc)
    return _summary(acc)


def compare_kv(model, cfg, kv_variants: dict, data, *, steps: int = 2,
               block_size: int = 8, device=None) -> dict:
    """kv_variants: name -> KVQuantSpec | None.  Returns name -> metric
    dict, with the full-precision pool under 'bf16_kv'."""
    out = {"bf16_kv": evaluate_kv(model, cfg, None, data, steps=steps,
                                  block_size=block_size, device=device)}
    for name, spec in kv_variants.items():
        out[name] = evaluate_kv(model, cfg, spec, data, steps=steps,
                                block_size=block_size, device=device)
    return out
