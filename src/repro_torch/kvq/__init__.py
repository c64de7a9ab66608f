"""Quantized paged KV cache; port of repro.kvq.

The pool stores low-bit codes and per-slot, per-head scales instead of
full-precision values (2-4x+ more resident sequences per pool byte), and
the CUDA paged-attention kernel dequantizes K/V on chip at read time.

* :class:`KVQuantSpec` — frozen storage description (``ModelConfig.kv_quant``);
* :func:`kv_quantize` / :func:`kv_dequantize` — the write and read ops;
* :func:`init_kv_pool`, :func:`bytes_per_token`, :func:`pool_bytes`,
  :func:`blocks_for_bytes`, :func:`capacity_table` — pool tensors and the
  capacity arithmetic the engine sizes pools with;
* :mod:`repro_torch.kvq.attention` — the paged-attention backends
  (importing this package registers them);
* :func:`fit_kv_codebook` — the Lloyd-fitted 16-entry KV codebook of
  :mod:`repro_torch.kvq.fit`, and :func:`kv_reconstruction_error`, its
  quality measure (both lazy: they pull in calib only when called).
"""

from repro_torch.kvq import attention  # noqa: F401  (registers backends)
from repro_torch.kvq.pool import (  # noqa: F401
    blocks_for_bytes, bytes_per_token, capacity_table, init_kv_pool,
    pool_bytes,
)
from repro_torch.kvq.quantize import (  # noqa: F401
    kv_dequantize, kv_quantize, pack_codes, unpack_codes,
)
from repro_torch.kvq.spec import KVQuantSpec  # noqa: F401


def fit_kv_codebook(*args, **kwargs):
    """Lazy re-export of :func:`repro_torch.kvq.fit.fit_kv_codebook` (keeps
    calib out of the serving import path)."""
    from repro_torch.kvq.fit import fit_kv_codebook as _fit
    return _fit(*args, **kwargs)


def kv_reconstruction_error(*args, **kwargs):
    """Lazy re-export of :func:`repro_torch.kvq.fit.kv_reconstruction_error`."""
    from repro_torch.kvq.fit import kv_reconstruction_error as _err
    return _err(*args, **kwargs)
