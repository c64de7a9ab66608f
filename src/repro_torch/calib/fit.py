"""Codebook and scale fitting and the ``calibrate`` entry point; port of
repro.calib.fit.

Post-training quantization onto learned 16-entry codebooks
(calib/codebook.py).  The objective is the activation-aware weighted
reconstruction error

    E_x || (W - Q) x ||^2  ≈  sum_ij  E[x_j^2] (W_ij - Q_ij)^2

with per-channel input second moments from calib/stats.py:

* :func:`fit_codebook`     weighted Lloyd k-means over scale-normalized
                           weight values, centroid 0 pinned at 0, started
                           at the uniform int4 grid (so never worse than
                           uniform under the same scales);
* :func:`fit_block_scales` optional per-block bounding-box shrink search;
* :func:`gptq_codes`       GPTQ-lite sequential rounding with error
                           feedback through the input second moments
                           (stats mode 'full');
* :func:`calibrate`        collect stats, fit per-layer (or per-model)
                           codebooks, return a servable quantized model
                           and an error report.

The reference fits in host numpy float64.  The port fits in torch float64
on the weights' device: at gemma-2b width the host would take minutes.
The nearest-code searches run over row chunks, so a leaf's temporaries
stay bounded.  Every subsample is drawn with numpy's
``default_rng(seed).choice``, exactly as the reference draws it, so both
fit the same samples.
"""

from __future__ import annotations

import copy
import dataclasses
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.calib import stats as calib_stats
from repro_torch.calib.codebook import Codebook, uniform_values
from repro_torch.core import linear as qlinear
from repro_torch.core import packing, scales
from repro_torch.core.spec import QuantSpec, expert_spec
from repro_torch.device import resolve
from repro_torch.quant.quantize import QUANTIZABLE

INT4_MAX = packing.INT4_MAX
NLEVELS = packing.NLEVELS
# elements of one nearest-code temporary (z - values, float64): 128 MiB
CHUNK_ELEMS = 1 << 24


# ---------------------------------------------------------------- recipes
@dataclass(frozen=True)
class Recipe:
    """Knobs for one calibration run."""

    scope: str = "layer"          # layer | model  (one codebook per ...)
    method: str = "kmeans"        # kmeans | uniform (uniform = int4 grid)
    rounding: str = "nearest"     # nearest | gptq (gptq needs stats 'full')
    activation_weighting: bool = True
    kmeans_iters: int = 25
    stats_mode: str = ""          # '': 'full' for gptq rounding, else 'diag'
    calib_steps: int = 4          # calibration batches drawn from the stream
    scale_search: int = 0         # >0: per-block shrink candidates to search
    scale_search_lo: float = 0.75
    sample_limit: int = 1 << 20   # max weight samples per k-means fit
    gptq_damping: float = 1e-2    # fraction of mean(diag H) added to H

    def __post_init__(self):
        if self.scope not in ("layer", "model"):
            raise ValueError(f"scope {self.scope!r}")
        if self.method not in ("kmeans", "uniform"):
            raise ValueError(f"method {self.method!r}")
        if self.rounding not in ("nearest", "gptq"):
            raise ValueError(f"rounding {self.rounding!r}")
        if self.stats_mode == "":
            object.__setattr__(
                self, "stats_mode",
                "full" if self.rounding == "gptq" else "diag")
        if self.stats_mode not in ("diag", "full"):
            raise ValueError(f"stats_mode {self.stats_mode!r}")
        if self.rounding == "gptq" and self.stats_mode != "full":
            raise ValueError("rounding='gptq' needs stats_mode='full'")


@dataclass
class CalibResult:
    params: Any                   # the servable quantized model
    quant: Any                    # the QuantSpec it was built for
    codebooks: dict               # module path -> (16,) value table, (E, 16)
    #                               for an expert stack
    report: dict                  # per-layer + aggregate weighted errors
    collector: Any                # the StatsCollector (for inspection)


# ---------------------------------------------------------------- helpers
def _f64(a, device=None) -> torch.Tensor:
    """float64 tensor: a tensor stays on its device unless ``device`` is
    given; anything else goes to ``device`` (default: the card)."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device or a.device, dtype=torch.float64)
    return torch.as_tensor(np.asarray(a), dtype=torch.float64,
                           device=resolve(device))


def _nearest(z: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """argmin_c |z - vals[c]| (the first on ties, as ``np.argmin``) for
    every element of z, over chunks of z's leading axis."""
    if z.ndim == 0 or z.shape[0] == 0:
        return torch.argmin((z[..., None] - vals).abs(), dim=-1)
    step = max(1, CHUNK_ELEMS // max(z[0].numel() * vals.numel(), 1))
    return torch.cat([torch.argmin((z[i:i + step, ..., None] - vals).abs(),
                                   dim=-1)
                      for i in range(0, z.shape[0], step)])


def _choice(n: int, size: int, seed: int, device) -> torch.Tensor:
    """The reference's subsample: ``default_rng(seed).choice(n, size,
    replace=False)`` as an index tensor on ``device``."""
    sel = np.random.default_rng(seed).choice(n, size=size, replace=False)
    return torch.as_tensor(sel, device=device)


# ---------------------------------------------------------------- fitting
def fit_codebook(z, weights=None, *, iters: int = 25, init=None,
                 sample_limit: int = 1 << 20, seed: int = 0,
                 device=None) -> torch.Tensor:
    """Weighted Lloyd k-means over normalized weight values z (flat).

    Returns a (16,) float32 value table in code order, entry 0 pinned at
    0, on z's device.  Started at ``init`` (default: the uniform int4
    grid), so with nearest assignment the fitted table's weighted MSE is
    <= uniform's.  An empty cluster keeps its value; the loop stops early
    once no centroid moves by more than 1e-12.
    """
    z = _f64(z, device).reshape(-1)
    w = (torch.ones_like(z) if weights is None
         else _f64(weights, z.device).reshape(-1))
    if z.numel() > sample_limit:
        sel = _choice(z.numel(), sample_limit, seed, z.device)
        z, w = z[sel], w[sel]
    c = _f64(uniform_values() if init is None else init, z.device).clone()
    codes = torch.arange(NLEVELS, device=z.device)
    wz = w * z
    for _ in range(iters):
        member = _nearest(z, c)[:, None] == codes       # (n, 16)
        den = torch.where(member, w[:, None], 0.0).sum(0)
        num = torch.where(member, wz[:, None], 0.0).sum(0)
        upd = den > 0
        upd[0] = False  # code 0 stays the padding zero
        nc = torch.where(upd, num / torch.where(upd, den, 1.0), c)
        moved = bool(((nc - c).abs() > 1e-12)[upd].any())
        c = nc
        if not moved:
            break
    return c.to(torch.float32)


def _block_err(wb, s, vals, cw_b) -> torch.Tensor:
    """Per-block (weighted) squared error of rounding wb onto vals * s,
    over row chunks."""
    step = max(1, CHUNK_ELEMS // max(wb[0].numel() * vals.numel(), 1))
    out = []
    for i in range(0, wb.shape[0], step):
        w_i, s_i = wb[i:i + step], s[i:i + step, :, None]
        deq = vals[_nearest(w_i / s_i, vals)]
        e2 = (w_i - deq * s_i) ** 2
        out.append((e2 * cw_b).sum(-1) if cw_b is not None else e2.sum(-1))
    return torch.cat(out)


def fit_block_scales(w, values, block: int, col_weights=None, *,
                     candidates: int = 0, lo: float = 0.75, device=None):
    """Per-row-block scales for quantizing ``w`` onto ``values``.

    Base scale is the bounding box ``amax / 7`` (as uniform int4).  With
    ``candidates > 0`` it also searches that many shrink factors in
    [lo, 1] per block (the base scale always among them) and keeps the
    weighted-error argmin.

    Returns (scales (m, nb), padded w blocks (m, nb, block), column-weight
    blocks (1, nb, block) or None), float64 on w's device.
    """
    w = _f64(w, device)
    m, k = w.shape
    nb = -(-k // block)
    wb = F.pad(w, (0, nb * block - k)).reshape(m, nb, block)
    cw_b = None
    if col_weights is not None:
        cw_b = F.pad(_f64(col_weights, w.device),
                     (0, nb * block - k)).reshape(1, nb, block)
    amax = wb.abs().amax(-1)
    base = torch.where(amax == 0, 1.0, amax / INT4_MAX)
    if candidates <= 0:
        return base, wb, cw_b
    vals = _f64(values, w.device)
    best_err = torch.full((m, nb), float("inf"), dtype=torch.float64,
                          device=w.device)
    best_s = base.clone()
    for f in np.unique(np.append(np.linspace(lo, 1.0, candidates), 1.0)):
        s = base * float(f)
        err = _block_err(wb, s, vals, cw_b)
        better = err < best_err
        best_err = torch.where(better, err, best_err)
        best_s = torch.where(better, s, best_s)
    return best_s, wb, cw_b


def gptq_codes(w, H, values, scale, block: int, *,
               damping: float = 1e-2) -> torch.Tensor:
    """GPTQ-lite: sequential nearest-codebook rounding with error feedback.

    Columns are quantized in index order; each column's rounding error is
    compensated in the columns not yet quantized through the upper
    Cholesky factor U of the inverse input second moment (H = E[x x^T],
    H^-1 = U^T U), without reordering or lazy blocking.

    w (m, k); H (k, k); scale (m, ceil(k/block)).  Returns codes (m, k)
    uint8 on w's device.
    """
    w = _f64(w).clone()  # updated column by column
    m, k = w.shape
    H = _f64(H, w.device)
    H = H + damping * max(float(torch.diagonal(H).mean()), 1e-12) \
        * torch.eye(k, dtype=torch.float64, device=w.device)
    U = torch.linalg.cholesky(torch.linalg.inv(H)).T
    vals = _f64(values, w.device)
    scale = _f64(scale, w.device)
    codes = torch.zeros((m, k), dtype=torch.uint8, device=w.device)
    for j in range(k):
        s = scale[:, j // block]
        cj = torch.argmin((w[:, j, None] / s[:, None] - vals).abs(), dim=1)
        codes[:, j] = cj.to(torch.uint8)
        err = (w[:, j] - vals[cj] * s) / U[j, j]
        if j + 1 < k:
            w[:, j + 1:] -= torch.outer(err, U[j, j + 1:])
    return codes


def quantize_slice(w, quant: QuantSpec, values, *, col_weights=None, H=None,
                   recipe: Recipe = None) -> scales.QuantizedTensor:
    """Quantize one dense (out, in) weight onto ``values`` under ``quant``,
    with the recipe's scale search and rounding mode."""
    recipe = recipe or Recipe()
    w = _f64(w)
    m, k = w.shape
    block = quant.scale_block
    s, wb, _ = fit_block_scales(
        w, values, block, col_weights,
        candidates=recipe.scale_search, lo=recipe.scale_search_lo)
    vals = _f64(values, w.device)
    if recipe.rounding == "gptq" and H is not None:
        codes = gptq_codes(w, H, vals, s, block,
                           damping=recipe.gptq_damping)
    else:
        codes = _nearest(wb / s[..., None], vals)
        codes = codes.reshape(m, -1)[:, :k].to(torch.uint8)
    return scales.QuantizedTensor(
        codes=codes, scales=s.to(torch.float32), block=block, shape=(m, k),
        codebook=vals.to(torch.float32))


def _sample_weights(s, wb_shape, cw_b) -> torch.Tensor:
    """Per-sample k-means weights in the unnormalized error domain:
    cw_j (w - s c)^2 == (cw_j s^2) (z - c)^2, so the Lloyd objective
    equals the reported weighted_quantization_error."""
    wt = (s[..., None] ** 2).expand(wb_shape)
    if cw_b is not None:
        wt = wt * cw_b.expand(wb_shape)
    return wt.reshape(-1)


# ---------------------------------------------------------------- walking
def _quantizable_leaves(model) -> list:
    """(module path, name, QLinear) of every dense quantizable linear; a
    MoE block's expert stacks (``w`` (E, out, in)) among them."""
    return [(path, path.rsplit(".", 1)[-1], mod)
            for path, mod in model.named_modules()
            if isinstance(mod, qlinear.QLinear)
            and path.rsplit(".", 1)[-1] in QUANTIZABLE
            and "w" in mod.params()]


def _tag_for(path: str, name: str) -> str:
    """The statistics tag of a leaf: an expert stack's inputs are recorded
    under ``moe_<name>`` (``models.moe``), apart from the dense MLP's."""
    return ("moe_" + name) if "experts" in path.split(".") else name


def _reference_groups(leaves, cfg) -> list:
    """The per-layer leaves grouped as the reference stacks them, in its
    walk order: blocks first, by pattern position and then by the sorted
    path inside the block (a scanned group's keys come out sorted), layers
    ``i, i + P, i + 2P, ...`` of a group in order; then the others."""
    P = len(cfg.block_pattern)
    groups: dict[tuple, list] = {}
    for path, name, mod in leaves:
        parts = path.split(".")
        if parts[0] == "blocks":
            layer = int(parts[1])
            key = (0, layer % P, tuple(parts[2:]))
        else:
            key = (1, 0, tuple(parts))
        groups.setdefault(key, []).append((path, name, mod))
    return [groups[key] for key in sorted(groups)]


def _quantized_copy(model):
    """A copy of ``model`` that shares every tensor with it (no weight is
    duplicated; the caller replaces the copy's linears' leaves)."""
    return copy.deepcopy(model, {id(t): t for t in model.buffers()})


# ---------------------------------------------------------------- calibrate
@torch.no_grad()
def calibrate(model, cfg, data, recipe: Recipe = Recipe(), *, quant=None,
              device=None) -> CalibResult:
    """Activation-aware post-training quantization, end to end.

    ``model``/``cfg``: a dense model; ``data``: a SyntheticStream (or a
    list of batch dicts) to draw ``recipe.calib_steps`` calibration
    batches from; ``quant``: the target QuantSpec (default: msgemm;
    ``codebook='learned'`` is forced so the model carries its tables);
    ``device`` (default: the card) is where the model lives and the fit
    runs.

    A MoE block's expert stack is fitted one table an expert, from the
    statistics its block records under ``moe_<name>`` (the reference's
    slices of its stacked leaf): its codebook is (E, 16), its leaves are
    stored under ``core.spec.expert_spec`` (int4 codes two a byte) and,
    learned, it runs on ``int4_torch``.  Its report entry averages its
    experts' errors, and each expert counts as one linear in the
    aggregate, as the reference counts slices.

    Returns a :class:`CalibResult` whose ``params`` is a new model that
    serves through every path under ``cfg.replace(quant=result.quant)``;
    ``model`` is left as it was.
    """
    dev = calib_stats.model_device(model, device)
    if quant is None:
        quant = (cfg.quant if cfg.quant.mode != "bf16"
                 else QuantSpec(mode="msgemm"))
    if quant.codebook != "learned":
        quant = dataclasses.replace(quant, codebook="learned")

    batches = calib_stats.batches_from(data, recipe.calib_steps, device=dev)
    collector = calib_stats.collect(model, cfg, batches,
                                    mode=recipe.stats_mode, device=dev)
    leaves = _quantizable_leaves(model)
    uniform = uniform_values(dev)

    def colw_for(name, k):
        return (collector.second_moment(name, k)
                if recipe.activation_weighting else None)

    # scope='model': one codebook fitted over samples pooled from every
    # stacked leaf of the reference (normalized domain, weighted), shared
    model_values = None
    if recipe.scope == "model" and recipe.method == "kmeans":
        groups = _reference_groups(leaves, cfg)
        zs, ws = [], []
        per_leaf = max(recipe.sample_limit // max(len(groups), 1), 4096)
        for group in groups:
            tag = _tag_for(group[0][0], group[0][1])
            w = torch.cat([mod.params()["w"] for _, _, mod in group])
            w = w.to(torch.float64).reshape(-1, w.shape[-1])
            s, wb, cw_b = fit_block_scales(w, uniform, quant.scale_block,
                                           colw_for(tag, w.shape[-1]))
            z = (wb / s[..., None]).reshape(-1)
            wt = _sample_weights(s, wb.shape, cw_b)
            if z.numel() > per_leaf:
                sel = _choice(z.numel(), per_leaf, len(zs), dev)
                z, wt = z[sel], wt[sel]
            zs.append(z)
            ws.append(wt)
        model_values = fit_codebook(
            torch.cat(zs), torch.cat(ws), iters=recipe.kmeans_iters,
            sample_limit=recipe.sample_limit)
        Codebook(values=model_values).check()

    out = _quantized_copy(model)
    modules = dict(out.named_modules())
    codebooks: dict[str, torch.Tensor] = {}
    report: dict[str, dict] = {}
    sum_uni, sum_learned, n = 0.0, 0.0, 0
    for path, name, mod in leaves:
        w = mod.params()["w"]
        tag = _tag_for(path, name)
        k = w.shape[-1]
        colw = colw_for(tag, k)
        H = (collector.get(tag, k).hessian
             if recipe.rounding == "gptq" else None)
        # an expert stack is fitted expert by expert, one table each, as
        # the reference fits each slice of its stacked leaf
        stack = w.dim() == 3
        parts, tables, leaf_uni, leaf_new = [], [], 0.0, 0.0
        for w2 in (w.unbind(0) if stack else (w,)):
            w64 = w2.to(torch.float64)
            if recipe.method == "uniform" or (
                    recipe.scope == "model" and model_values is None):
                values = uniform
            elif recipe.scope == "model":
                values = model_values
            else:
                s, wb, cw_b = fit_block_scales(w64, uniform,
                                               quant.scale_block, colw)
                values = fit_codebook((wb / s[..., None]).reshape(-1),
                                      _sample_weights(s, wb.shape, cw_b),
                                      iters=recipe.kmeans_iters,
                                      sample_limit=recipe.sample_limit)
                del s, wb, cw_b
                Codebook(values=values).check()
            qt = quantize_slice(w64, quant, values, col_weights=colw, H=H,
                                recipe=recipe)
            del w64
            w32 = w2.to(torch.float32)
            qt_uni = scales.quantize_int4(w32, quant.scale_block)
            e_uni = float(scales.weighted_quantization_error(w32, qt_uni,
                                                             colw))
            e_new = float(scales.weighted_quantization_error(w32, qt, colw))
            del w32, qt_uni
            leaf_uni += e_uni
            leaf_new += e_new
            parts.append(qt)
            tables.append(values)
        sum_uni += leaf_uni
        sum_learned += leaf_new
        n += len(parts)
        if stack:
            spec = expert_spec(quant)
            leaves_e = [qlinear.from_quantized(qt, spec) for qt in parts]
            modules[path].load({key: torch.stack([p[key] for p in leaves_e])
                                for key in leaves_e[0]})
            codebooks[path] = torch.stack(tables)
        else:
            modules[path].load(qlinear.from_quantized(parts[0], quant))
            codebooks[path] = tables[0]
        report[path] = {"uniform_weighted_err": leaf_uni / len(parts),
                        "learned_weighted_err": leaf_new / len(parts)}
        del parts
    report["aggregate"] = {
        "num_linears": n,
        "uniform_weighted_err": sum_uni / max(n, 1),
        "learned_weighted_err": sum_learned / max(n, 1),
    }
    return CalibResult(params=out, quant=quant, codebooks=codebooks,
                       report=report, collector=collector)
