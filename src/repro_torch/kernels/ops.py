"""Public wrappers around the msGeMM, int4 GeMM and flash-attention
kernels; port of repro.kernels.ops.

The GeMM wrappers handle the vector-x squeeze, the epilogue operands in
the kernels' (m, b) column layout, the code->value table, and the Hopper
tile choice.  Those kernels mask ragged rows, columns and k themselves,
so nothing is padded to tile multiples there (the TPU wrapper had to pad
every operand).  None of the TPU VMEM budgeting carries over.
:func:`flash_attention` keeps the reference's public layout and its
padding, which decides what queries past the last key see.
"""

from __future__ import annotations

import functools
import gc
import heapq
import math
import time

import numpy as np
import torch

from repro_torch.core import packing
from repro_torch.core.epilogue import Epilogue, torch_dtype
from repro_torch.device import is_fake
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import int4_matmul as _i4
from repro_torch.kernels import msgemm as _ms
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels.int4_matmul import Int4Tiles
from repro_torch.kernels.msgemm import Tiles

# every kernel's module, whose ``launches`` counts its launches
KERNELS = {"msgemm": _ms, "int4_matmul": _i4, "paged_attention": _pa,
           "flash_attention": _fa}

# H100 SXM streaming multiprocessors.  A constant, not a device query, so
# the CPU path picks the same contraction split (and so the same bits) as
# the card.
NUM_SMS = 132
SM_SMEM = 233_472  # shared memory of one SM; each block also takes 1 KiB
STAGE_WORDS = 8192  # indices in one staged tile: rows x stage
BLOCK_OVERHEAD = 2  # a block's fixed cost (prologue, epilogue) in chunks
# a block's fixed cost (x and scale staging, epilogue) in 256-code steps
# of the int4 kernel: at a fixed share of steps an SM, its time grew by
# about a step for every further block (gemma-2b's down at b = 1, 4 to 64
# splits; PERF.md section 6)
INT4_BLOCK_OVERHEAD = 1
# a timed call cycles over copies of its weights, at least this many bytes
# of them (the L2 holds 50 MB), so each call reads its weights from HBM as
# an engine step finds a layer's
L2_BYTES = 50 * 2**20
L2_FLUSH_BYTES = 120 * 2**20
MAX_COPIES = 256
# cycles the card sleeps per timed call while the host enqueues the calls
# (200 us at 2 GHz): the events then bracket the kernels, not the host
SLEEP_CYCLES_PER_CALL = 400_000
# calls a timed window queues behind one sleep: a few launches each stay
# far inside the launch queue (about a thousand entries), which one window
# of 512 int4 GeMM calls filled on an H100: the host then waited there
# until the sleep ended, and every such window read as a stalled one
CALLS_PER_WINDOW = 64
# timings of one window at most: a window whose sleep ran out before the
# host queued its last call is timed again behind twice the sleep
TIME_ATTEMPTS = 4
# windows timed again because the host fell behind the card's sleep
time_call_retries = 0
# m x kc from which 2048-row blocks beat 1024-row ones at tb = 1 (on the
# card: gemma-2b gate and down, 11.2M, faster; wq, 1.4M, slower)
ROW_CHUNKS_2048 = 4_000_000


@functools.lru_cache(maxsize=None)
def msgemm_tiles(m: int, kc: int, b: int, d: int, scale_block: int) -> Tiles:
    """Hopper tile choice for (m rows, kc LUT chunks, b columns), a
    function of the shape alone.

    tb: the batch columns one table serves (4, or 1 for b = 1 and d = 4);
    b > 4 runs as several column tiles, each with its own table.  rows:
    1024 a block (512 for m <= 512), so one table build serves as many
    rows as a block's shared memory allows at tb = 4 (two 64 KiB tables
    and two staged index tiles); at tb = 1 the tables are a quarter of
    that and 2048 rows fit, which pays once the GeMM has enough row-chunks
    (ROW_CHUNKS_2048) for the split to fill the card with fewer row tiles.
    stage and tj: :func:`split_tiles`.
    """
    tb = 1 if b == 1 or d == 4 else 4
    rows = (512 if m <= 512 else
            2048 if tb == 1 and m * kc >= ROW_CHUNKS_2048 else 1024)
    return split_tiles(m, kc, b, d, scale_block, tb=tb, rows=rows)


def _makespan(row_tiles: int, col_tiles: int, works: list[int],
              slots: int) -> int:
    """When the last block ends, if blocks start in launch order (row tile
    fastest, then split, then column tile) on the first free of ``slots``
    and split s's blocks take ``works[s]``."""
    free = [0] * slots
    for _ in range(col_tiles):
        for w in works:
            for _ in range(row_tiles):
                heapq.heapreplace(free, free[0] + w)
    return max(free)


def _slots(d: int, tiles: Tiles) -> int:
    """Blocks of ``tiles`` in flight on the card at once: NUM_SMS SMs, as
    many blocks an SM as the threads and the variant's shared memory
    allow."""
    smem = _ms.smem_bytes(d, tiles.tb, tiles.rows, tiles.stage)
    return NUM_SMS * max(1, min(2048 // _ms.THREADS,
                                SM_SMEM // (smem + 1024)))


def msgemm_span(m: int, kc: int, b: int, d: int, tiles: Tiles) -> int:
    """When the last block of ``tiles``' grid ends, in LUT chunks, if
    blocks start in launch order on the first free of :func:`_slots` and
    a block costs its chunks plus BLOCK_OVERHEAD (the split picker's cost,
    and the perf model's work term)."""
    gx, _, gz = _ms.grid(m, kc, b, tiles)
    works = [min(tiles.tj, kc - j) + BLOCK_OVERHEAD
             for j in range(0, kc, tiles.tj)]
    return _makespan(gx, gz, works, _slots(d, tiles))


def split_ranking(m: int, kc: int, b: int, d: int, scale_block: int, *,
                  tb: int, rows: int) -> list[Tiles]:
    """Every split :func:`split_tiles` weighs once tb and rows are fixed,
    best first: the index stage of STAGE_WORDS indices, and tj, whole
    scale blocks per contraction split, ranked by :func:`msgemm_span`;
    ties go to fewer splits."""
    cpb = scale_block // d
    nsb = -(-kc // cpb)
    tiles = Tiles(tb=tb, rows=rows, stage=STAGE_WORDS // rows, tj=nsb * cpb)
    gx, _, gz = _ms.grid(m, kc, b, tiles)
    slots = _slots(d, tiles)
    ranked = sorted(
        (msgemm_span(m, kc, b, d, tiles._replace(tj=tj)), -tj)
        for tj in {-(-nsb // w) * cpb for w in
                   range(1, min(nsb, 2 * slots // (gx * gz) + 1) + 1)})
    return [tiles._replace(tj=-neg) for _, neg in ranked]


def split_tiles(m: int, kc: int, b: int, d: int, scale_block: int, *,
                tb: int, rows: int) -> Tiles:
    """The rest of a tile choice once tb and rows are fixed: the best of
    :func:`split_ranking`."""
    return split_ranking(m, kc, b, d, scale_block, tb=tb, rows=rows)[0]


def msgemm_variants(m: int, kc: int, b: int, d: int, scale_block: int, *,
                    top: int = 3) -> list[Tiles]:
    """The msGeMM tile choices worth timing at one shape (the autotuner's
    candidates, ``chip_smoke.py --sweep msgemm``'s variants): the
    picker's tb, each row block (512, 1024, 2048) whose block fits the
    card's shared memory, and for each the ``top`` best splits of
    :func:`split_ranking`.  :func:`msgemm_tiles`'s choice is always one
    of them."""
    tb = msgemm_tiles(m, kc, b, d, scale_block).tb
    out = []
    for rows in (512, 1024, 2048):
        if _ms.smem_bytes(d, tb, rows, STAGE_WORDS // rows) <= _ms.SMEM_LIMIT:
            out += split_ranking(m, kc, b, d, scale_block, tb=tb,
                                 rows=rows)[:top]
    return out


def launch_counts() -> dict[str, int]:
    return {name: mod.launches for name, mod in KERNELS.items()}


def msgemm(idx: torch.Tensor, x: torch.Tensor, d: int, *,
           scales: torch.Tensor, scale_block: int = 36,
           codebook: torch.Tensor | None = None, tiles: Tiles | None = None,
           epilogue: Epilogue | None = None,
           bias: torch.Tensor | None = None,
           residual: torch.Tensor | None = None) -> torch.Tensor:
    """y (m, b) = epilogue(dequant(idx) @ x (k, b)) through the kernel
    (CUDA tensors) or its plain version (CPU tensors).

    idx (m, ceil(k/d)) int32 LUT indices; x (k, b) or (k,); scales (m,
    ceil(k/scale_block)); codebook: optional (16,) value table (entry 0 must
    be 0), the uniform int4 grid when None.  ``epilogue`` is fused:
    ``bias`` is (m,), ``residual`` (m, b) column layout.  The output dtype
    is ``epilogue.out_dtype``, float32 when unset.
    """
    ep = epilogue or Epilogue()
    if ep.bias != (bias is not None) or ep.residual != (residual is not None):
        raise ValueError("bias/residual arrays must match the epilogue flags "
                         f"(epilogue={ep}, bias given={bias is not None}, "
                         f"residual given={residual is not None})")
    squeeze = x.ndim == 1
    if squeeze:
        x = x[:, None]
        if residual is not None and residual.ndim == 1:
            residual = residual[:, None]
    m, kc = idx.shape
    if tiles is None:
        tiles = msgemm_tiles(m, kc, x.shape[1], d, scale_block)
    values = (packing.device_values(x.device) if codebook is None
              else codebook.to(torch.float32).contiguous())
    f32 = lambda t: None if t is None else t.to(torch.float32)  # noqa: E731
    # x and the residual go as they are when the kernel reads their type
    # (the engine's bf16 activations); the widening to f32 is exact
    own = lambda t: t if t is None or t.dtype in _ms.OUT_TYPES \
        else f32(t)  # noqa: E731
    idx = idx.to(torch.int32).contiguous()
    # the kernel copies 16-byte vectors of idx (a fake one has no address)
    if not is_fake(idx) and idx.data_ptr() % 16:
        idx = idx.clone()
    y = _ms.msgemm(
        idx, own(x),
        f32(scales).contiguous(), values, d=d, scale_block=scale_block,
        tiles=tiles, act=ep.act,
        bias=None if bias is None else f32(bias).contiguous(),
        residual=own(residual),
        out_dtype=torch_dtype(ep.out_dtype) or torch.float32)
    return y[:, 0] if squeeze else y


@functools.lru_cache(maxsize=None)
def int4_tiles(m: int, k: int, b: int, e: int = 1) -> Int4Tiles:
    """Hopper tile choice for the int4 kernel, a function of the shape
    alone (``e``: the experts of a stacked launch, whose grid holds e
    times the blocks): tb columns per block (the batch, rounded up to 1,
    2, 4 or 8);
    nsplit, the contraction splits (whole 256-code steps) whose blocks
    end soonest on NUM_SMS SMs; and an x tile of tk codes, a split's
    range at most, that keeps tb·tk floats at 32 KiB of shared memory.

    The split's cost model is :func:`int4_span` (never less than two
    blocks' worth an SM: one block of 8 warps cannot hide the loads'
    latency); ties go to fewer splits.
    So gemma-2b's down (64 row tiles over 64 steps at b = 4) takes 4
    splits and wk/wv (8 row tiles) 8, while gate/up (512 row tiles) keep
    one: the fewest splits that bring the grid to about two blocks an SM,
    where the blocks divide evenly over the SMs.  On the card it picks
    the fastest split count of ``chip_smoke.py --sweep int4``, or one
    within a few per cent, at every engine shape (PERF.md section 6)."""
    tb = next(t for t in (1, 2, 4, 8) if t >= min(b, 8))
    steps = -(-max(k, 1) // _i4.STEP)
    best = None
    for n in range(1, steps + 1):
        per, splits = _i4.split_steps(k, n)
        if splits != n:
            continue
        tiles = Int4Tiles(tb=tb, tk=min(per * _i4.STEP, 8192 // tb),
                          nsplit=n)
        cost = int4_span(m, k, b, tiles, e)
        if best is None or cost < best[0]:
            best = (cost, tiles)
    return best[1]


def int4_span(m: int, k: int, b: int, tiles: Int4Tiles, e: int = 1) -> int:
    """The split picker's cost of ``tiles``, in 256-code steps: the blocks
    (of all ``e`` experts of a stacked launch) spread evenly over NUM_SMS
    SMs, and an SM takes its share of blocks (never less than two blocks'
    worth) times a block's steps plus INT4_BLOCK_OVERHEAD (also the perf
    model's work term, which prices one linear: e = 1)."""
    blocks = -(-m // _i4.rows_per_block(tiles.tb)) * -(-b // tiles.tb) * e
    per, splits = _i4.split_steps(k, tiles.nsplit)
    return (max(2, -(-blocks * splits // NUM_SMS))
            * (per + INT4_BLOCK_OVERHEAD))


def int4_variants(m: int, k: int, b: int, e: int = 1) -> list[Int4Tiles]:
    """The int4 tile choices worth timing at one shape (the autotuner's
    candidates, ``chip_smoke.py --sweep int4``'s variants): the picker's
    tb with every split count that :func:`int4_matmul.split_steps` admits
    (no empty split) up to four times the picker's, each with its tk
    derived as :func:`int4_tiles` derives it.  The picker's choice is one
    of them."""
    picked = int4_tiles(m, k, b, e)
    out = []
    for n in range(1, 4 * picked.nsplit + 1):
        per, splits = _i4.split_steps(k, n)
        if splits == n:
            out.append(Int4Tiles(tb=picked.tb,
                                 tk=min(per * _i4.STEP, 8192 // picked.tb),
                                 nsplit=n))
    return out


def int4_matmul(u8: torch.Tensor, scales: torch.Tensor, x: torch.Tensor, *,
                scale_block: int = 32, tiles: Int4Tiles | None = None,
                epilogue: Epilogue | None = None,
                bias: torch.Tensor | None = None,
                residual: torch.Tensor | None = None) -> torch.Tensor:
    """y (m, b) = epilogue(dequant(packed u8 (m, k/2)) @ x (k, b)) through
    the int4 kernel (CUDA tensors) or its plain version (CPU tensors).

    scales (m, ceil(k/scale_block)); x (k, b) or (k,).  ``epilogue`` is
    fused: ``bias`` is (m,), ``residual`` (m, b) column layout.  The output
    dtype is ``epilogue.out_dtype``, float32 when unset.  A ragged last
    scale block and odd k are masked in the kernel, not padded.  An
    expert stack (u8 (E, m, k/2), scales (E, m, nsb), x (E, k, b)) runs
    in one launch to y (E, m, b); its epilogue takes no bias or residual.
    """
    ep = epilogue or Epilogue()
    if ep.bias != (bias is not None) or ep.residual != (residual is not None):
        raise ValueError("bias/residual arrays must match the epilogue flags "
                         f"(epilogue={ep}, bias given={bias is not None}, "
                         f"residual given={residual is not None})")
    squeeze = x.ndim == 1
    if squeeze:
        x = x[:, None]
        if residual is not None and residual.ndim == 1:
            residual = residual[:, None]
    if tiles is None:
        tiles = int4_tiles(u8.shape[-2], x.shape[-2], x.shape[-1],
                           u8.shape[0] if u8.ndim == 3 else 1)
    f32 = lambda t: None if t is None else t.to(torch.float32)  # noqa: E731
    # x and the residual go as they are when the kernel reads their type
    # (the engine's bf16 activations); the widening to f32 is exact
    own = lambda t: t if t is None or t.dtype in _ms.OUT_TYPES \
        else f32(t)  # noqa: E731
    y = _i4.int4_matmul(
        u8.contiguous(), f32(scales).contiguous(), own(x),
        scale_block=scale_block, tiles=tiles, act=ep.act,
        bias=None if bias is None else f32(bias).contiguous(),
        residual=own(residual),
        out_dtype=torch_dtype(ep.out_dtype) or torch.float32)
    return y[:, 0] if squeeze else y


def k_chunk_params(params: dict, *, k: int, chunks: int, d: int = 1,
                   scale_block: int = 1) -> list[dict]:
    """Split a quantized linear's packed params into ``chunks``
    contraction slices — the chunked consume of pipelined sharded
    execution (``dispatch.shard``).

    Every packed leaf stores the contraction dim in columns at its own
    density: ``w`` (dense) has k columns, ``idx`` k/d packed tuples,
    ``u8`` k/2 nibble pairs, ``scales`` k/scale_block blocks.  Chunk c of
    leaf L is columns [c*w_L, (c+1)*w_L) with ``w_L = cols_L // chunks``
    (a view); ``codebook`` (and any other leaf) has no contraction dim
    and goes into every chunk.  Feeding chunk c's dict and the matching
    k-slice of x through the same backend gives that chunk's partial
    product.  k must be chunk-aligned at every density (``shard_spec_for``
    admits only such chunk counts); ValueError otherwise."""
    chunks = max(int(chunks), 1)
    if chunks == 1:
        return [dict(params)]
    cols = {"w": k, "idx": k // max(int(d), 1), "u8": k // 2,
            "scales": k // max(int(scale_block), 1)}
    out = []
    for c in range(chunks):
        sl = {}
        for name, leaf in params.items():
            width = cols.get(name)
            if width is None:  # codebook etc.: no contraction dim
                sl[name] = leaf
                continue
            if width % chunks:
                raise ValueError(
                    f"k_chunk_params: leaf {name!r} has {width} "
                    f"contraction columns, not divisible by {chunks}")
            w = width // chunks
            sl[name] = leaf.narrow(1, c * w, w)
        out.append(sl)
    return out


def copies_past_l2(nbytes: int, cap: int = MAX_COPIES) -> int:
    """How many copies of an ``nbytes`` weight a timed call cycles over:
    enough to pass ``L2_FLUSH_BYTES``, at most ``cap``."""
    return max(1, min(cap, math.ceil(L2_FLUSH_BYTES / max(nbytes, 1))))


def time_call(fns, device: torch.device, reps: int) -> float:
    """Seconds a call of ``fns`` (the same call over copies of its
    weights, :func:`copies_past_l2`), after a warm-up call of the first
    two (which builds the kernel and sets its shared-memory limit).  On
    the card: ``reps`` calls cycling over ``fns``, queued back to back
    behind a sleep (so the host enqueues them while the card is busy) and
    bracketed by two CUDA events, as a graph replay runs a step's kernels;
    device time over ``reps``.  The calls go in windows of at most
    ``CALLS_PER_WINDOW``, each behind its own sleep, so the host never
    fills the launch queue and waits there for the sleep to end.  Where a
    sleep ended before the host had queued the window's last call (the
    host fell behind: a busy core, a stall), the card may have idled
    between calls, so that window is timed again behind twice the sleep,
    which the later windows keep, up to ``TIME_ATTEMPTS`` times; the
    least is kept (an idle gap only adds).  On the CPU: the best wall
    time of ``reps`` calls of ``fns[0]``."""
    for f in fns[:2]:
        f()
    reps = max(reps, 1)
    if device.type != "cuda":
        best = math.inf
        for _ in range(reps):
            t0 = time.perf_counter()
            fns[0]()
            best = min(best, time.perf_counter() - t0)
        return best
    global time_call_retries
    sleep_per_call = SLEEP_CYCLES_PER_CALL
    total_ms = 0.0
    collecting = gc.isenabled()
    for lo in range(0, reps, CALLS_PER_WINDOW):
        hi = min(reps, lo + CALLS_PER_WINDOW)
        best_ms = math.inf
        for attempt in range(TIME_ATTEMPTS):
            torch.cuda.synchronize(device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            gc.disable()  # no collection while the calls are queued
            try:
                torch.cuda._sleep((hi - lo) * sleep_per_call)
                start.record()
                for i in range(lo, hi):
                    fns[i % len(fns)]()
                end.record()
                covered = not start.query()  # still asleep: no gap
            finally:
                if collecting:
                    gc.enable()
            end.synchronize()
            best_ms = min(best_ms, start.elapsed_time(end))
            if covered or attempt + 1 == TIME_ATTEMPTS:
                break
            time_call_retries += 1
            sleep_per_call *= 2
        total_ms += best_ms
    return total_ms / 1e3 / reps


def profile_gemm(kind: str, m: int, k: int, b: int, *, d: int = 3,
                 scale_block: int | None = None, reps: int = 3,
                 device="cuda", seed: int = 0) -> dict:
    """Time one kernel call on data made with numpy from ``seed`` (codes,
    scales, bf16 x as the engine passes it) and annotate it with the
    analytic cost model (``obs.costs``, the device's row): the time, the
    produce/consume split, bytes moved, and the achieved share of the
    roofline.  ``kind``: 'msgemm' | 'int4'.  Times with
    :func:`time_call` (device time on the card over ``reps`` calls, at
    least two a weight copy; the best of ``reps`` wall times on the CPU),
    observes ``kernel_profile_s`` and returns the annotated row, with the
    partition it was measured in (``device``, ``interpret``: the plain
    version ran), as ``obs.perfmodel.samples_from_bench`` reads it."""
    from repro_torch import obs
    from repro_torch.device import resolve
    from repro_torch.dispatch.plan import device_name
    from repro_torch.obs import costs

    dev = resolve(device)
    sb = scale_block if scale_block is not None else 12 * d
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((k, b)).astype(np.float32)) \
        .to(dev, torch.bfloat16)
    sc = torch.from_numpy((np.abs(rng.standard_normal(
        (m, -(-k // sb)))) + 0.1).astype(np.float32)).to(dev)
    codes = torch.from_numpy(rng.integers(0, 16, size=(m, k))
                             .astype(np.uint8)).to(dev)
    if kind == "msgemm":
        w = packing.pack_indices(codes, d).contiguous()
        call = lambda w: msgemm(w, x, d, scales=sc,  # noqa: E731
                                scale_block=sb)
        quant = "msgemm"
    elif kind == "int4":
        w = packing.pack_storage(codes).contiguous()
        call = lambda w: int4_matmul(w, sc, x, scale_block=sb)  # noqa: E731
        quant = "int4_dequant"
    else:
        raise ValueError(f"kind={kind!r} must be 'msgemm' or 'int4'")
    n = copies_past_l2(w.numel() * w.element_size()) \
        if dev.type == "cuda" else 1
    ws = [w] + [w.clone() for _ in range(n - 1)]
    best = time_call([lambda w=w: call(w) for w in ws], dev,
                     max(reps, 2 * n) if dev.type == "cuda" else reps)
    row = costs.annotate(best, m, k, b, quant=quant, d=d,
                         dev=costs.device(dev.type))
    row.update(kind=kind, scale_block=sb, device=device_name(dev.type),
               interpret=dev.type != "cuda")
    obs.registry().histogram(
        "kernel_profile_s", help="profiled kernel time",
        kind=kind, m=m, k=k, b=b).observe(best)
    return row


def _round_up(v: int, t: int) -> int:
    return -(-v // t) * t


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0, kernel=None) -> torch.Tensor:
    """Multi-head attention through the flash kernel (CUDA tensors) or its
    plain version (CPU tensors).

    q (B, Sq, H, dh), k/v (B, Skv, Hk, dh) with H % Hk == 0 -> (B, Sq, H,
    dh) in q's dtype.  GQA kv heads are not repeated: the kernel maps
    query head h to kv head h // (H // Hk).  Sq and Skv are padded with
    zeros to the lengths the reference pads to, multiples of its TPU tile
    min(128, round_up(S, 8)): under causal masking a query past the last
    key then sees the zero keys up to its own position, as in the
    reference.  The port's kernel tiles (``flash_tiles``) are its own; the
    kernel masks the ragged edge past the padded lengths.  A non-causal
    call needs Skv a multiple of that tile (ValueError otherwise, where the
    reference asserts).  ``kernel``: the native-layout function to run
    (default: by device); checks pass ``flash_attention_plain``."""
    B, Sq, H, dh = q.shape
    Skv, Hk = k.shape[1], k.shape[2]
    if H % Hk:
        raise ValueError(f"{H} query heads do not group onto {Hk} kv heads")
    sqp = _round_up(Sq, min(128, _round_up(Sq, 8)))
    skp = _round_up(Skv, min(128, _round_up(Skv, 8)))
    if not causal and skp != Skv:
        raise ValueError(f"non-causal flash attention needs Skv={Skv} a "
                         f"multiple of its tile (padded length {skp})")
    pad = torch.nn.functional.pad
    qt = pad(q, (0, 0, 0, 0, 0, sqp - Sq)).transpose(1, 2).contiguous()
    kt = pad(k, (0, 0, 0, 0, 0, skp - Skv)).transpose(1, 2).contiguous()
    vt = pad(v, (0, 0, 0, 0, 0, skp - Skv)).transpose(1, 2).contiguous()
    o = (kernel or _fa.flash_attention)(
        qt, kt, vt, causal=causal, window=window, softcap=softcap)
    return o.transpose(1, 2)[:, :Sq]
