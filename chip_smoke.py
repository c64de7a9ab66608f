#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase, as on the card
    python3 chip_smoke.py --profile  # also profile an engine run

Phases, any failure exits non-zero before the last line is printed:

1. build   — compile ``kernels/csrc/msgemm.cu`` for sm_90a from the checkout.
2. kernels — the msGeMM kernel against its plain PyTorch version on the
   card at every gemma-2b GeMM shape (b = 1, 4, 8) with each shape's own
   epilogue and the operands as the engine passes them (x and residual
   transposed views of the (b, .) activations, bfloat16 output), a
   vocab-sized (256000 x 2048) GeMM, and small d = 1, 2, 4 and
   learned-codebook cases with contiguous operands.  Bit-exact on exact inputs (integer activations,
   power-of-two scales); rtol = atol = 1e-5 on random floats (the two share
   one op order, so only gelu/silu's tanh/exp may differ).  Each case is
   timed: kernel, plain version, one torch.matmul on the dequantized weight
   (a yardstick only) and the least time the card could take.
3. main    — full-width gemma-2b with random weights from a seed, quantized
   on the card (msgemm, d=3, scale_block=36), served by the continuous
   engine with the serve CLI's defaults (4 slots, block 8, prefill chunk 8)
   on 6 requests of 4-16 prompt tokens and 16 new tokens.  Every request
   must finish, match the static ``generate`` path token for token, and the
   kernel's launch count must be exactly 126 (7 GeMMs x 18 layers) per step.
4. report  — the card's name and power limit, then a ``kernels`` JSON line.

The last line is ``{"ok": true, "device": {...}}``.  Details go to
``chiprun_out/chip_smoke.json``.  Needs no network; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
F32_OPS_PER_S = 67e12      # H100 SXM float32 outside the tensor cores
FLOAT_TOL = dict(rtol=1e-5, atol=1e-5)
L2_BYTES = 50 * 2**20
L2_FLUSH_BYTES = 120 * 2**20  # cycle index copies past the L2
MAX_COPIES = 256


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


# ----------------------------------------------------------------- timing
def device_ms(fns, reps: int) -> float:
    """Device time per call, cycling over ``fns``.  A long ``_sleep`` is
    queued first so the host enqueues every call while the card is busy:
    the events then bracket back-to-back kernels, not host gaps."""
    import torch

    for f in fns[:2]:
        f()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(reps * 200e-6 * 2e9))
    start.record()
    for i in range(reps):
        fns[i % len(fns)]()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def wall_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


# ----------------------------------------------------------------- phase 2
def work(m, k, b, d, sb, has_bias, has_res, out_bytes):
    """(bytes, ops) the function needs: each input read once, the output
    written once; per chunk and column the LUT's 16·d distinct products
    and one add per entry of each length 2..d (entries that share a prefix
    share its sum), one gather-add per (row, chunk, column), one
    multiply-add per (row, scale block, column), the epilogue's adds."""
    kc, nsb = -(-k // d), -(-k // sb)
    nbytes = (m * kc * 4 + m * nsb * 4 + k * b * 4 + 16 * 4 + m * b * out_bytes
              + (m * 4 if has_bias else 0) + (m * b * 4 if has_res else 0))
    produce = 16 * d + sum(16**i for i in range(2, d + 1))
    ops = (produce * kc * b + m * kc * b + 2 * m * nsb * b
           + m * b * (int(has_bias) + int(has_res)))
    return nbytes, ops


def kernel_case(name, m, k, b, *, d=3, sb=36, act="none", bias=False,
                residual=False, codebook=False, out_dtype=None,
                engine_layout=False, seed=0):
    """One kernel-vs-plain case.  ``engine_layout``: x (k, b) and the
    residual (m, b) are transposed views of (b, k) and (b, m) buffers, as
    ``backends.run_msgemm_cuda`` passes the model's activations."""
    import torch

    from repro_torch.core import packing
    from repro_torch.kernels import msgemm as ms
    from repro_torch.kernels import ops

    out_dtype = out_dtype or torch.float32
    g = torch.Generator(device="cuda").manual_seed(seed)
    kc, nsb = -(-k // d), -(-k // sb)
    codes = torch.randint(0, 16, (m, k), generator=g, device="cuda",
                          dtype=torch.uint8)
    idx = packing.pack_indices(codes, d).contiguous()
    if codebook:
        values = torch.cat([torch.zeros(1, device="cuda"), torch.sort(
            torch.rand(15, generator=g, device="cuda") * 14 - 7).values])
    else:
        values = packing.b_values(torch.float32, "cuda")
    tiles = ops.msgemm_tiles(m, kc, b, d, sb)
    result = dict(name=name, m=m, k=k, b=b, d=d, scale_block=sb, act=act,
                  bias=bias, residual=residual, codebook=codebook,
                  out_dtype=str(out_dtype).removeprefix("torch."),
                  engine_layout=engine_layout, tiles=list(tiles))
    # kernel and plain version share one op order: exact everywhere but in
    # gelu/silu's tanh/exp, and then within one ulp of the output type
    tol = FLOAT_TOL if out_dtype == torch.float32 else dict(rtol=2**-7,
                                                            atol=1e-5)
    def cols(rows, draw):
        """A (rows, b) operand, in the engine's layout when asked."""
        return draw(b, rows).t() if engine_layout else draw(rows, b)

    for exact in (True, False):
        if exact:
            sc = 2.0 ** torch.randint(-2, 3, (m, nsb), generator=g,
                                      device="cuda").float()
            rnd = lambda *s: torch.randint(  # noqa: E731
                -4, 5, s, generator=g, device="cuda").float()
        else:
            sc = torch.rand((m, nsb), generator=g, device="cuda") + 0.1
            rnd = lambda *s: torch.randn(  # noqa: E731
                s, generator=g, device="cuda")
        x = cols(k, rnd)
        kw = dict(d=d, scale_block=sb, tiles=tiles, act=act,
                  bias=rnd(m) if bias else None,
                  residual=cols(m, rnd) if residual else None,
                  out_dtype=out_dtype)
        got = ms.msgemm_cuda(idx, x, sc, values, **kw)
        torch.cuda.synchronize()
        want = ms.msgemm_plain(idx, x, sc, values, **kw)
        err = float((got.float() - want.float()).abs().max())
        if exact and act in ("none", "relu"):
            check(err == 0.0, f"{name}: kernel != plain on exact inputs "
                              f"(max abs err {err})")
        else:
            torch.testing.assert_close(got.float(), want.float(), **tol,
                                       msg=lambda s: f"{name}: {s}")
        result["exact_max_abs_err" if exact else "max_abs_err"] = err
    # timing, on the random-float inputs
    copies = max(1, min(MAX_COPIES,
                        math.ceil(L2_FLUSH_BYTES / (idx.numel() * 4))))
    idxs = [idx] + [idx.clone() for _ in range(copies - 1)]
    result["idx_cycled_bytes"] = copies * idx.numel() * 4
    result["idx_l2_resident"] = result["idx_cycled_bytes"] <= L2_BYTES
    calls = [lambda i=i: ms.msgemm_cuda(i, x, sc, values, **kw) for i in idxs]
    result["ms"] = device_ms(calls, reps=max(20, 2 * copies))
    result["host_ms"] = wall_ms(calls[0], reps=20)
    result["plain_ms"] = wall_ms(
        lambda: ms.msgemm_plain(idx, x, sc, values, **kw), reps=2)
    w = (values[codes.long()] * torch.repeat_interleave(sc, sb, 1)[:, :k])
    wcopies = max(1, min(8, math.ceil(L2_FLUSH_BYTES / (w.numel() * 4))))
    ws = [w] + [w.clone() for _ in range(wcopies - 1)]
    result["library_ms"] = device_ms(
        [lambda w_=w_: torch.matmul(w_, x) for w_ in ws], reps=20)
    del ws, w
    nbytes, nops = work(m, k, b, d, sb, bias, residual,
                        torch.empty((), dtype=out_dtype).element_size())
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, nops / F32_OPS_PER_S * 1e3
    result.update(bytes=nbytes, ops=nops, bound_ms=max(t_bytes, t_ops),
                  bound_by="bytes" if t_bytes >= t_ops else "operations")
    return result


GEMMA_GEMMS = [  # (name, m, k, epilogue kwargs) of one gemma-2b block
    ("wq", 2048, 2048, {}),
    ("wk", 256, 2048, {}),
    ("wv", 256, 2048, {}),
    ("wo", 2048, 2048, dict(residual=True)),
    ("gate", 16384, 2048, dict(act="gelu")),
    ("up", 16384, 2048, {}),
    ("down", 2048, 16384, dict(residual=True)),
]


def phase_kernels():
    import torch

    cases = []
    # the gemma-2b GeMMs as the engine runs them: bf16 model, so bf16 out
    specs = [(n, m, k, b, dict(ep, out_dtype=torch.bfloat16,
                               engine_layout=True))
             for b in (1, 4, 8) for n, m, k, ep in GEMMA_GEMMS if n != "wv"]
    specs += [
        ("vocab", 256000, 2048, 8, {}),
        ("small-d1", 512, 1000, 4, dict(d=1, sb=12, bias=True, act="relu")),
        ("small-d2", 512, 1000, 5, dict(d=2, sb=24, act="silu",
                                        residual=True)),
        ("small-d4", 512, 1000, 4, dict(d=4, sb=48, bias=True)),
        ("small-d4-b1", 100, 300, 1, dict(d=4, sb=48)),
        ("codebook-bf16", 1000, 777, 3,
         dict(codebook=True, act="gelu", bias=True, residual=True,
              out_dtype=torch.bfloat16)),
    ]
    for i, (name, m, k, b, ep) in enumerate(specs):
        t0 = time.perf_counter()
        r = kernel_case(name, m, k, b, seed=i, **ep)
        cases.append(r)
        print(f"[kernels] {name:14s} m={m:6d} k={k:5d} b={b} d={r['d']} "
              f"act={r['act']:4s} kernel={r['ms']:.4f}ms "
              f"host={r['host_ms']:.4f}ms plain={r['plain_ms']:.2f}ms "
              f"matmul={r['library_ms']:.4f}ms bound={r['bound_ms']:.4f}ms "
              f"({r['bound_by']}) err={r['max_abs_err']:.3g} "
              f"exact_err={r['exact_max_abs_err']:.3g} "
              f"[{time.perf_counter() - t0:.1f}s]", flush=True)
    return cases


# ----------------------------------------------------------------- phase 3
def phase_main():
    import torch

    from repro_torch.configs.gemma_2b import CONFIG
    from repro_torch.core.spec import QuantSpec
    from repro_torch.device import generator
    from repro_torch.kernels import msgemm as ms
    from repro_torch.models import transformer
    from repro_torch.quant import quantized_size_bytes
    from repro_torch.runtime import serve as SV
    from repro_torch.serving import Engine, poisson_stream

    spec = QuantSpec(mode="msgemm", d=3, scale_block=36)
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    model = transformer.init_params(CONFIG, generator=generator(0, "cuda"),
                                    device="cuda", quant=spec)
    torch.cuda.synchronize()
    cfg = CONFIG.replace(quant=spec)
    build_s = time.perf_counter() - t0
    print(f"[main] gemma-2b built and quantized on the card in {build_s:.1f}s "
          f"({quantized_size_bytes(model) / 2**30:.2f} GiB of buffers, peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB)", flush=True)

    new, prompt_len = 16, 16
    reqs = poisson_stream(6, cfg.vocab_size, max_new_tokens=new, rate=50.0,
                          min_prompt=prompt_len // 4, max_prompt=prompt_len,
                          seed=0)
    engine = Engine(model, cfg, max_slots=4, block_size=8, prefill_chunk=8,
                    max_model_len=prompt_len + new)
    ms.launches = 0
    t0 = time.perf_counter()
    results = engine.run(reqs)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = ms.launches
    steps = engine.num_steps
    check(launches == 126 * steps and steps > 0,
          f"kernel launches {launches} != 126 x {steps} engine steps")
    check(sorted(results) == list(range(len(reqs))),
          f"finished {sorted(results)} of {len(reqs)} requests")
    for rid, seq in sorted(results.items()):
        check(seq.status == "ok" and len(seq.generated) == new,
              f"request {rid}: status {seq.status}, "
              f"{len(seq.generated)} tokens")
    s = engine.metrics()
    print(f"[main] served {len(results)} requests, {s['generated_tokens']} "
          f"tokens in {run_s:.2f}s over {steps} steps "
          f"({s['prefill_steps']} prefill, {s['decode_steps']} decode): "
          f"{s['tok_per_s']:.1f} tok/s, latency p50 "
          f"{s['latency_p50_s'] * 1e3:.1f}ms p95 "
          f"{s['latency_p95_s'] * 1e3:.1f}ms; msgemm launches {launches}",
          flush=True)

    for rid, seq in sorted(results.items()):
        toks = torch.tensor([seq.req.prompt], dtype=torch.int32,
                            device="cuda")
        ref = SV.generate(model, cfg, toks, max_new_tokens=new)
        check([int(t) for t in ref[0]] == seq.generated,
              f"request {rid}: engine tokens {seq.generated} != static "
              f"{[int(t) for t in ref[0]]}")
    with torch.no_grad():
        toks = torch.tensor([reqs[0].prompt], dtype=torch.int32,
                            device="cuda")
        logits = transformer.forward(model, cfg, toks)
    check(tuple(logits.shape) == (1, len(reqs[0].prompt), cfg.vocab_size)
          and bool(torch.isfinite(logits).all()),
          f"forward logits {tuple(logits.shape)} not finite/expected")
    print("[main] engine tokens == static generate for every request; "
          "forward logits finite", flush=True)
    return dict(build_s=build_s, run_s=run_s, steps=steps,
                launches=launches, metrics=s,
                tokens={rid: seq.generated for rid, seq in results.items()},
                model=model, cfg=cfg)


def phase_profile(model, cfg):
    """Where an engine step's time goes: the same request stream, all
    arriving at once, under torch.profiler; device time by kernel name
    and the device's busy share of the wall time (profiler on, so the
    host side is slower than unprofiled)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving import Engine, poisson_stream

    reqs = poisson_stream(6, cfg.vocab_size, max_new_tokens=16, rate=0.0,
                          min_prompt=4, max_prompt=16, seed=1)
    engine = Engine(model, cfg, max_slots=4, block_size=8, prefill_chunk=8,
                    max_model_len=32)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.run(reqs)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    # device-side events only (kernels, copies): a CPU op's device time
    # would count its kernels a second time
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    check(busy_ms > 0, "profiler saw no device time")
    out = dict(wall_ms=wall_s * 1e3, device_busy_ms=busy_ms,
               busy_share=busy_ms / (wall_s * 1e3), steps=engine.num_steps,
               prefill_steps=engine.num_prefill_steps,
               top=[dict(name=n[:120], device_ms=t, count=c)
                    for n, t, c in rows[:12]])
    print(f"[profile] {engine.num_steps} steps in {wall_s * 1e3:.1f}ms wall, "
          f"device busy {busy_ms:.1f}ms ({out['busy_share']:.1%})")
    for r in out["top"]:
        print(f"[profile]   {r['device_ms']:9.3f}ms x{r['count']:5d} "
              f"{r['name'][:90]}")
    return out


# ------------------------------------------------------------------- main
def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile an engine run (torch.profiler)")
    args = ap.parse_args()
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.kernels import msgemm as ms
    except ImportError as e:
        print(f"chip_smoke: run from a checkout of the repository ({e})",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    t0 = time.perf_counter()
    lib = ms.build(verbose=True)
    build_s = time.perf_counter() - t0
    print(f"[build] {lib.name} in {build_s:.1f}s", flush=True)

    cases = phase_kernels()
    main_path = phase_main()
    model, cfg = main_path.pop("model"), main_path.pop("cfg")
    if args.profile:
        main_path["profile"] = phase_profile(model, cfg)
    del model

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        else f"nvidia-smi failed: {smi.stderr.strip()}"

    # the JSON line's numbers: one gemma-2b layer's seven GeMMs at the
    # engine's decode shape (b = max_slots = 4), summed
    layer = [c for c in cases if c["b"] == 4 and c["name"] in
             {n for n, *_ in GEMMA_GEMMS}]
    layer += [dict(c, name="wv") for c in layer if c["name"] == "wk"]
    tot = {key: sum(c[key] for c in layer)
           for key in ("ms", "plain_ms", "library_ms", "bytes", "ops")}
    t_bytes = tot["bytes"] / HBM_BYTES_PER_S * 1e3
    t_ops = tot["ops"] / F32_OPS_PER_S * 1e3
    kernels = [{
        "name": "msgemm", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/msgemm.cu",
        "replaces": "src/repro/kernels/msgemm.py:252",
        "launches": main_path["launches"],
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "ms": tot["ms"], "plain_ms": tot["plain_ms"],
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": tot["library_ms"],
        "shape": "sum of one gemma-2b layer's 7 GeMMs at b=4",
    }]
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(dict(
        card=card, build_s=build_s, cases=cases, main=main_path,
        kernels=kernels, total_s=time.perf_counter() - t_start), indent=1))
    print(f"[report] total {time.perf_counter() - t_start:.1f}s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
