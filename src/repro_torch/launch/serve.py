"""Serving entry point of the port: build a model from a seed, quantize its
weights for msGeMM (or int4-dequant, or keep them dense) on the device,
and serve generation; port of repro.launch.serve.

Two engines:

* ``--engine static``      fixed-shape batched prefill + decode
  (runtime.serve.generate);
* ``--engine continuous``  the continuous-batching engine over the paged
  KV pool (repro_torch.serving), driven by a simulated Poisson stream of
  mixed-length requests; ``--check`` holds every request's tokens to the
  static path's.

On the card (the default device):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2_9b \\
        --quant msgemm --engine continuous --check

and on the CPU at smoke width:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma_2b \\
        --smoke --device cpu --engine continuous --check

The continuous engine runs each step shape as a captured CUDA graph on the
card; ``--no-cuda-graph`` runs the same step eagerly, for comparison.
Observability as in the reference: ``--metrics-json PATH`` writes the
registry snapshot on exit, ``--trace-out PATH`` turns tracing on before
the model is built (the graphs record the device marks staged at their
capture) and writes Chrome-trace JSON on exit, ``--prom-port N`` serves
``/metrics`` for the run.  Both files validate with
``repro_torch.obs.validate_snapshot_file`` / ``validate_trace_file``.

Execution planning as in the reference: ``--backend NAME`` forces a
registered GeMM backend through ``dispatch.ExecPolicy`` (linears whose
weights it cannot run fall back to auto-selection), ``--autotune[=model|
full]`` times the Hopper kernels' tile choices for every GeMM key the
engine's two step shapes (or the static path's) will request and serves
the winners, persisted to ``--autotune-cache PATH`` (default
``$REPRO_PLAN_CACHE``, else the user cache directory).  ``--check`` runs
the static path under the same policy and cache.
``--check-regressions`` turns tracing on, and after the run prices every
``kernel_gemm_s`` series with the perf model of ``--calibration PATH``
(``python -m repro_torch.obs --calibrate``): exit 1 when a kernel ran
slower than 3x its prediction; without a calibration of this device's
partition it skips with a note.

Resilience as in the reference (continuous engine): ``--max-queue N``
sheds submissions beyond that queue depth, ``--deadline-s`` and
``--ttft-deadline-s`` set default SLOs (expired requests are cancelled),
``--watchdog`` times every step and escalates a hang to a backend
quarantine and replan, and ``--faults SPEC --fault-seed N`` arms
deterministic fault injection (``repro_torch.faults``; without
``--faults`` the plan comes from ``REPRO_FAULTS`` / ``REPRO_FAULT_SEED``
when set).  A run with sheds, cancellations, retries or replans prints a
``resilience:`` line, and ``--check`` skips the requests that did not
finish.

Tensor-parallel serving: ``--mesh model=2`` (or ``model=2,data=2``) serves
either engine over a device mesh, one process a mesh device
(``launch.mesh.run_ranks``), each rank on its own card (``cuda:<rank>``)
holding its shard of the weights and of the pool or cache; global rank 0
prints.
A mesh larger than the visible cards is refused, unless
``--force-host-devices N`` allows N CPU ranks (with ``--device cpu``):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma_2b \
        --smoke --device cpu --engine continuous --check \
        --mesh model=2,data=2 --force-host-devices 4

``--mesh-rules`` picks the logical-axis rules ('serve', 'serve_tp'),
``--shard-collective`` how row-parallel linears meet ('psum',
'reduce_scatter'), ``--shard-pipeline`` their contraction chunks and
``--shard-impl`` the collective ('xla': the group's own, 'ring';
``--shard-pipeline 0`` tunes both for each row-parallel linear at build,
``dispatch.autotune.tune_shard_variants``, and replays the cached
winners).  ``--mesh-rules default`` stores the weights FSDP-style as
well: each rank keeps its 'data' block of every leaf whose model dim
takes 'data', gathered a block at a time for each step.  The
run prints ``[serve] mesh {...}: N plans resolved at build, M sharded``.
``--engine continuous`` serves decoders ('attn', 'local' and 'moe'
blocks) on a mesh; ``--engine static`` every family (static
``generate``, SPMD over the ranks: the rows split over 'data', rank 0's
tokens the run's; ``--check`` holds them to a single-device ``generate``
of the same weights).

Every ported architecture serves (``repro_torch.configs.ARCHS``: the
gemma, codeqwen1.5, starcoder2 and gpt3 dense models, the qwen2-moe and
llama4-maverick MoE models, whose experts run the int4 kernel in one
launch a projection, and the recurrent jamba-v0.1 (Mamba, attention and
MoE) and xlstm-1.3b (mLSTM, sLSTM), the encoder-decoder whisper-medium
and phi-3-vision-4.2b, with stub frontends).  The recurrent, enc-dec and
vision models serve through ``--engine static`` only: the paged pool
holds decoder K/V of plain token streams, so ``--engine continuous``
raises NotImplementedError for them, as in the reference.  Their static
run draws its stub inputs from ``--seed`` after the prompts, as the
reference does: 16 frames (B, 16, d_model) for whisper, ``num_patches``
patch embeddings for phi-3-vision.
The build line gives the weights' GiB and the build's peak; a MoE
model's run also prints ``dropped_frac``, the share of routed (token,
expert) slots past capacity over the run (pads and idle rows included).
``--check`` holds the continuous engine to static ``generate``: a MoE
model may legitimately differ where capacity drops differ (a prefill
chunk's pads take capacity), as in the reference.
``--num-layers N`` cuts the depth (the widths stay the config's), for
models whose full depth does not fit one card.

``--kv-bits 4 --kv-codebook learned`` fits the pool's 16-entry table once,
from the model's own K/V on a seeded batch (``repro_torch.kvq.fit``), and
prints it; at 16 and 8 bits the flag is ignored with a note, as in the
reference.

``--backend`` takes the registry's names.  A paged-attention backend
(``paged_attn_torch``, ``paged_attn_cuda``) forces the route of a
quantized KV pool.

:func:`main` returns what it ran (model, config, build and run figures,
kernel launches over the engine's run), so a script can drive it in
process.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

import torch

from repro_torch import configs, dispatch, faults, obs
from repro_torch.core.spec import QuantSpec
from repro_torch.device import generator, resolve
from repro_torch.kernels.ops import KERNELS, launch_counts
from repro_torch.kvq import KVQuantSpec
from repro_torch.kvq import attention as kv_attention
from repro_torch.models import moe as M
from repro_torch.models import transformer as T
from repro_torch.quant import quantized_size_bytes
from repro_torch.runtime import serve as SV


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def quant_spec(args) -> QuantSpec | None:
    """--quant/--d -> the weights' QuantSpec (None: dense).  int4 weights
    are stored two codes a byte, as the int4 kernel reads them."""
    if args.quant == "bf16":
        return None
    storage = "packed_u8" if args.quant == "int4_dequant" else "packed_idx"
    return QuantSpec(mode=args.quant, d=args.d, scale_block=12 * args.d,
                     storage=storage)


def build_model(args, device: torch.device, mesh=None):
    """Random weights from ``--seed``, drawn and quantized block by block
    on ``device`` (no more than one block's dense weights at a time);
    with ``mesh``, this rank's copy for ``--mesh-rules``, each block cut
    as soon as it is drawn (``runtime.serve.init_shard``: the whole model
    never exists).  Returns (params, cfg, figures)."""
    cfg = (configs.get_smoke(args.arch) if args.smoke
           else configs.get_config(args.arch))
    if args.num_layers:
        cfg = cfg.replace(num_layers=args.num_layers)
    spec = quant_spec(args)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    if mesh is None:
        params = T.init_params(cfg, generator=generator(args.seed, device),
                               device=device, quant=spec)
    else:
        params = SV.init_shard(cfg, mesh, args.mesh_rules,
                               generator=generator(args.seed, device),
                               device=device, quant=spec)
    _sync(device)
    build_s = time.perf_counter() - t0
    if spec is not None:
        cfg = cfg.replace(quant=spec)
    size = quantized_size_bytes(params)
    figures = dict(build_s=build_s, buffer_bytes=size)
    peak = ""
    if device.type == "cuda":
        figures["build_peak_bytes"] = torch.cuda.max_memory_allocated(device)
        peak = f", peak {figures['build_peak_bytes'] / 2**30:.2f} GiB"
    print(f"[serve] {cfg.name} ({cfg.num_layers} layers, d_model "
          f"{cfg.d_model}) built with {args.quant} weights on {device}"
          + ("" if mesh is None else " (this rank's copy)") + " in "
          f"{build_s:.1f}s: {size / 2**30:.2f} GiB of buffers{peak}",
          flush=True)
    return params, cfg, figures


def backends_from_args(args):
    """--backend -> the paged-attention backend to force (or None); a GeMM
    backend reaches the linears through :func:`exec_policy`."""
    if args.backend == "auto" or gemm_backend(args) is not None:
        return None
    if args.kv_bits == 16:
        raise SystemExit(f"--backend {args.backend} routes a quantized KV "
                         "pool: pass --kv-bits 8 or 4")
    return args.backend


def gemm_backend(args) -> str | None:
    """--backend when it names a GeMM backend, else None."""
    if args.backend == "auto" or "paged_attn" in dispatch.get_backend(
            args.backend).modes:
        return None
    return args.backend


def exec_policy(args) -> dispatch.ExecPolicy | None:
    """The CLI's execution choices as an ExecPolicy (None: defaults)."""
    backend = gemm_backend(args)
    if backend is None and not args.autotune and (
            args.shard_collective, args.shard_pipeline,
            args.shard_impl) == ("psum", 1, "xla"):
        return None
    return dispatch.ExecPolicy(backend=backend, autotune=args.autotune,
                               shard_collective=args.shard_collective,
                               shard_pipeline=args.shard_pipeline,
                               shard_impl=args.shard_impl)


def check_run_regressions(args, device: torch.device) -> dict | None:
    """The perf-model regression sentinel over this run's ``kernel_gemm_s``
    series (``obs.perfmodel``).  SystemExit when a kernel ran slower than
    the tolerance allows; a missing calibration, or one of another
    partition (device, plain version or kernel), skips with a note.
    Returns the report, None when skipped."""
    from repro_torch.obs import perfmodel as pm

    dev, interpret = pm.current_partition(device.type)
    cal = pm.load_calibration(args.calibration, device=dev,
                              interpret=interpret)
    if cal is None:
        path = args.calibration or pm.default_calibration_path()
        print(f"[serve] check-regressions: no calibration of partition "
              f"({dev}, interpret={interpret}) at {path}; skipped "
              "(python -m repro_torch.obs --calibrate)", file=sys.stderr)
        return None
    report = pm.check_regressions(
        pm.samples_from_registry(device_type=device.type), cal)
    print(pm.render_report(report))
    if not report["n_samples"]:
        print("[serve] check-regressions: no kernel_gemm_s samples "
              "recorded", file=sys.stderr)
    elif not report["ok"]:
        raise SystemExit(
            f"[serve] check-regressions: {report['n_outliers']} kernel "
            f"timing(s) exceeded {report['tolerance']:g}x the model "
            "prediction")
    return report


def warm_generate(params, cfg, batch, policy, *, mesh=None,
                  rules: str = "serve") -> dict:
    """Resolve the plans static ``generate`` on ``batch`` will request:
    one prefill and one decode step under ``dispatch.collecting()``
    enumerate the keys, which ``dispatch.warm`` tunes or looks up (on
    ``mesh``, every rank with its ``shard_params`` copy: the ranks tune
    together, the collective layouts too under ``shard_pipeline`` 0)."""
    from repro_torch.distributed import sharding

    with dispatch.collecting() as reqs, dispatch.using_policy(policy):
        SV.generate(params, cfg, batch, max_new_tokens=2, mesh=mesh,
                    rules=rules)
    if mesh is None:
        return dispatch.warm(reqs, policy=policy)
    with sharding.use(mesh, rules):
        return dispatch.warm(reqs, policy=policy)


STUB_FRAMES = 16  # the reference CLI's encoder frames for an enc-dec model


def static_batch(args, cfg, device: torch.device) -> dict:
    """The static run's inputs from ``--seed``: prompts (batch,
    prompt_len), then the stub frontend's embeddings from the same
    generator, frames (batch, 16, d_model) for an enc-dec config or
    patch embeddings (batch, num_patches, d_model) for a vision one."""
    g = generator(args.seed, device)
    batch = {"tokens": torch.randint(
        0, cfg.vocab_size, (args.batch, args.prompt_len), generator=g,
        device=device, dtype=torch.int32)}
    if cfg.is_encdec:
        batch["frames"] = torch.randn((args.batch, STUB_FRAMES, cfg.d_model),
                                      generator=g, device=device)
    elif cfg.frontend == "image_patches":
        batch["patch_embeds"] = torch.randn(
            (args.batch, cfg.num_patches, cfg.d_model), generator=g,
            device=device)
    return batch


def run_static(args, params, cfg, device: torch.device, mesh=None):
    """Batched greedy generation on random inputs from ``--seed``
    (:func:`static_batch`).  Kernel launches are counted over
    ``generate`` alone (not the autotuner's warm-up).  On ``mesh`` this
    rank serves ``params``, its copy (:func:`build_model`), or its shard
    of a whole ``params`` (``runtime.serve.shard_params``) under
    ``--mesh-rules``, and the collectives are counted too; with
    ``--check`` rank 0 holds the tokens to a single-device ``generate``
    of the whole model, drawn after the run (:func:`whole_model`)."""
    batch = static_batch(args, cfg, device)
    policy = exec_policy(args)
    if policy is not None and policy.autotune and mesh is None:
        plans = warm_generate(params, cfg, batch, policy)
        print(f"[serve] resolved {len(plans)} exec plans before the run "
              f"(cache={dispatch.cache().path})")
    run_params, kw = params, {}
    if mesh is not None:
        from repro_torch.distributed import collectives as coll

        if getattr(params, "served_on", None) is None:
            run_params = SV.shard_params(params, cfg, mesh, args.mesh_rules)
        kw = dict(mesh=mesh, rules=args.mesh_rules)
        if policy is not None:
            plans = warm_generate(run_params, cfg, batch, policy, **kw)
            print(f"[serve] resolved {len(plans)} exec plans on the mesh "
                  "before the run", flush=True)
        coll.reset_counts()
    M.reset_route_counts(params)
    before = launch_counts()
    t0 = time.perf_counter()
    out = SV.generate(run_params, cfg, batch, max_new_tokens=args.new_tokens,
                      **kw)
    _sync(device)
    dt = time.perf_counter() - t0
    after = launch_counts()
    launches = {name: after[name] - before[name] for name in KERNELS}
    print(f"[serve] generated {tuple(out.shape)} in {dt:.2f}s "
          f"({args.batch * args.new_tokens / dt:.1f} tok/s); launches "
          f"{launches}")
    print(out[:, :12].tolist())
    res = dict(prompts=batch["tokens"], batch=batch, tokens=out, run_s=dt,
               launches=launches, dropped_frac=report_dropped(params))
    if mesh is not None:
        from repro_torch.distributed import collectives as coll
        from repro_torch.distributed.compat import axes_of

        res["collectives"] = dict(coll.counts)
        print(f"[serve] mesh {axes_of(mesh)}: static generate, collectives "
              f"{dict(sorted(coll.counts.items()))} (rules="
              f"{args.mesh_rules})", flush=True)
        if args.check and torch.distributed.get_rank() == 0:
            ref = SV.generate(whole_model(args, params, device), cfg, batch,
                              max_new_tokens=args.new_tokens)
            same = torch.equal(ref, out)
            print(f"[serve] single-device parity check: "
                  f"{'identical' if same else 'DIFFERENT'}", flush=True)
            if not same:
                raise SystemExit("the mesh's static generate diverged from "
                                 "the single-device one")
            res["checked"] = args.batch
    return res


def whole_model(args, params, device: torch.device):
    """``params`` when it is the whole model, else the whole model drawn
    from ``--seed`` (a rank's copy is none: the check's single-device
    reference is drawn after the mesh run)."""
    if getattr(params, "served_on", None) is None:
        return params
    return build_model(args, device)[0]


def report_dropped(params) -> float | None:
    """Print and return a MoE model's dropped_frac since the counters'
    last reset (None, and nothing printed, for a dense model)."""
    frac = M.dropped_frac(params)
    if frac is not None:
        print(f"[serve] moe dropped_frac over the run: {frac:.6f}",
              flush=True)
    return frac


def make_request_stream(args, cfg):
    """Mixed-length prompts with Poisson (exponential inter-arrival)
    timing, deterministic in --seed."""
    from repro_torch.serving import poisson_stream

    return poisson_stream(args.num_requests, cfg.vocab_size,
                          max_new_tokens=args.new_tokens,
                          rate=args.arrival_rate,
                          min_prompt=max(1, args.prompt_len // 4),
                          max_prompt=args.prompt_len, seed=args.seed)


def kv_spec_from_args(args, params, cfg, kv_backend=None
                      ) -> KVQuantSpec | None:
    """--kv-bits/--kv-codebook -> KVQuantSpec (None at 16 bits), with the
    forced attention backend if any.  A learned codebook is fitted here,
    once, from the model's own K/V activations on a batch drawn from
    ``--seed`` (repro_torch.kvq.fit)."""
    if args.kv_bits == 16:
        if args.kv_codebook == "learned":
            print("[serve] --kv-codebook learned ignored at --kv-bits 16")
        return None
    codebook = None
    if args.kv_codebook == "learned":
        if args.kv_bits != 4:
            print("[serve] --kv-codebook learned ignored at --kv-bits 8 "
                  "(codebooks are a 4-bit construct)")
        else:
            from repro_torch import kvq

            codebook = kvq.fit_kv_codebook(params, cfg, seed=args.seed,
                                           device=args.device)
            print("[serve] fitted 16-entry KV codebook from model "
                  "activations: "
                  + " ".join(f"{v:.4f}" for v in codebook), flush=True)
    return KVQuantSpec(bits=args.kv_bits, codebook=codebook,
                       backend=kv_backend)


def check_static(results, params, cfg, device: torch.device,
                 policy=None) -> int:
    """Every finished request's tokens == static ``generate`` on its
    prompt, under ``policy`` (the engine's: a tuned plan can change the
    last bits); SystemExit otherwise.  Returns the number checked."""
    live = {rid: seq for rid, seq in results.items() if seq.status == "ok"}
    bad = []
    for rid, seq in sorted(live.items()):
        prompt = torch.tensor([list(seq.req.prompt)], dtype=torch.int32,
                              device=device)
        with dispatch.using_policy(policy):
            ref = SV.generate(params, cfg, prompt,
                              max_new_tokens=seq.req.max_new_tokens)
        if [int(t) for t in ref[0]] != seq.generated:
            bad.append(rid)
    print(f"[serve] static-path parity check: {len(live) - len(bad)}/"
          f"{len(live)} identical ({len(results) - len(live)} non-ok "
          "skipped)", flush=True)
    if bad:
        raise SystemExit(f"continuous engine diverged from the static path "
                         f"on requests {bad}")
    return len(live)


def run_continuous(args, params, cfg, device: torch.device, kv_backend=None,
                   mesh=None, kv_spec=None):
    """Serve the request stream through the continuous engine (on ``mesh``
    when given: this rank's engine, on ``params`` its copy or the whole
    model).  ``kv_spec``: the pool's, where the caller has it (a learned
    codebook fitted on the whole model), else from the flags.  Kernel
    launches are counted over the engine's run alone (not the check;
    on a mesh rank 0 checks, on the whole model drawn after the run)."""
    from repro_torch.serving import Engine

    if kv_spec is None:
        kv_spec = kv_spec_from_args(args, params, cfg, kv_backend)
    if kv_spec is not None:
        print(f"[serve] quantized KV cache: {kv_spec.describe()}, attention "
              f"through {kv_attention.select(kv_spec, device.type)}")
    engine = Engine(params, cfg, max_slots=args.max_slots,
                    block_size=args.block_size,
                    num_blocks=args.num_blocks or None,
                    max_model_len=args.prompt_len + args.new_tokens,
                    prefill_chunk=args.prefill_chunk, kv_quant=kv_spec,
                    kv_pool_bytes=(int(args.kv_pool_mib * 2**20)
                                   if args.kv_pool_mib else None),
                    cuda_graph=False if args.no_cuda_graph else None,
                    backend=gemm_backend(args), autotune=args.autotune,
                    autotune_cache=args.autotune_cache,
                    max_queue=args.max_queue or None,
                    deadline_s=args.deadline_s or None,
                    ttft_deadline_s=args.ttft_deadline_s or None,
                    watchdog=args.watchdog or None, mesh=mesh,
                    mesh_rules=args.mesh_rules,
                    shard_collective=args.shard_collective,
                    shard_pipeline=args.shard_pipeline,
                    shard_impl=args.shard_impl)
    reqs = make_request_stream(args, cfg)
    print(f"[serve] continuous engine: {len(reqs)} requests, prompt lens "
          f"{sorted(len(r.prompt) for r in reqs)}, rate="
          f"{args.arrival_rate or 'inf'} req/s, block_size="
          f"{args.block_size}, slots={args.max_slots}, prefill chunk "
          f"{args.prefill_chunk}, step "
          f"{'CUDA graphs' if engine.runner.cuda_graph else 'eager'}",
          flush=True)
    if mesh is not None:
        from repro_torch.distributed.compat import axes_of
        from repro_torch.launch.mesh import mesh_devices

        n_sharded = sum(1 for p in engine.exec_plans.values()
                        if p.shard is not None)
        print(f"[serve] mesh {axes_of(mesh)}: {len(engine.exec_plans)} "
              f"plans resolved at build, "
              f"{n_sharded} sharded (rules={args.mesh_rules}, collective="
              f"{args.shard_collective}, {mesh_devices(mesh)} ranks on "
              f"{device.type})", flush=True)
    elif engine.exec_plans:
        tuned = sum(p.source == "autotuned"
                    for p in engine.exec_plans.values())
        print(f"[serve] resolved {len(engine.exec_plans)} exec plans at "
              f"build, {tuned} autotuned (autotune="
              f"{args.autotune or 'off'}, cache={dispatch.cache().path})",
              flush=True)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    before = launch_counts()
    M.reset_route_counts(params)
    t0 = time.perf_counter()
    results = engine.run(reqs)
    _sync(device)
    dt = time.perf_counter() - t0
    after = launch_counts()
    dropped = report_dropped(params)
    launches = {name: after[name] - before[name] for name in KERNELS}
    for rid in sorted(results):
        m = results[rid].metrics()
        print(f"  req {rid}: prompt={m['prompt_tokens']:4d} "
              f"new={m['new_tokens']:3d} status={m['status']} "
              f"ttft={m.get('ttft_s', 0.0) * 1e3:8.1f}ms "
              f"lat={m.get('latency_s', 0.0) * 1e3:8.1f}ms "
              f"tok={results[rid].generated[:8]}")
    s = engine.metrics()
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else None)
    print(f"[serve] {s['generated_tokens']} tokens in {dt:.2f}s over "
          f"{engine.num_steps} steps ({s['prefill_steps']} prefill, "
          f"{s['decode_steps']} decode): {s['tok_per_s']:.2f} tok/s, "
          f"latency p50 {(s['latency_p50_s'] or 0.0) * 1e3:.1f}ms p95 "
          f"{(s['latency_p95_s'] or 0.0) * 1e3:.1f}ms, preemptions "
          f"{s['preemptions']}"
          + ("" if peak is None else f", peak {peak / 2**30:.2f} GiB")
          + f"; launches {launches}", flush=True)
    if s["shed"] or s["cancelled"] or s["step_retries"] or s["replans"]:
        print(f"[serve] resilience: shed={s['shed']} "
              f"cancelled={s['cancelled']} retries={s['step_retries']} "
              f"nan_quarantined={s['nan_quarantined']} "
              f"replans={s['replans']}", flush=True)
    out = dict(results=results, metrics=s, steps=engine.num_steps,
               run_s=dt, launches=launches, kv_spec=kv_spec,
               cuda_graph=engine.runner.cuda_graph,
               exec_plans=engine.exec_plans, dropped_frac=dropped)
    if args.check and (mesh is None or torch.distributed.get_rank() == 0):
        del engine
        out["checked"] = check_static(results,
                                      whole_model(args, params, device),
                                      cfg, device, exec_policy(args))
    return out


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.serve",
        description="Serve a model of the port with msGeMM, int4 or dense "
                    "weights (static or continuous engine).")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--num-layers", type=int, default=0,
                    help="cut the model's depth to N layers (0: the "
                         "config's); the widths stay the config's")
    ap.add_argument("--quant", default="msgemm",
                    choices=["bf16", "int4_dequant", "msgemm"])
    ap.add_argument("--d", type=int, default=3, help="LUT depth (paper d)")
    ap.add_argument("--engine", default="static",
                    choices=["static", "continuous"])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    # continuous-engine knobs
    ap.add_argument("--num-requests", type=int, default=6)
    ap.add_argument("--arrival-rate", type=float, default=50.0,
                    help="mean req/s of the Poisson stream (<=0: all at t=0)")
    ap.add_argument("--max-slots", type=int, default=4)
    ap.add_argument("--block-size", type=int, default=8)
    ap.add_argument("--num-blocks", type=int, default=0,
                    help="KV pool blocks (0: sized to never preempt)")
    ap.add_argument("--prefill-chunk", type=int, default=8)
    # quantized KV cache (repro_torch.kvq; continuous engine only)
    ap.add_argument("--kv-bits", type=int, default=16, choices=[16, 8, 4],
                    help="paged KV pool storage: 16 = full precision, "
                         "8/4 = quantized codes + per-slot scales")
    ap.add_argument("--kv-codebook", default="uniform",
                    choices=["uniform", "learned"],
                    help="4-bit code map; 'learned' fits the table from "
                         "the model's K/V activations (--kv-bits 4)")
    ap.add_argument("--kv-pool-mib", type=float, default=0,
                    help="size the KV pool by a device-byte budget (MiB) "
                         "instead of --num-blocks")
    ap.add_argument("--check", action="store_true",
                    help="assert token parity vs the static generate path")
    # resilience (continuous engine; README §Resilience)
    ap.add_argument("--max-queue", type=int, default=0,
                    help="shed submissions beyond this waiting-queue "
                         "depth (0: unbounded)")
    ap.add_argument("--deadline-s", type=float, default=0,
                    help="default per-request total-latency SLO; expired "
                         "requests are cancelled cleanly (0: none)")
    ap.add_argument("--ttft-deadline-s", type=float, default=0,
                    help="default first-token SLO (0: none)")
    ap.add_argument("--watchdog", action="store_true",
                    help="arm the per-step hang watchdog (hangs escalate "
                         "to a backend quarantine + replan)")
    ap.add_argument("--faults", default=None, metavar="SPEC",
                    help="arm deterministic fault injection: 'all' or "
                         "'cls:p=..,after=..,max=..,mag=..;cls2' "
                         "(classes: repro_torch.faults.CLASSES; overrides "
                         "REPRO_FAULTS)")
    ap.add_argument("--fault-seed", type=int, default=0,
                    help="seed for the injected-fault schedule")
    ap.add_argument("--backend", default="auto",
                    choices=["auto"] + dispatch.backend_names(),
                    help="force a registered backend (see the module's "
                         "docstring)")
    # execution planning (repro_torch.dispatch)
    ap.add_argument("--autotune", nargs="?", const=True, default=False,
                    choices=["model", "full"], metavar="MODE",
                    help="time the kernels' tile choices per GeMM shape and "
                         "persist the winners to the plan cache; the bare "
                         "flag prunes the sweep with the perf model when a "
                         "calibration exists, '=model'/'=full' force the "
                         "pruned/exhaustive sweep")
    ap.add_argument("--autotune-cache", default=None, metavar="PATH",
                    help="plan-cache JSON path (default: REPRO_PLAN_CACHE "
                         "or ~/.cache/msgemm-repro-torch/plans.json)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; there is no fallback")
    # tensor-parallel serving (repro_torch.dispatch.shard over a mesh)
    ap.add_argument("--mesh", default=None,
                    help="serve tensor-parallel over a device mesh, e.g. "
                         "'model=2' or 'model=2,data=2' (continuous "
                         "engine; one process a mesh device)")
    ap.add_argument("--mesh-rules", default="serve",
                    choices=["serve", "default", "serve_tp"],
                    help="logical-axis rule set (distributed.sharding): "
                         "'serve' (weights over 'model', rows over "
                         "'data'), 'default' (the same, the weights also "
                         "stored cut over 'data', FSDP), 'serve_tp' (no "
                         "row split)")
    ap.add_argument("--shard-collective", default="psum",
                    choices=["psum", "reduce_scatter"],
                    help="how row-parallel linears resolve partial sums")
    ap.add_argument("--shard-pipeline", type=int, default=1,
                    help="contraction chunks of a row-parallel linear "
                         "(1: one collective a linear; 0: tune the "
                         "chunks and the collective at build)")
    ap.add_argument("--shard-impl", default="xla", choices=["xla", "ring"],
                    help="the collective: the group's own, or a ring of "
                         "point-to-point hops")
    ap.add_argument("--force-host-devices", type=int, default=0,
                    help="allow a mesh of up to N CPU ranks (--device cpu)")
    ap.add_argument("--no-cuda-graph", action="store_true",
                    help="run the continuous engine's step eagerly instead "
                         "of replaying its captured CUDA graphs")
    # observability (repro_torch.obs): all off by default
    ap.add_argument("--metrics-json", default=None, metavar="PATH",
                    help="write a versioned registry snapshot "
                         "(obs.metrics) on exit")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="enable tracing and write Chrome-trace JSON "
                         "(load at https://ui.perfetto.dev) on exit")
    ap.add_argument("--prom-port", type=int, default=0,
                    help="expose /metrics in Prometheus text format on "
                         "this port for the lifetime of the run")
    ap.add_argument("--check-regressions", action="store_true",
                    help="after the run, compare measured kernel times "
                         "with the calibrated perf model (obs.perfmodel); "
                         "exit 1 on outliers; turns tracing on")
    ap.add_argument("--calibration", default=None, metavar="PATH",
                    help="perf-model calibration.json for "
                         "--check-regressions (default: $REPRO_CALIBRATION "
                         "or the user cache dir)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Run the CLI on ``argv``.  Returns params, cfg, the build figures and
    the run's results."""
    args = parse_args(argv)
    if args.mesh:
        return serve_mesh(args, argv)
    if (args.mesh_rules, args.shard_collective, args.shard_pipeline,
            args.shard_impl, args.force_host_devices) != (
            "serve", "psum", 1, "xla", 0):
        raise SystemExit("--mesh-rules, --shard-* and --force-host-devices "
                         "apply only with --mesh")
    device = resolve(args.device)
    kv_backend = backends_from_args(args)
    if args.faults:
        plan = faults.arm(faults.FaultPlan(faults.parse_spec(args.faults),
                                           seed=args.fault_seed))
        print(f"[serve] fault injection armed: {plan.describe()}")
    else:
        plan = faults.plan_from_env()  # REPRO_FAULTS / REPRO_FAULT_SEED
        if plan is not None:
            print(f"[serve] fault injection armed from env: "
                  f"{plan.describe()}")
    # tracing must be on before the engine captures its step: device marks
    # are staged at capture, so a later enable records host spans only;
    # the sentinel reads the kernel_gemm_s series those marks fill
    if args.trace_out or args.check_regressions:
        obs.enable_tracing(clear=True)
    prom = None
    if args.prom_port:
        prom = obs.serve_prometheus(args.prom_port)
        print(f"[serve] prometheus /metrics on port "
              f"{prom.server_address[1]}")
    try:
        params, cfg, build = build_model(args, device)
        if args.engine == "continuous":
            run = run_continuous(args, params, cfg, device, kv_backend)
        else:
            if args.kv_bits != 16 or args.kv_pool_mib:
                print("[serve] --kv-bits/--kv-pool-mib apply to the paged "
                      "pool only; ignored by --engine static")
            if args.autotune_cache is not None:
                dispatch.set_cache_path(args.autotune_cache)
            with dispatch.using_policy(exec_policy(args)):
                run = run_static(args, params, cfg, device)
        if args.check_regressions:
            _sync(device)
            run["regressions"] = check_run_regressions(args, device)
        return dict(params=params, cfg=cfg, build=build, **run)
    finally:
        if args.trace_out:
            _sync(device)
            obs.tracer().save(args.trace_out)
            obs.disable_tracing()
            print(f"[serve] wrote trace {args.trace_out} "
                  f"({len(obs.tracer().events())} events)")
        elif args.check_regressions:
            obs.disable_tracing()  # it was on for the sentinel only
        if args.metrics_json:
            snap = obs.registry().snapshot(extra={
                "arch": args.arch, "quant": args.quant,
                "engine": args.engine, "backend": args.backend,
                "kv_bits": args.kv_bits, "kv_codebook": args.kv_codebook,
                "no_cuda_graph": args.no_cuda_graph,
                "device": str(device), "autotune": args.autotune,
                # the perf model's partition of this run's kernel series
                "plan_device": dispatch.device_name(device.type),
                "interpret": device.type != "cuda"})
            with open(args.metrics_json, "w") as f:
                json.dump(snap, f, indent=1)
            print(f"[serve] wrote metrics snapshot {args.metrics_json}")
        if prom is not None:
            prom.shutdown()
        if plan is not None:
            faults.disarm()  # the plan was this run's: leave none armed


def serve_mesh(args, argv) -> dict:
    """``--mesh``: check the request in this process, then serve it from
    one process a mesh device; returns rank 0's figures (the run's tokens
    by request id, metrics, launches, plan counts, the check)."""
    from repro_torch.launch import mesh as MS
    from repro_torch.serving.engine import check_mesh_model

    shape, axes = MS.parse_mesh(args.mesh)
    need = math.prod(shape)
    if args.shard_pipeline < 0:
        raise SystemExit(f"--shard-pipeline {args.shard_pipeline}: 0 (tuned) "
                         "or a chunk count")
    cfg = (configs.get_smoke(args.arch) if args.smoke
           else configs.get_config(args.arch))
    if args.engine == "continuous":
        check_mesh_model(cfg)
    MS.force_host_devices(args.force_host_devices)
    dev = torch.device(args.device)
    if args.force_host_devices:
        if dev.type != "cpu":
            raise SystemExit("--force-host-devices starts CPU ranks: pass "
                             "--device cpu")
        have = MS.host_devices()
        devices = ["cpu"] * need
    else:
        have = MS.visible_devices(dev.type)
        devices = [f"cuda:{r}" for r in range(need)]
    if need > have:
        raise SystemExit(
            f"--mesh {args.mesh} needs {need} devices but only {have} are "
            f"visible ({dev.type}); pass --force-host-devices {need} with "
            "--device cpu for CPU ranks")
    from repro_torch.distributed import collectives as coll

    print(f"[serve] starting {need} ranks on {devices} for mesh "
          f"{dict(zip(axes, shape))} (backend: {coll.backend_for(devices)})",
          flush=True)
    out = MS.run_ranks(_mesh_rank, need, argv, shape, axes, devices=devices)
    return out[0]


def _mesh_rank(rank, device, argv, shape, axes) -> dict:
    """One rank of ``--mesh``: build this rank's copy of the model from
    ``--seed`` on its device (:func:`build_model`), serve the stream on
    the mesh (rank 0 prints, checks and reports)."""
    import contextlib
    import io

    from repro_torch.launch import mesh as MS

    args = parse_args(argv)
    args.device = str(device)
    quiet = contextlib.redirect_stdout(io.StringIO()) if rank else \
        contextlib.nullcontext()
    with quiet:
        mesh = MS.make_mesh(shape, axes)
        kv_spec = None
        if args.engine == "continuous" and args.kv_bits == 4 \
                and args.kv_codebook == "learned":
            # the fit runs the whole model: drawn, fitted and freed
            # before the rank's copy is drawn
            whole, cfg, _ = build_model(args, device)
            kv_spec = kv_spec_from_args(args, whole, cfg)
            del whole
        params, cfg, build = build_model(args, device, mesh=mesh)
        if args.engine == "static":
            if args.autotune_cache is not None:
                dispatch.set_cache_path(args.autotune_cache)
            with dispatch.using_policy(exec_policy(args)):
                run = run_static(args, params, cfg, device, mesh=mesh)
            return dict(build=build, tokens=run["tokens"].cpu().tolist(),
                        launches=run["launches"],
                        collectives=run["collectives"],
                        checked=run.get("checked"),
                        dropped_frac=run["dropped_frac"])
        run = run_continuous(args, params, cfg, device, mesh=mesh,
                             kv_spec=kv_spec)
    return dict(build=build, tokens={rid: seq.generated for rid, seq in
                                     run["results"].items()},
                metrics=run["metrics"], steps=run["steps"],
                launches=run["launches"], checked=run.get("checked"),
                plans=len(run["exec_plans"]),
                sharded=sum(1 for p in run["exec_plans"].values()
                            if p.shard is not None))


if __name__ == "__main__":
    main()
