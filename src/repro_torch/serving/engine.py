"""Continuous-batching serving engine over the paged KV pool; port of
repro.serving.engine.

The engine admits a stream of variable-length requests and interleaves
chunked prefill with batched decode through one shared step
(``runtime.serve.paged_step``): a prefill chunk is a (1, C) call and a
decode iteration a (max_slots, 1) call of the same function.  Greedy
outputs are token-identical to the static ``runtime.serve.generate`` path
for the same prompts: chunked prefill is exact, and the paged view masks
slots a sequence does not own to probability exactly 0.

The step is compiled, as the reference's ``jax.jit(raw_step,
donate_argnums=(1,))`` is: :class:`StepRunner` captures each of the two
step shapes once as a CUDA graph and replays it, with the host's inputs
copied into the graph's static buffers (the pool is written in place, so
nothing needs donating).  On the CPU, or with ``cuda_graph=False``, the
same runner calls the step eagerly.

Execution planning as in the reference: with a ``backend`` or
``autotune`` request the engine builds an ``ExecPolicy`` and resolves
every GeMM's plan at build (``StepRunner.resolve_plans``: one idle step
of each shape under ``dispatch.collecting()`` enumerates the keys, and
``dispatch.warm`` tunes or looks them up), before anything is captured;
every step then runs under ``dispatch.using_policy``.  With neither the
policy is None and nothing changes.

The engine reports through ``repro_torch.obs`` under the reference's
series and span names (``serving_*``, ``kv_*``, ``engine.prefill_chunk``,
``engine.decode_step``, ``request.submit``/``finish``), so the two
engines' snapshots compare key by key.

Deliberately not ported here: the reference's step retry, NaN quarantine
and replan to a fallback backend, watchdog, deadlines, shedding and
fault hooks.  Each would hide a failing kernel; they arrive with the
resilience slice.  A failing step raises.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch import dispatch, kvq, obs
from repro_torch.kernels.ops import KERNELS
from repro_torch.models.config import ModelConfig
from repro_torch.runtime import serve as SV
from repro_torch.serving import kv_blocks
from repro_torch.serving.kv_blocks import BlockPool
from repro_torch.serving.request import Phase, Request, Sequence, detokenize
from repro_torch.serving.scheduler import Scheduler

# queue depth / batch occupancy are small integers, not latencies
DEPTH_BUCKETS = (0, 1, 2, 4, 8, 16, 32, 64, 128, 256)

# the step's host inputs, in ``paged_step``'s order
STEP_INPUTS = ("tokens", "positions", "write_slots", "view_slots",
               "last_idx")


class _StepTimer:
    """Times one engine iteration into serving_step_s{phase=}.  Every step
    ends by reading its tokens on the host, so the time includes the
    device's work."""

    __slots__ = ("engine", "phase", "t0")

    def __init__(self, engine, phase):
        self.engine = engine
        self.phase = phase

    def __enter__(self):
        self.t0 = self.engine._clock()
        return self

    def __exit__(self, *exc):
        obs.registry().histogram(
            "serving_step_s", help="engine iteration wall time",
            phase=self.phase).observe(self.engine._clock() - self.t0)
        return False


class _Shape:
    """One step shape's buffers: pinned host staging, the static device
    inputs, and, once captured, the graph with its outputs, its kernel
    launches and the device marks staged at its capture."""

    def __init__(self, batch: int, chunk: int, width: int, block_size: int,
                 device: torch.device):
        shapes = dict(tokens=(batch, chunk), positions=(batch, chunk),
                      write_slots=(batch, chunk), view_slots=(batch, width),
                      last_idx=(batch,))
        pin = device.type == "cuda"
        self.host = {k: torch.zeros(v, dtype=torch.int32, pin_memory=pin)
                     for k, v in shapes.items()}
        # an idle step: every row writes its own scratch slot and views
        # only scratch (the capture's warm-up runs it)
        self.host["write_slots"].copy_(
            torch.arange(batch * chunk, dtype=torch.int32).remainder(
                block_size).view(batch, chunk))
        self.dev = {k: v.to(device) for k, v in self.host.items()}
        self.graph = None
        self.tokens = self.logits = None
        self.launches: list[tuple] = []
        self.marks: list = []


class StepRunner:
    """The engine's compiled step, the counterpart of the reference's
    ``raw_step`` under ``jax.jit``: ``runtime.serve.paged_step`` plus the
    greedy tokens, per step shape (name -> (batch, chunk)) over view width
    ``width``.

    Each call copies the host arrays into static device buffers
    (``non_blocking`` from pinned staging on CUDA), runs the step, and
    returns the greedy tokens on the host (one device-to-host copy) and
    the logits on the device.  With ``cuda_graph`` each shape is warmed
    up once eagerly on a side stream (which builds the kernels and sets
    their shared-memory limits) and captured as a CUDA graph into one
    memory pool shared by both shapes; every call replays it.  The logits
    then live in the graph's static output: read them before the next
    call of the same shape.  Without ``cuda_graph`` the step runs eagerly
    through the same staging.  A capture or replay failure raises.

    ``policy``: the engine's ExecPolicy (None: the process default),
    active around every step; when given, :meth:`resolve_plans` runs
    before any capture and ``exec_plans`` holds its plans.

    Launch counts: a capture records each kernel module's launches without
    running them, so they are taken back and added again on every
    replay; the modules' ``launches`` read the same per step on both
    routes.  Device marks (``repro_torch.obs``) staged at the capture are
    recorded by every replay and resolved after it.
    """

    def __init__(self, params, cfg: ModelConfig, kv, device: torch.device,
                 shapes: dict, *, width: int, block_size: int,
                 cuda_graph: bool, policy=None):
        if cuda_graph and device.type != "cuda":
            raise ValueError(f"cuda_graph needs a CUDA device, not {device}")
        self.params, self.cfg, self.kv, self.device = params, cfg, kv, device
        self.cuda_graph = cuda_graph
        self.policy = policy
        self.shapes = {name: _Shape(b, c, width, block_size, device)
                       for name, (b, c) in shapes.items()}
        self.exec_plans: dict = {}
        if policy is not None:
            self.exec_plans = self.resolve_plans()
        if cuda_graph:
            pool = torch.cuda.graph_pool_handle()
            for shape in self.shapes.values():
                self._capture(shape, pool)

    def resolve_plans(self) -> dict:
        """Collect the plan keys of both step shapes by running each
        shape's idle step once (it writes only scratch, as a capture's
        warm-up does), then warm them under the policy: tuned, or read
        from the plan cache, before any capture.  Returns {plan key:
        plan}."""
        tr = obs.tracer()
        tr.resolve_marks(tr.take_marks())  # marks staged before it
        with dispatch.collecting() as reqs:
            for shape in self.shapes.values():
                self._step(shape)
        tr.take_marks()  # the collection's marks time no step
        return dispatch.warm(reqs, policy=self.policy)

    def _step(self, shape: _Shape):
        with torch.no_grad(), dispatch.using_policy(self.policy):
            logits, _ = SV.paged_step(
                self.params, self.cfg, shape.dev["tokens"], self.kv,
                shape.dev["positions"], shape.dev["write_slots"],
                shape.dev["view_slots"], shape.dev["last_idx"])
            return SV.greedy(logits), logits

    def _capture(self, shape: _Shape, pool) -> None:
        tr = obs.tracer()
        tr.resolve_marks(tr.take_marks())  # marks staged before the capture
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            self._step(shape)  # warm-up: an idle step, scratch only
        main.wait_stream(side)
        tr.take_marks()  # the warm-up's marks time no user step
        before = {mod: mod.launches for mod in KERNELS.values()}
        shape.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(shape.graph, pool=pool):
            shape.tokens, shape.logits = self._step(shape)
        shape.launches = [(mod, mod.launches - n) for mod, n in
                          before.items() if mod.launches != n]
        for mod, n in before.items():
            mod.launches = n
        shape.marks = tr.take_marks()

    def __call__(self, name: str, *arrays: np.ndarray):
        """One step of shape ``name`` on host arrays in ``STEP_INPUTS``
        order.  Returns (greedy tokens (B,) numpy, logits (B, V) device)."""
        shape = self.shapes[name]
        for key, a in zip(STEP_INPUTS, arrays):
            shape.host[key].numpy()[...] = a
            shape.dev[key].copy_(shape.host[key], non_blocking=True)
        t0 = time.perf_counter()
        if shape.graph is not None:
            shape.graph.replay()
            for mod, n in shape.launches:
                mod.launches += n
            tokens, logits, marks = shape.tokens, shape.logits, shape.marks
        else:
            tokens, logits = self._step(shape)
            marks = obs.tracer().take_marks()
        host = tokens.cpu().numpy()
        obs.tracer().resolve_marks(marks, t0)
        return host, logits


class Engine:
    """Continuous-batching engine on the device of ``params``.

    max_slots: decode-batch width.  block_size: KV block size in token
    positions.  num_blocks: pool size incl. the reserved scratch block;
    the default never preempts (max_slots full-length sequences).
    max_model_len: per-sequence position budget.  prefill_chunk: prefill
    tokens per iteration.  kv_quant: a ``repro_torch.kvq.KVQuantSpec`` —
    store the pool as low-bit codes + scales and read it through the
    paged-attention backends (the CUDA kernel on the GPU); None keeps the
    full-precision ``cache_dtype`` pool.  kv_pool_bytes: size the pool by
    a device-byte budget at its actual storage cost
    (``kvq.blocks_for_bytes``) instead of ``num_blocks`` (ignored when
    ``num_blocks`` is given).  on_token: optional ``f(rid, token, text)``
    streaming callback.  sample_seed: seeds the host-side sampler used
    for requests with temperature > 0.  cuda_graph: run each step shape
    as a captured CUDA graph (:class:`StepRunner`); None means on for a
    CUDA device, and False on CUDA is the eager route.  The graphs are
    captured here, so enable tracing before building the engine to get
    the device marks of its steps.  backend / autotune / autotune_cache:
    the execution policy (``dispatch.ExecPolicy``: a forced GeMM backend,
    autotuning False/True/'model'/'full', and the plan-cache file); with
    any of backend or autotune set, every GeMM's plan is resolved at
    build (``exec_plans``), tuned plans included, before the capture.
    """

    def __init__(self, params, cfg: ModelConfig, *, max_slots: int = 4,
                 block_size: int = 16, num_blocks: int | None = None,
                 max_model_len: int | None = None, prefill_chunk: int = 16,
                 cache_dtype=torch.float32, kv_quant=None,
                 kv_pool_bytes: int | None = None, on_token=None,
                 clock=time.perf_counter, sample_seed: int = 0,
                 cuda_graph: bool | None = None, backend: str | None = None,
                 autotune: bool | str = False, autotune_cache=None):
        self.params = params
        if kv_quant is not None:
            cfg = cfg.replace(kv_quant=kv_quant)
        self.cfg = cfg
        self.device = params.embedding.device
        self.max_model_len = max_model_len or cfg.max_seq_len
        self.block_size = block_size
        self.max_blocks_per_seq = -(-self.max_model_len // block_size)
        if num_blocks is None:
            if kv_pool_bytes is not None:
                num_blocks = kvq.blocks_for_bytes(
                    cfg, kv_pool_bytes, block_size, cfg.kv_quant,
                    cache_dtype)
            else:
                num_blocks = max_slots * self.max_blocks_per_seq + 1
        self.pool = BlockPool(num_blocks, block_size)
        self.kv = SV.init_paged_cache(cfg, num_blocks, block_size,
                                      cache_dtype, device=self.device)
        self.scheduler = Scheduler(self.pool, max_slots=max_slots,
                                   prefill_chunk=prefill_chunk, clock=clock)
        self.max_slots = max_slots
        self.prefill_chunk = prefill_chunk
        self.on_token = on_token
        self._clock = clock
        self._t0 = clock()
        self._sample_seed = sample_seed
        self._rngs: dict[int, np.random.Generator] = {}
        self.finished: list[Sequence] = []
        self.num_prefill_steps = 0
        self.num_decode_steps = 0
        # peak concurrently-admitted sequences before the first preemption
        self.max_resident_seqs = 0
        self._export_kv_gauges(num_blocks, cache_dtype)
        if cuda_graph is None:
            cuda_graph = self.device.type == "cuda"
        # with no backend and no autotune request the policy is None and
        # the process default applies, exactly as before
        self._policy = None
        if backend is not None or autotune:
            if autotune_cache is not None:
                dispatch.set_cache_path(autotune_cache)
            self._policy = dispatch.ExecPolicy(backend=backend,
                                               autotune=autotune)
        self.runner = StepRunner(
            params, cfg, self.kv, self.device,
            {"prefill": (1, prefill_chunk), "decode": (max_slots, 1)},
            width=self.max_blocks_per_seq * block_size,
            block_size=block_size, cuda_graph=cuda_graph,
            policy=self._policy)
        self.exec_plans = self.runner.exec_plans

    def _export_kv_gauges(self, num_blocks: int, cache_dtype) -> None:
        """Pool-capacity gauges (kv_* prefix, not serving_*: capacity is a
        property of the built engine, so ``reset_metrics`` keeps it)."""
        reg = obs.registry()
        spec = self.cfg.kv_quant
        reg.gauge("kv_pool_bytes",
                  help="device bytes of the paged KV pool").set(
            kvq.pool_bytes(self.cfg, num_blocks, self.block_size, spec,
                           cache_dtype))
        reg.gauge("kv_bytes_per_token",
                  help="pool bytes per token slot across all layers"
                  ).set(kvq.bytes_per_token(self.cfg, spec, cache_dtype))
        reg.gauge("kv_capacity_seqs",
                  help="max-length sequences the pool can hold").set(
            (num_blocks - 1) // self.max_blocks_per_seq)
        if spec is not None:
            dev = self.device.type
            reg.gauge(
                "kv_dequant_hbm_bytes",
                help="device bytes of dequantized K/V one layer-step "
                     "materializes (0: dequantized on chip only)",
                backend=kvq.attention.select(spec, dev)).set(
                kvq.attention.dequant_hbm_bytes(
                    spec, self.cfg, self.max_slots,
                    self.max_blocks_per_seq * self.block_size, dev))

    @property
    def now(self) -> float:
        return self._clock() - self._t0

    @property
    def num_steps(self) -> int:
        """Model steps run so far (prefill chunks + decode batches)."""
        return self.num_prefill_steps + self.num_decode_steps

    # ------------------------------------------------------------ intake
    def submit(self, req: Request, *, arrival: float | None = None
               ) -> Sequence:
        """Queue a request; ``arrival`` backdates ``t_arrival`` (engine
        seconds).  Requests over the model or pool budget raise."""
        total = len(req.prompt) + req.max_new_tokens
        if total > self.max_model_len:
            raise ValueError(
                f"request {req.rid}: prompt+new = {total} exceeds "
                f"max_model_len {self.max_model_len}")
        if self.pool.blocks_for(total) > self.pool.capacity:
            raise ValueError(
                f"request {req.rid}: needs {self.pool.blocks_for(total)} "
                f"blocks, pool holds {self.pool.capacity}")
        seq = Sequence(req=req,
                       t_arrival=self.now if arrival is None else arrival)
        self.scheduler.add(seq)
        obs.registry().counter("serving_requests_submitted_total",
                               help="requests queued").inc()
        obs.tracer().instant("request.submit", cat="serving",
                             rid=req.rid, prompt_tokens=len(req.prompt))
        return seq

    # -------------------------------------------------------------- step
    def step(self) -> list[Sequence]:
        """One engine iteration (one prefill chunk OR one decode batch).
        Returns the sequences that finished this iteration."""
        done: list[Sequence] = []
        act = self.scheduler.schedule()
        self._sample_depths()
        if act is None:
            if self.scheduler.waiting:
                raise RuntimeError(
                    "engine stalled: waiting requests but nothing running "
                    "and the head cannot be admitted")
            return done
        if act[0] == "prefill":
            self._prefill_chunk(act[1], act[2], act[3], done)
        else:
            self._decode_batch(act[1], done)
        return done

    def _sample_depths(self) -> None:
        """Per-iteration queue/occupancy samples (gauge = live view for
        /metrics; histogram = distribution over the run)."""
        reg = obs.registry()
        depth = len(self.scheduler.waiting)
        running = len(self.scheduler.running)
        if self.scheduler.num_preemptions == 0:
            self.max_resident_seqs = max(self.max_resident_seqs, running)
        reg.gauge("serving_queue_depth",
                  help="waiting requests").set(depth)
        reg.gauge("serving_running_seqs",
                  help="admitted sequences").set(running)
        reg.histogram("serving_queue_depth_samples",
                      help="queue depth at each engine iteration",
                      buckets=DEPTH_BUCKETS).observe(depth)
        obs.tracer().counter("queue", waiting=depth, running=running)

    def _prefill_chunk(self, seq: Sequence, start: int, end: int,
                       done: list) -> None:
        C = self.prefill_chunk
        toks = seq.prefill_tokens
        n = end - start
        tokens = np.zeros((1, C), np.int32)
        tokens[0, :n] = toks[start:end]
        positions = (start + np.arange(C, dtype=np.int32))[None]
        ws = kv_blocks.write_slots(seq.blocks, start, n, C,
                                   self.block_size)[None]
        vs = kv_blocks.view_slots(seq.blocks, self.max_blocks_per_seq,
                                  self.block_size)[None]
        last = np.array([n - 1], np.int32)
        with obs.tracer().span("engine.prefill_chunk", cat="serving",
                               rid=seq.req.rid, start=start, end=end), \
                _StepTimer(self, "prefill"):
            tok, logits = self.runner("prefill", tokens, positions, ws, vs,
                                      last)
        self.num_prefill_steps += 1
        seq.prefill_pos = end
        if end == len(toks):  # prompt fully ingested -> first new token
            seq.phase = Phase.DECODE
            self._append(seq, self._pick(seq, tok[0], logits[0]), done)

    def _decode_batch(self, seqs: list[Sequence], done: list) -> None:
        active = []
        for seq in seqs:
            if seq.phase is not Phase.DECODE:
                continue  # evicted as a preemption victim this iteration
            if self.scheduler.grow_for_decode(seq):
                active.append(seq)
        if not active:
            return
        B, bs = self.max_slots, self.block_size
        W = self.max_blocks_per_seq * bs
        tokens = np.zeros((B, 1), np.int32)
        positions = np.zeros((B, 1), np.int32)
        # idle slots write to distinct offsets of the scratch block and view
        # only scratch: static shapes, no effect on live sequences
        ws = (np.arange(B, dtype=np.int32) % bs)[:, None]
        vs = np.zeros((B, W), np.int32)
        for seq in active:
            b = seq.slot
            tokens[b, 0] = seq.generated[-1]
            positions[b, 0] = seq.num_tokens - 1
            ws[b] = kv_blocks.write_slots(seq.blocks, seq.num_tokens - 1,
                                          1, 1, bs)
            vs[b] = kv_blocks.view_slots(seq.blocks, self.max_blocks_per_seq,
                                         bs)
        last = np.zeros((B,), np.int32)
        with obs.tracer().span("engine.decode_step", cat="serving",
                               batch=len(active)), \
                _StepTimer(self, "decode"):
            tok, logits = self.runner("decode", tokens, positions, ws, vs,
                                      last)
        self.num_decode_steps += 1
        obs.registry().histogram(
            "serving_decode_batch_occupancy",
            help="live rows per decode iteration (of max_slots)",
            buckets=DEPTH_BUCKETS).observe(len(active))
        for seq in active:
            self._append(seq, self._pick(seq, tok[seq.slot],
                                         logits[seq.slot]), done)

    # ---------------------------------------------------------- sampling
    def _pick(self, seq: Sequence, greedy_tok, logits) -> int:
        """Greedy, or the reference's seeded host-side Gumbel sampling (the
        same numpy draws, so sampled tokens match too).  ``logits`` may be
        a graph's static output: it is read here, before the next step."""
        if seq.req.temperature <= 0.0:
            return int(greedy_tok)
        rng = self._rngs.setdefault(
            seq.req.rid,
            np.random.default_rng(
                np.random.SeedSequence([self._sample_seed, seq.req.rid])))
        scaled = logits.double().cpu().numpy() / seq.req.temperature
        return int(np.argmax(scaled + rng.gumbel(size=scaled.shape)))

    def _append(self, seq: Sequence, token: int, done: list) -> None:
        t = self.now
        reg = obs.registry()
        seq.generated.append(token)
        if seq.t_first_token is None:
            seq.t_first_token = t
            reg.histogram("serving_ttft_s",
                          help="time to first token (incl. queueing)"
                          ).observe(t - seq.t_arrival)
        elif seq.t_last_token is not None:
            reg.histogram("serving_intertoken_s",
                          help="gap between consecutive tokens of one "
                               "request").observe(t - seq.t_last_token)
        seq.t_last_token = t
        if self.on_token is not None:
            self.on_token(seq.req.rid, token, detokenize([token]))
        if seq.done:
            seq.t_finish = t
            self.scheduler.finish(seq)
            self.finished.append(seq)
            done.append(seq)
            reg.counter("serving_requests_finished_total",
                        help="requests run to completion").inc()
            reg.histogram("serving_request_latency_s",
                          help="arrival -> last token"
                          ).observe(t - seq.t_arrival)
            obs.tracer().instant("request.finish", cat="serving",
                                 rid=seq.req.rid,
                                 new_tokens=len(seq.generated),
                                 preemptions=seq.preemptions)

    # --------------------------------------------------------------- run
    def run(self, requests, *, wait_for_arrivals: bool = True
            ) -> dict[int, Sequence]:
        """Drive a request stream to completion.  ``arrival_time`` is
        seconds after the call; with ``wait_for_arrivals`` the engine
        sleeps through idle gaps, otherwise future arrivals are pulled
        forward when it would idle."""
        pending = sorted(requests, key=lambda r: (r.arrival_time, r.rid))
        results: dict[int, Sequence] = {}
        if not self.scheduler.has_work() and not self.finished:
            self._t0 = self._clock()

        def _take():
            req = pending.pop(0)
            self.submit(req, arrival=min(req.arrival_time, self.now))

        while pending or self.scheduler.has_work():
            while pending and pending[0].arrival_time <= self.now:
                _take()
            if not self.scheduler.has_work():
                if wait_for_arrivals:
                    time.sleep(max(0.0, pending[0].arrival_time - self.now))
                _take()
            for seq in self.step():
                results[seq.req.rid] = seq
        return results

    def reset_metrics(self) -> None:
        """Drop finished-request history, step counters and the serving_*
        registry series (TTFT, inter-token, step-time, queue histograms),
        e.g. after a warm-up stream, without touching queued or running
        work.  The kv_* capacity gauges stay."""
        self.finished = []
        self.num_prefill_steps = 0
        self.num_decode_steps = 0
        self.max_resident_seqs = 0
        self.scheduler.num_preemptions = 0
        self.scheduler.num_admitted = 0
        self.scheduler.num_evicted_blocks = 0
        self.scheduler.num_thrash = 0
        obs.registry().reset(prefix="serving_")
        for seq in self.scheduler.running:
            seq.t_last_token = None  # warm-up gaps must not leak into the
            # measured stream's first inter-token sample

    # ----------------------------------------------------------- metrics
    def metrics(self) -> dict:
        """Aggregate serving metrics over finished requests.  Every key is
        always present and the call never raises: with nothing finished,
        counts and rates are 0 and percentiles None; with one finished
        request its percentiles are that request's value.  The
        inter-token and queue-wait percentiles come from the registry's
        histograms, as the reference's do."""
        fin = self.finished

        def pct(xs, q):
            if len(xs) == 0:
                return None
            if len(xs) == 1:
                return float(xs[0])
            return float(np.percentile(np.asarray(xs), q))

        gen = sum(len(s.generated) for s in fin)
        span = (max(s.t_finish for s in fin)
                - min(s.t_arrival for s in fin)) if fin else 0.0
        lat = [s.t_finish - s.t_arrival for s in fin]
        ttft = [s.t_first_token - s.t_arrival for s in fin
                if s.t_first_token is not None]
        reg = obs.registry()
        inter = reg.histogram("serving_intertoken_s")
        return {
            "requests": len(fin),
            "generated_tokens": gen,
            "preemptions": self.scheduler.num_preemptions,
            "max_resident_seqs": self.max_resident_seqs,
            "evicted_blocks": self.scheduler.num_evicted_blocks,
            "admitted": self.scheduler.num_admitted,
            "prefill_steps": self.num_prefill_steps,
            "decode_steps": self.num_decode_steps,
            "tok_per_s": gen / span if span > 0 else 0.0,
            "latency_p50_s": pct(lat, 50),
            "latency_p95_s": pct(lat, 95),
            "ttft_p50_s": pct(ttft, 50),
            "ttft_p95_s": pct(ttft, 95),
            "intertoken_p50_s": inter.percentile(50),
            "intertoken_p95_s": inter.percentile(95),
            "preempt_thrash": self.scheduler.num_thrash,
            "queue_wait_p95_s": reg.histogram(
                "serving_queue_wait_s").percentile(95),
        }

    def summary(self) -> dict:
        """Alias of :meth:`metrics`."""
        return self.metrics()
