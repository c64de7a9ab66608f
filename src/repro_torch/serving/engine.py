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

Resilience, as in the reference (README §Resilience): per-request
deadlines with clean cancellation, queue-depth and deadline-aware load
shedding, bounded step retry with exponential backoff, a NaN/Inf logit
guard that quarantines the offending sequence and, on repeat, the
suspect GeMM backends, replanning down the ladder (``msgemm_cuda`` ->
``msgemm_torch`` -> ``dense_fallback``), and watchdog hang escalation
doing the same.  Fault injection lives behind ``repro_torch.faults``
(one None check a site when disarmed).  Where the card changes things:

* the per-row finite flag is computed inside the step, so inside the
  captured graph, and comes to the host in the tokens' one copy;
* a replan drops both graphs and their memory pool and captures the two
  step shapes again on the new plans (``StepRunner.recapture``, the
  counterpart of the reference's re-jit), after the step has returned:
  never inside a step the watchdog times, never inside a capture;
* nothing is donated (the pool is written in place, and a re-run of a
  step writes the same slots with the same values), so a retry is
  token-identical and there is no KV rebuild (``kv_rebuilds`` stays 0);
* no fault site runs inside a capture or its warm-up (those call
  ``StepRunner._step`` and allocate no blocks), so the fault
  opportunities line up with the reference engine's one for one.

Tensor-parallel serving (``Engine(mesh=...)``): one engine a rank of the
mesh (``launch.mesh.run_ranks``), each holding its shard of the weights
(``runtime.serve.init_shard`` or ``shard_params``) and of the pool
(``init_paged_cache(..., mesh=)``); every GeMM plan is resolved at build
under the mesh, and every step runs under it, each quantized linear on
its local shard shape (``dispatch.shard``).  The host side must agree on
every rank, so global rank 0 leads: it alone runs the scheduler,
deadlines and faults, and broadcasts each step's host arrays (and a
replan, and the end of the run with its results); the other ranks follow
in :meth:`Engine.run`.  A step's batch rows are split over the batch
axis when they divide it (``sharding.split_rows``), and its logits are
gathered whole before the tokens are picked, so every rank picks the
same ones.  The mesh engine is eager: a step's collectives are staged
through host memory when ranks share a card, which a CUDA graph cannot
hold, and capturing NCCL's is ROADMAP A13c.  Under the 'default' rules
each rank stores its 'data' block of the weights whose model dim takes
'data' (FSDP storage), and each block gathers them at the top of the
block for the step (``models.transformer``), but for the expert stacks,
which stay cut while the tokens move to them (``models.moe``).  With ``shard_pipeline=0``
the build tunes every row-parallel linear's collective layout
(``dispatch.autotune.tune_shard_variants``, through ``warm``; the ranks
agree on each winner) and the steps replay the winners.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import threading
import time

import numpy as np
import torch

from repro_torch import dispatch, faults, kvq, obs
from repro_torch.distributed import collectives as coll
from repro_torch.distributed import compat, sharding
from repro_torch.distributed.watchdog import Watchdog
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
                 device: torch.device, rows: str | None = None,
                 parts: int = 1):
        # under a mesh the device buffers hold this rank's rows: the
        # batch split over ``rows`` in ``parts`` (1: whole)
        self.rows, self.parts = rows, parts
        self.full = dict(tokens=(batch, chunk), positions=(batch, chunk),
                         write_slots=(batch, chunk),
                         view_slots=(batch, width), last_idx=(batch,))
        batch //= parts
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
        self.drop_graph()

    def drop_graph(self) -> None:
        """Forget the graph and its static outputs (their memory goes back
        to the graph's pool once nothing else holds them)."""
        self.graph = None
        self.out = self.logits = None
        self.launches: list[tuple] = []
        self.marks: list = []


class StepRunner:
    """The engine's compiled step, the counterpart of the reference's
    ``raw_step`` under ``jax.jit``: ``runtime.serve.paged_step`` plus the
    greedy tokens, per step shape (name -> (batch, chunk)) over view width
    ``width``.

    Each call copies the host arrays into static device buffers
    (``non_blocking`` from pinned staging on CUDA), runs the step, and
    returns the greedy tokens and the per-row finite flags on the host
    (one device-to-host copy of both, computed inside the step) and the
    logits on the device.  With ``cuda_graph`` each shape is warmed
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
    recorded by every replay and resolved after it.  ``captures`` counts
    the shapes captured so far (two at build, two more per
    :meth:`recapture`).
    """

    def __init__(self, params, cfg: ModelConfig, kv, device: torch.device,
                 shapes: dict, *, width: int, block_size: int,
                 cuda_graph: bool, policy=None, mesh=None,
                 rules: str = "serve"):
        if cuda_graph and device.type != "cuda":
            raise ValueError(f"cuda_graph needs a CUDA device, not {device}")
        self.params, self.cfg, self.kv, self.device = params, cfg, kv, device
        self.cuda_graph = cuda_graph
        self.policy = policy
        self.mesh, self.rules = mesh, rules
        self.shapes = {name: _Shape(b, c, width, block_size, device,
                                    *self._rows_of(b))
                       for name, (b, c) in shapes.items()}
        self._names = sorted(self.shapes)
        self.captures = 0
        self.steps_run = 0  # steps run by __call__ (a follower's included)
        self.exec_plans: dict = {}
        if policy is not None:
            self.exec_plans = self.resolve_plans()
        if cuda_graph:
            self._capture_all()

    def _rows_of(self, batch: int) -> tuple:
        """(the mesh axis a step of ``batch`` rows is split over, or None;
        the number of parts): the batch axis of the rules when it divides
        the rows, as the reference places its step inputs."""
        if self.mesh is None:
            return None, 1
        axis = sharding.spec_for(("batch",), (batch,), mesh=self.mesh,
                                 rules=self.rules)[0]
        if isinstance(axis, tuple):
            raise NotImplementedError(
                f"batch rows folded over {axis}: the mesh engine splits "
                "rows over one axis (ROADMAP A13c)")
        return axis, (1 if axis is None
                      else compat.axes_of(self.mesh)[axis])

    @contextlib.contextmanager
    def _mesh_step(self, shape: _Shape):
        if self.mesh is None:
            yield
            return
        with sharding.use(self.mesh, self.rules), \
                sharding.split_rows(shape.rows):
            yield

    def _capture_all(self) -> None:
        pool = torch.cuda.graph_pool_handle()  # one pool for both shapes
        for shape in self.shapes.values():
            self._capture(shape, pool)

    def recapture(self) -> None:
        """Drop both graphs and release their memory pool, then capture
        both step shapes again under the current plans: a replayed graph
        would still launch the kernels it was captured with.  A no-op on
        the eager route."""
        if not self.cuda_graph:
            return
        torch.cuda.synchronize(self.device)
        for shape in self.shapes.values():
            shape.drop_graph()
        torch.cuda.empty_cache()
        self._capture_all()

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
        if self.mesh is None:
            return dispatch.warm(reqs, policy=self.policy)
        with sharding.use(self.mesh, self.rules):  # every rank tunes
            return dispatch.warm(reqs, policy=self.policy)

    def _step(self, shape: _Shape):
        with torch.no_grad(), dispatch.using_policy(self.policy), \
                self._mesh_step(shape):
            logits, _ = SV.paged_step(
                self.params, self.cfg, shape.dev["tokens"], self.kv,
                shape.dev["positions"], shape.dev["write_slots"],
                shape.dev["view_slots"], shape.dev["last_idx"])
            # every rank's rows: all pick the same tokens
            logits = sharding.gather_rows(logits)
            # the greedy tokens and the per-row finite flags (the NaN
            # guard's input) in one (2, B) buffer: one copy to the host
            out = torch.stack([SV.greedy(logits), torch.isfinite(
                logits).all(-1).to(torch.int32)])
            return out, logits

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
        # no collection while capturing: a dropped engine held by a cycle
        # would free its graphs mid-capture, which invalidates the capture
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(shape.graph, pool=pool):
                shape.out, shape.logits = self._step(shape)
        finally:
            if collecting:
                gc.enable()
        self.captures += 1
        shape.launches = [(mod, mod.launches - n) for mod, n in
                          before.items() if mod.launches != n]
        for mod, n in before.items():
            mod.launches = n
        shape.marks = tr.take_marks()

    def __call__(self, name: str, *arrays: np.ndarray):
        """One step of shape ``name`` on host arrays in ``STEP_INPUTS``
        order.  Returns (greedy tokens (B,) numpy, finite flags (B,)
        numpy, logits (B, V) device).  Under a mesh the leader's call
        broadcasts the arrays, and the followers run the same step
        (:meth:`receive`)."""
        if self.mesh is not None:
            self.send(OP_STEP, self._names.index(name))
            arrays = self._broadcast_arrays(self.shapes[name], arrays)
        return self._run(name, arrays)

    def _run(self, name: str, arrays):
        shape = self.shapes[name]
        self.steps_run += 1
        if shape.parts > 1:  # this rank's rows
            c = sharding.coord(self.mesh, shape.rows)
            n = shape.full["tokens"][0] // shape.parts
            arrays = [a[c * n:(c + 1) * n] for a in arrays]
        for key, a in zip(STEP_INPUTS, arrays):
            shape.host[key].numpy()[...] = a
            shape.dev[key].copy_(shape.host[key], non_blocking=True)
        t0 = time.perf_counter()
        if shape.graph is not None:
            shape.graph.replay()
            for mod, n in shape.launches:
                mod.launches += n
            out, logits, marks = shape.out, shape.logits, shape.marks
        else:
            out, logits = self._step(shape)
            marks = obs.tracer().take_marks()
        host = out.cpu().numpy()
        obs.tracer().resolve_marks(marks, t0)
        return host[0], host[1], logits

    # ------------------------------------------------ leader / followers
    def send(self, op: int, arg: int = 0) -> None:
        """The leader's next instruction to its followers."""
        coll.broadcast(torch.tensor([op, arg], dtype=torch.int64))

    def _broadcast_arrays(self, shape: _Shape, arrays=None) -> list:
        """The leader's whole step arrays on every rank (one int32
        buffer)."""
        sizes = [int(np.prod(shape.full[k])) for k in STEP_INPUTS]
        if arrays is not None:
            buf = torch.from_numpy(np.concatenate(
                [np.asarray(a, np.int32).reshape(-1) for a in arrays]))
        else:
            buf = torch.empty(sum(sizes), dtype=torch.int32)
        coll.broadcast(buf)
        parts = buf.numpy()
        out, at = [], 0
        for key, n in zip(STEP_INPUTS, sizes):
            out.append(parts[at:at + n].reshape(shape.full[key]))
            at += n
        return out

    def receive(self) -> tuple:
        """A follower's next instruction from the leader: (op, arg), and
        for a step the step's own result."""
        head = coll.broadcast(torch.zeros(2, dtype=torch.int64))
        op, arg = int(head[0]), int(head[1])
        if op == OP_STEP:
            name = self._names[arg]
            arrays = self._broadcast_arrays(self.shapes[name])
            self._run(name, arrays)
        return op, arg


# leader -> followers instructions of a mesh engine (StepRunner.receive)
OP_STEP, OP_REPLAN, OP_STOP = 1, 2, 3
REPLAN_REASONS = ("hang", "nan_logits")


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

    Resilience, with the reference's defaults: max_queue sheds submissions
    beyond this waiting-queue depth (status 'shed', ``serving_shed_total``;
    None: unbounded).  deadline_s / ttft_deadline_s: default SLOs for
    requests that carry none; expired requests are cancelled with status
    'deadline', and a request whose deadline the p95 queue wait already
    exceeds is shed at submission.  step_retries / retry_backoff_s:
    bounded retry of a failed step with exponential backoff
    (token-identical: the retried step writes the same pool slots).
    watchdog: a ``distributed.watchdog.Watchdog`` (True:
    ``Watchdog(min_steps=3, min_timeout_s=0.5)``) timing every step; a
    hang escalates after the step returns to a quarantine of the suspect
    backends and a replan.  nan_replan_after: non-finite-logit events
    (each quarantines its sequence, status 'quarantined') after which the
    guard also quarantines the suspect backends and replans.

    Tensor parallelism: mesh is a ``DeviceMesh`` over the ranks
    (``launch.mesh.make_mesh``), one engine a rank, each serving this
    rank's copy of the model.  ``params`` is that copy
    (``runtime.serve.init_shard``, drawn a block at a time, so no whole
    model is ever on the rank's device; the engine keeps it as it is),
    or the whole model, which the engine cuts to its copy
    (``runtime.serve.shard_params``) and does not keep: the copy shares
    only the leaves it does not cut, so the whole model's memory is freed
    when the caller drops ``params``.
    mesh_rules: the logical-axis rule set ('serve': batch rows over
    'data', weights over 'model'; 'default': the same, with the weights'
    model dim stored cut over 'data' and gathered a block at a time, the
    expert stacks' kept cut while the tokens move to them;
    'serve_tp': no row split).
    shard_collective ('psum' | 'reduce_scatter'), shard_pipeline
    (contraction chunks of a row-parallel linear; 0: tuned at build,
    ``dispatch.autotune.tune_shard_variants``) and shard_impl ('xla' |
    'ring') go into the ExecPolicy.
    Every rank calls :meth:`run`; global rank 0 leads and returns, on
    every rank, its results.  Decoders with 'attn', 'local' and 'moe'
    blocks only (NotImplementedError otherwise: :func:`check_mesh_model`),
    eager only (``cuda_graph=True`` raises ValueError).
    """

    def __init__(self, params, cfg: ModelConfig, *, max_slots: int = 4,
                 block_size: int = 16, num_blocks: int | None = None,
                 max_model_len: int | None = None, prefill_chunk: int = 16,
                 cache_dtype=torch.float32, kv_quant=None,
                 kv_pool_bytes: int | None = None, on_token=None,
                 clock=time.perf_counter, sample_seed: int = 0,
                 cuda_graph: bool | None = None, backend: str | None = None,
                 autotune: bool | str = False, autotune_cache=None,
                 max_queue: int | None = None,
                 deadline_s: float | None = None,
                 ttft_deadline_s: float | None = None,
                 step_retries: int = 2, retry_backoff_s: float = 0.02,
                 watchdog: Watchdog | bool | None = None,
                 nan_replan_after: int = 2, mesh=None,
                 mesh_rules: str = "serve", shard_collective: str = "psum",
                 shard_pipeline: int = 1, shard_impl: str = "xla"):
        if kv_quant is not None:
            cfg = cfg.replace(kv_quant=kv_quant)
        self.mesh, self.mesh_rules = mesh, mesh_rules
        self.is_leader = True
        if mesh is not None:
            cuda_graph = _check_mesh(cfg, mesh, mesh_rules, cuda_graph)
            self.is_leader = torch.distributed.get_rank() == 0
            mine = getattr(params, "served_on", None)
            if mine is None:
                params = SV.shard_params(params, cfg, mesh, mesh_rules)
            elif mine != SV.served_on(mesh, mesh_rules):
                raise ValueError(f"params is a rank's copy for {mine}, not "
                                 f"for {SV.served_on(mesh, mesh_rules)}")
        self.params = params
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
                                      cache_dtype, device=self.device,
                                      mesh=mesh, rules=mesh_rules)
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
        self.rejected: list[Sequence] = []  # shed / cancelled / ...
        self.num_prefill_steps = 0
        self.num_decode_steps = 0
        # peak concurrently-admitted sequences before the first preemption
        self.max_resident_seqs = 0
        # ---- resilience knobs and state
        self.max_queue = max_queue
        self.default_deadline_s = deadline_s
        self.default_ttft_deadline_s = ttft_deadline_s
        self.step_retries = step_retries
        self.retry_backoff_s = retry_backoff_s
        self.nan_replan_after = nan_replan_after
        self.num_shed = 0
        self.num_step_retries = 0
        self.num_nan_events = 0
        self.num_replans = 0
        # nothing is donated, so no failure can consume the pool: kept as a
        # metric of the reference's that is always 0 here
        self.num_kv_rebuilds = 0
        # any deadline anywhere flips this; the per-step scan is skipped
        # otherwise
        self._deadline_watch = bool(deadline_s or ttft_deadline_s)
        self._hang_flag = threading.Event()
        if watchdog is True:
            # serving steps are ms-scale: mean*hang_factor would be
            # microseconds, so the floor carries the timeout
            watchdog = Watchdog(min_steps=3, min_timeout_s=0.5)
        self._watchdog = watchdog or None
        if self._watchdog is not None and self._watchdog.on_hang is None:
            self._watchdog.on_hang = self._hang_flag.set
        self._export_kv_gauges(num_blocks, cache_dtype)
        if cuda_graph is None:
            cuda_graph = self.device.type == "cuda"
        # with no backend and no autotune request the policy is None and
        # the process default applies, exactly as before; a mesh always
        # resolves its (sharded) plans at build, as the reference's does
        self._policy = None
        if backend is not None or autotune or mesh is not None:
            if autotune_cache is not None:
                dispatch.set_cache_path(autotune_cache)
            self._policy = dispatch.ExecPolicy(
                backend=backend, autotune=autotune,
                shard_collective=shard_collective,
                shard_pipeline=shard_pipeline, shard_impl=shard_impl)
        self.runner = StepRunner(
            params, cfg, self.kv, self.device,
            {"prefill": (1, prefill_chunk), "decode": (max_slots, 1)},
            width=self.max_blocks_per_seq * block_size,
            block_size=block_size, cuda_graph=cuda_graph,
            policy=self._policy, mesh=mesh, rules=mesh_rules)

    @property
    def exec_plans(self) -> dict:
        """{plan key: plan} the step runs on (empty until resolved: at
        build with a policy, else at the first replan)."""
        return self.runner.exec_plans

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
        seconds).  Malformed requests (over the model or pool budget)
        raise; load problems do not: a full queue or a hopeless deadline
        sheds the request (the returned Sequence has status 'shed' and
        never enters the scheduler)."""
        total = len(req.prompt) + req.max_new_tokens
        if total > self.max_model_len:
            raise ValueError(
                f"request {req.rid}: prompt+new = {total} exceeds "
                f"max_model_len {self.max_model_len}")
        if self.pool.blocks_for(total) > self.pool.capacity:
            raise ValueError(
                f"request {req.rid}: needs {self.pool.blocks_for(total)} "
                f"blocks, pool holds {self.pool.capacity}")
        if (req.deadline_s is None and req.ttft_deadline_s is None and
                (self.default_deadline_s or self.default_ttft_deadline_s)):
            req = dataclasses.replace(
                req, deadline_s=self.default_deadline_s,
                ttft_deadline_s=self.default_ttft_deadline_s)
        seq = Sequence(req=req,
                       t_arrival=self.now if arrival is None else arrival)
        if req.deadline_s is not None or req.ttft_deadline_s is not None:
            self._deadline_watch = True
        shed_reason = None
        if self.max_queue is not None and \
                len(self.scheduler.waiting) >= self.max_queue:
            shed_reason = "queue_full"
        elif req.deadline_s is not None:
            # deadline-aware admission: a p95 queue wait past the whole
            # budget is a promise the engine knows it cannot keep
            p95 = obs.registry().histogram(
                "serving_queue_wait_s").percentile(95)
            if p95 is not None and p95 > req.deadline_s:
                shed_reason = "deadline_hopeless"
        if shed_reason is not None:
            return self._shed(seq, shed_reason)
        self.scheduler.add(seq)
        obs.registry().counter("serving_requests_submitted_total",
                               help="requests queued").inc()
        obs.tracer().instant("request.submit", cat="serving",
                             rid=req.rid, prompt_tokens=len(req.prompt))
        return seq

    def _shed(self, seq: Sequence, reason: str) -> Sequence:
        seq.status = "shed"
        seq.phase = Phase.FINISHED
        seq.t_finish = self.now
        self.num_shed += 1
        self.rejected.append(seq)
        obs.registry().counter(
            "serving_shed_total",
            help="requests rejected at admission (load shedding)",
            reason=reason).inc()
        obs.tracer().instant("request.shed", cat="serving",
                             rid=seq.req.rid, reason=reason)
        return seq

    def cancel(self, seq: Sequence, reason: str = "cancelled") -> Sequence:
        """Terminate a queued or running sequence: scheduler resources
        freed, status recorded, counted, never an exception.  Idempotent
        on sequences already terminal."""
        if seq.phase is Phase.FINISHED:
            return seq
        self.scheduler.remove(seq)
        seq.status = reason
        seq.t_finish = self.now
        self.rejected.append(seq)
        obs.registry().counter(
            "serving_cancelled_total",
            help="live sequences cancelled (deadline/disconnect/guard)",
            reason=reason).inc()
        obs.tracer().instant("request.cancel", cat="serving",
                             rid=seq.req.rid, reason=reason,
                             generated=len(seq.generated))
        return seq

    def _enforce_deadlines(self, done: list) -> None:
        now = self.now
        for seq in list(self.scheduler.waiting) + list(self.scheduler.running):
            req = seq.req
            if req.deadline_s is not None and \
                    now - seq.t_arrival > req.deadline_s:
                done.append(self.cancel(seq, "deadline"))
            elif req.ttft_deadline_s is not None and \
                    seq.t_first_token is None and \
                    now - seq.t_arrival > req.ttft_deadline_s:
                done.append(self.cancel(seq, "deadline"))

    # -------------------------------------------------------------- step
    def step(self) -> list[Sequence]:
        """One engine iteration (one prefill chunk OR one decode batch).
        Returns the sequences that terminated this iteration: finished
        (status 'ok') or cancelled (deadline, disconnect, quarantine; see
        ``Sequence.status``)."""
        done: list[Sequence] = []
        injecting = faults.active() is not None
        if injecting:
            ev = faults.fire("latency")
            if ev is not None:
                time.sleep(ev.magnitude)  # step-latency spike
            self._maybe_disconnect(done)
        if self._deadline_watch:
            self._enforce_deadlines(done)
        act = self.scheduler.schedule()
        self._sample_depths()
        if act is None:
            if self.scheduler.waiting and not injecting:
                raise RuntimeError(
                    "engine stalled: waiting requests but nothing running "
                    "and the head cannot be admitted")
            # under injection a transient (injected OOM) admission miss is
            # expected: report idle and let the caller step again
            return done
        if act[0] == "prefill":
            self._prefill_chunk(act[1], act[2], act[3], done)
        else:
            self._decode_batch(act[1], done)
        if self._hang_flag.is_set():
            self._escalate_hang()
        return done

    def _maybe_disconnect(self, done: list) -> None:
        live = [s for s in self.scheduler.running if not s.done]
        if not live:
            return
        ev = faults.fire("disconnect")
        if ev is not None:
            victim = live[int(ev.rng.integers(len(live)))]
            done.append(self.cancel(victim, "disconnected"))

    def _run_step(self, name: str, *arrays):
        """The guarded step call: watchdog timing, the ``hang`` and
        ``step_fail`` fault sites, and bounded retry with backoff.  The
        injected failure raises before the runner is called, and a re-run
        writes the same pool slots with the same values, so a retried
        step is token-identical.  Returns the runner's (tokens, finite
        flags, logits).

        Under a mesh a failure inside the runner is not retried: the
        leader has already told its followers to step, and they wait in
        the step's collectives, which a retry's new instruction would
        pair with unlike ones.  It raises on the leader, whose end ends
        every rank's run (``launch.mesh.run_ranks``)."""
        attempt = 0
        while True:
            wd = self._watchdog
            in_runner = False
            try:
                if wd is not None:
                    wd.step_started()
                try:
                    ev = faults.fire("hang")
                    if ev is not None:
                        # stalling past the armed hang timer models a
                        # wedged step and drives the same escalation
                        floor = 0.0
                        if wd is not None and wd._timer is not None:
                            floor = wd._timer.interval * 1.2
                        time.sleep(max(ev.magnitude, floor))
                    ev = faults.fire("step_fail")
                    if ev is not None:
                        raise faults.InjectedFault("step_fail", ev)
                    in_runner = True
                    return self.runner(name, *arrays)
                finally:
                    if wd is not None:
                        wd.step_finished()
            except (KeyboardInterrupt, SystemExit):
                raise
            except Exception:
                if in_runner and self.mesh is not None:
                    raise
                attempt += 1
                self.num_step_retries += 1
                obs.registry().counter(
                    "serving_step_retries_total",
                    help="engine step failures retried").inc()
                if attempt > self.step_retries:
                    raise
                time.sleep(self.retry_backoff_s * 2 ** (attempt - 1))

    # -------------------------------------------------------- degradation
    def _escalate_hang(self) -> None:
        """Watchdog hang escalation, run right after the stalled step
        returned: count it, quarantine the suspect backends and replan."""
        self._hang_flag.clear()
        obs.registry().counter(
            "serving_hang_escalations_total",
            help="watchdog hangs escalated to a backend replan").inc()
        self._replan("hang")

    def _replan(self, reason: str) -> None:
        """Quarantine the backends the current plans run on (one rung of
        the kernel -> torch -> dense_fallback ladder), resolve the plans
        again on what remains and capture both step shapes again: the
        counterpart of the reference's re-jit.  Runs between steps, never
        inside one; a mesh leader first tells its followers to do the
        same (the resolution's idle steps hold collectives)."""
        if self.mesh is not None and self.is_leader:
            self.runner.send(OP_REPLAN, REPLAN_REASONS.index(reason))
        self.num_replans += 1
        obs.registry().counter(
            "serving_replans_total",
            help="step replans after hang/NaN escalation",
            reason=reason).inc()
        runner = self.runner
        if not runner.exec_plans:
            # never resolved at build (no policy): resolve now so the
            # suspects are known by name
            runner.exec_plans = runner.resolve_plans()
        suspects = sorted({p.backend for p in runner.exec_plans.values()}
                          - {"dense", "dense_fallback"})
        for name in suspects:
            dispatch.quarantine_backend(name, reason)
        if self._policy is not None and self._policy.backend in suspects:
            self._policy = dataclasses.replace(self._policy, backend=None)
        runner.policy = self._policy
        runner.exec_plans = runner.resolve_plans()
        runner.recapture()
        obs.tracer().instant("engine.replan", cat="serving",
                             reason=reason, quarantined=",".join(suspects))

    def _check_finite(self, rows, ok, done: list) -> set:
        """NaN/Inf logit guard.  ``rows``: [(seq, row)] consuming a token
        this step; ``ok``: the step's per-row finite flags.  Non-finite
        rows (organic or injected) are quarantined: the sequence is
        cancelled instead of poisoning the batch, and once
        ``nan_replan_after`` events have accumulated the suspect backends
        are quarantined too.  Returns the ids of quarantined sequences."""
        if not rows:
            return set()
        bad = {i for (_, i) in rows if not bool(ok[i])}
        ev = faults.fire("nan_logits")
        if ev is not None:
            bad.add(rows[int(ev.rng.integers(len(rows)))][1])
        if not bad:
            return set()
        out = set()
        for seq, i in rows:
            if i not in bad:
                continue
            self.num_nan_events += 1
            obs.registry().counter(
                "serving_nan_quarantined_total",
                help="sequences quarantined on non-finite logits").inc()
            done.append(self.cancel(seq, "quarantined"))
            out.add(id(seq))
        if self.num_nan_events >= self.nan_replan_after:
            self._replan("nan_logits")
        return out

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
            tok, ok, logits = self._run_step("prefill", tokens, positions,
                                             ws, vs, last)
        self.num_prefill_steps += 1
        seq.prefill_pos = end
        if end == len(toks):  # prompt fully ingested -> first new token
            if self._check_finite([(seq, 0)], ok, done):
                return
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
            tok, ok, logits = self._run_step("decode", tokens, positions,
                                             ws, vs, last)
        self.num_decode_steps += 1
        obs.registry().histogram(
            "serving_decode_batch_occupancy",
            help="live rows per decode iteration (of max_slots)",
            buckets=DEPTH_BUCKETS).observe(len(active))
        # only live rows are guarded: idle slots attend scratch
        bad = self._check_finite([(s, s.slot) for s in active], ok, done)
        for seq in active:
            if id(seq) in bad:
                continue
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
        if not self.is_leader:
            return self._follow()
        pending = sorted(requests, key=lambda r: (r.arrival_time, r.rid))
        results: dict[int, Sequence] = {}
        if not self.scheduler.has_work() and not self.finished:
            self._t0 = self._clock()

        def _take():
            req = pending.pop(0)
            seq = self.submit(req, arrival=min(req.arrival_time, self.now))
            if seq.status != "ok":  # shed at admission: terminal already
                results[req.rid] = seq

        while pending or self.scheduler.has_work():
            while pending and pending[0].arrival_time <= self.now:
                _take()
            if not self.scheduler.has_work():
                if not pending:
                    break  # everything left was shed at submission
                if wait_for_arrivals:
                    time.sleep(max(0.0, pending[0].arrival_time - self.now))
                _take()
            for seq in self.step():
                results[seq.req.rid] = seq
        if self.mesh is not None:
            self.runner.send(OP_STOP)
            coll.broadcast_object(results)
        return results

    def _follow(self) -> dict[int, Sequence]:
        """A mesh follower's :meth:`run`: the leader's steps and replans,
        until it ends the run; returns the leader's results."""
        while True:
            op, arg = self.runner.receive()
            if op == OP_REPLAN:
                self._replan(REPLAN_REASONS[arg])
            elif op == OP_STOP:
                return coll.broadcast_object(None)

    def reset_metrics(self) -> None:
        """Drop finished-request history, step counters and the serving_*
        registry series (TTFT, inter-token, step-time, queue histograms),
        e.g. after a warm-up stream, without touching queued or running
        work.  The kv_* capacity gauges stay."""
        self.finished = []
        self.rejected = []
        self.num_prefill_steps = 0
        self.num_decode_steps = 0
        self.max_resident_seqs = 0
        self.num_shed = 0
        self.num_step_retries = 0
        self.num_nan_events = 0
        self.num_replans = 0
        self.num_kv_rebuilds = 0
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
            # ---- resilience
            "shed": self.num_shed,
            "cancelled": len(self.rejected) - self.num_shed,
            "step_retries": self.num_step_retries,
            "nan_quarantined": self.num_nan_events,
            "replans": self.num_replans,
            "kv_rebuilds": self.num_kv_rebuilds,
            "preempt_thrash": self.scheduler.num_thrash,
            "queue_wait_p95_s": reg.histogram(
                "serving_queue_wait_s").percentile(95),
        }

    def summary(self) -> dict:
        """Alias of :meth:`metrics`."""
        return self.metrics()


def check_mesh_model(cfg: ModelConfig) -> None:
    """NotImplementedError unless the mesh engine serves ``cfg``: decoders
    with 'attn', 'local' and 'moe' blocks.  Recurrent, encoder-decoder and
    vision models have no paged state, on a mesh as on one device; the
    static engine serves them on a mesh (``runtime.serve.generate``)."""
    if cfg.is_encdec or cfg.frontend or any(
            kind not in ("attn", "local", "moe")
            for kind in cfg.block_pattern):
        raise NotImplementedError(
            f"{cfg.name}: the paged engine serves decoders with 'attn', "
            f"'local' and 'moe' blocks, not {cfg.block_pattern}"
            + (" (encoder-decoder)" if cfg.is_encdec else "")
            + (f" (frontend {cfg.frontend})" if cfg.frontend else "")
            + "; serve it through the static engine, which runs every "
              "family on a mesh")


def _check_mesh(cfg: ModelConfig, mesh, rules: str, cuda_graph) -> bool:
    """Refuse what the mesh engine does not serve (a model without paged
    state, an unknown rule set, CUDA graphs, a mesh without every rank);
    returns the step route (eager: see the module's docstring).  Every
    rule set serves: 'default' stores the weights cut over 'data' too."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import mesh_devices

    check_mesh_model(cfg)
    if rules not in ("default", "serve", "serve_tp"):
        raise ValueError(f"mesh_rules={rules!r}: one of 'default', "
                         "'serve', 'serve_tp'")
    if cuda_graph:
        raise ValueError("cuda_graph=True under a mesh: the mesh engine "
                         "runs eagerly (a step holding host-staged "
                         "collectives cannot be captured; capturing NCCL's "
                         "is ROADMAP A13c)")
    if mesh_devices(mesh) != dist.get_world_size():
        raise ValueError(f"the mesh spans {mesh_devices(mesh)} of the "
                         f"{dist.get_world_size()} ranks: the engine needs "
                         "every rank on the mesh")
    return False
