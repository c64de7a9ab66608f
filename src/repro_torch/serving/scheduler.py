"""Continuous-batching scheduler; port of repro.serving.scheduler: FCFS
admission into a fixed set of decode slots, token-budgeted prefill
chunking, and preemption/eviction when the KV block pool is exhausted.
It reports through ``repro_torch.obs`` under the reference's names
(``serving_queue_wait_s``, ``serving_admissions_total``,
``serving_preemptions_total``, ``serving_evicted_blocks_total``,
``scheduler_preempt_thrash_total``; instants ``scheduler.admit`` and
``scheduler.preempt``).

Policy (vLLM-style, simplified):

* **Admission** — strict FCFS: the head of the waiting queue is admitted
  when a decode slot is free AND the pool can supply all blocks its
  prefill needs; the queue never reorders (no head-of-line skipping).
* **Prefill** — the earliest-admitted sequence still in PREFILL gets one
  chunk of at most ``prefill_chunk`` tokens per engine iteration (the
  iteration token budget), so a long prompt cannot monopolise the step
  loop: decode iterations interleave between its chunks.
* **Preemption** — when a decoding sequence needs a block and the pool is
  dry, the *latest-admitted* running sequence is evicted: blocks freed,
  re-queued at the front of the waiting queue, later re-prefilled from
  prompt ⊕ generated (token-exact, see request.Sequence).  Evicting the
  newest work first keeps FCFS latency ordering.
* **Thrash guard** — a sequence preempted ``THRASH_AFTER`` times or more
  backs off exponentially before re-admission (it stays at the queue
  head — FCFS order is preserved — but admission skips the tick), so
  sustained pool pressure degrades to slower progress instead of an
  admit/evict livelock burning steps with zero forward progress.
  ``num_thrash`` counts guarded preemptions.  The
  backoff is ignored whenever nothing is running — waiting out an empty
  engine would be a deadlock, not a remedy.
"""

from __future__ import annotations

import heapq
import time
from collections import deque

from repro_torch import obs
from repro_torch.serving.kv_blocks import BlockPool
from repro_torch.serving.request import Phase, Sequence

# preemption count at which the thrash guard kicks in, and the cap on
# its exponential re-admission backoff (in scheduler ticks)
THRASH_AFTER = 3
MAX_BACKOFF_TICKS = 64


class Scheduler:
    def __init__(self, pool: BlockPool, *, max_slots: int,
                 prefill_chunk: int, clock=time.monotonic):
        if max_slots < 1 or prefill_chunk < 1:
            raise ValueError("max_slots and prefill_chunk must be positive")
        self.pool = pool
        self.max_slots = max_slots
        self.prefill_chunk = prefill_chunk
        self.clock = clock
        self.waiting: deque[Sequence] = deque()
        self.running: list[Sequence] = []
        self._free_slots = list(range(max_slots))
        heapq.heapify(self._free_slots)
        self._seqno = 0
        self.tick = 0  # schedule() calls; the thrash backoff's clock
        self.num_admitted = 0
        self.num_preemptions = 0
        self.num_evicted_blocks = 0
        self.num_thrash = 0

    # ------------------------------------------------------------- state
    def has_work(self) -> bool:
        return bool(self.waiting or self.running)

    # --------------------------------------------------------- admission
    def add(self, seq: Sequence) -> None:
        seq.phase = Phase.WAITING
        seq.t_enqueue = self.clock()
        self.waiting.append(seq)

    def _admit(self) -> None:
        while self.waiting and self._free_slots:
            seq = self.waiting[0]
            if seq.readmit_after_tick > self.tick and self.running:
                return  # thrash backoff: head sits out this tick (FCFS
                # still holds — nobody skips it); ignored when nothing
                # is running, which would turn backoff into deadlock
            got = self.pool.alloc(self.pool.blocks_for(len(seq.prefill_tokens)))
            if got is None:
                return  # FCFS: the head waits for blocks, nobody skips it
            self.waiting.popleft()
            reg = obs.registry()
            reg.histogram("serving_queue_wait_s",
                          help="waiting-queue residency per admission"
                          ).observe(max(0.0, self.clock() - seq.t_enqueue))
            p95 = reg.histogram("serving_queue_wait_s").percentile(95)
            if p95 is not None:
                reg.gauge("serving_queue_wait_p95_s",
                          help="p95 queue wait (admission-time estimate)"
                          ).set(p95)
            seq.blocks = got
            seq.slot = heapq.heappop(self._free_slots)
            seq.phase = Phase.PREFILL
            seq.prefill_pos = 0
            seq.admit_seqno = self._seqno
            self._seqno += 1
            self.num_admitted += 1
            self.running.append(seq)
            reg.counter("serving_admissions_total",
                        help="sequences admitted to a decode slot").inc()
            obs.tracer().instant("scheduler.admit", cat="serving",
                                 rid=seq.req.rid, slot=seq.slot,
                                 blocks=len(seq.blocks))

    # -------------------------------------------------------- scheduling
    def schedule(self):
        """Pick this iteration's work: ('prefill', seq, start, end) for one
        chunk, ('decode', seqs) for a batch iteration, or None when idle."""
        self.tick += 1
        self._admit()
        pre = [s for s in self.running if s.phase is Phase.PREFILL]
        if pre:
            seq = min(pre, key=lambda s: s.admit_seqno)
            start = seq.prefill_pos
            end = min(start + self.prefill_chunk, len(seq.prefill_tokens))
            return ("prefill", seq, start, end)
        dec = sorted((s for s in self.running if s.phase is Phase.DECODE),
                     key=lambda s: s.admit_seqno)
        if dec:
            return ("decode", dec)
        return None

    # -------------------------------------------- block growth / eviction
    def grow_for_decode(self, seq: Sequence) -> bool:
        """Ensure ``seq`` owns blocks for all ``num_tokens`` positions,
        evicting latest-admitted sequences on pool exhaustion.  Returns
        False iff ``seq`` itself was the victim (skip its decode)."""
        need = self.pool.blocks_for(seq.num_tokens)
        while len(seq.blocks) < need:
            got = self.pool.alloc(need - len(seq.blocks))
            if got is not None:
                seq.blocks.extend(got)
                return True
            victim = max(self.running, key=lambda s: s.admit_seqno)
            self.preempt(victim)
            if victim is seq:
                return False
        return True

    def preempt(self, victim: Sequence) -> None:
        self.num_preemptions += 1
        victim.preemptions += 1
        self.num_evicted_blocks += len(victim.blocks)
        reg = obs.registry()
        reg.counter("serving_preemptions_total",
                    help="sequences evicted on pool exhaustion").inc()
        reg.counter("serving_evicted_blocks_total",
                    help="KV blocks freed by preemption").inc(
                        len(victim.blocks))
        obs.tracer().instant("scheduler.preempt", cat="serving",
                             rid=victim.req.rid,
                             blocks=len(victim.blocks),
                             generated=len(victim.generated))
        victim.t_last_token = None  # next gap is requeue, not decode cadence
        self.pool.free(victim.blocks)
        victim.blocks = []
        heapq.heappush(self._free_slots, victim.slot)
        victim.slot = -1
        victim.phase = Phase.WAITING
        victim.prefill_pos = 0
        self.running.remove(victim)
        if victim.preemptions >= THRASH_AFTER:
            # exponential re-admission backoff, doubling per further
            # preemption; under sustained pressure the victim waits out
            # enough ticks for whoever kept evicting it to finish
            backoff = min(2 ** (victim.preemptions - THRASH_AFTER + 1),
                          MAX_BACKOFF_TICKS)
            victim.readmit_after_tick = self.tick + backoff
            self.num_thrash += 1
            reg.counter(
                "scheduler_preempt_thrash_total",
                help="preemptions that tripped the re-admission backoff"
            ).inc()
        # victims are picked newest-first, so appendleft keeps the waiting
        # queue sorted by original admission order
        victim.t_enqueue = self.clock()
        self.waiting.appendleft(victim)

    # --------------------------------------------------------- completion
    def finish(self, seq: Sequence) -> None:
        self.pool.free(seq.blocks)
        seq.blocks = []
        heapq.heappush(self._free_slots, seq.slot)
        seq.slot = -1
        seq.phase = Phase.FINISHED
        self.running.remove(seq)

    def remove(self, seq: Sequence) -> None:
        """Release a sequence from wherever it lives — the cancel /
        shed / disconnect path.  Frees blocks + slot when admitted,
        drops it from the waiting queue otherwise; idempotent on
        sequences already out of the scheduler."""
        if seq in self.running:
            self.finish(seq)
            return
        try:
            self.waiting.remove(seq)
        except ValueError:
            pass
        seq.phase = Phase.FINISHED
