"""Continuous-batching serving engine over the paged KV pool — the core
loop of repro.serving.engine.

The engine admits a stream of variable-length requests and interleaves
chunked prefill with batched decode through one shared step
(``runtime.serve.paged_step``): a prefill chunk is a (1, C) call and a
decode iteration a (max_slots, 1) call of the same function.  Greedy
outputs are token-identical to the static ``runtime.serve.generate`` path
for the same prompts: chunked prefill is exact, and the paged view masks
slots a sequence does not own to probability exactly 0.

Deliberately not ported here: the reference's step retry, NaN quarantine
and replan to a fallback backend, watchdog, deadlines, shedding and
fault hooks.  Each would hide a failing kernel; they arrive with the
resilience slice.  A failing step raises.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch import kvq
from repro_torch.models.config import ModelConfig
from repro_torch.runtime import serve as SV
from repro_torch.serving import kv_blocks
from repro_torch.serving.kv_blocks import BlockPool
from repro_torch.serving.request import Phase, Request, Sequence, detokenize
from repro_torch.serving.scheduler import Scheduler


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
    for requests with temperature > 0.
    """

    def __init__(self, params, cfg: ModelConfig, *, max_slots: int = 4,
                 block_size: int = 16, num_blocks: int | None = None,
                 max_model_len: int | None = None, prefill_chunk: int = 16,
                 cache_dtype=torch.float32, kv_quant=None,
                 kv_pool_bytes: int | None = None, on_token=None,
                 clock=time.perf_counter, sample_seed: int = 0):
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
        self.max_resident_seqs = 0
        self._intertoken: list[float] = []

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
        return seq

    # -------------------------------------------------------------- step
    def step(self) -> list[Sequence]:
        """One engine iteration (one prefill chunk OR one decode batch).
        Returns the sequences that finished this iteration."""
        done: list[Sequence] = []
        act = self.scheduler.schedule()
        if self.scheduler.num_preemptions == 0:
            self.max_resident_seqs = max(self.max_resident_seqs,
                                         len(self.scheduler.running))
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

    def _run_step(self, tokens, positions, ws, vs, last):
        """One model step on host (numpy) inputs; returns the greedy
        tokens (host) and the logits (device)."""
        dev = self.device
        t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
        with torch.no_grad():
            logits, self.kv = SV.paged_step(
                self.params, self.cfg, t(tokens), self.kv, t(positions),
                t(ws), t(vs), t(last))
        return SV.greedy(logits).cpu().numpy(), logits

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
        tok, logits = self._run_step(tokens, positions, ws, vs, last)
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
        tok, logits = self._run_step(tokens, positions, ws, vs, last)
        self.num_decode_steps += 1
        for seq in active:
            self._append(seq, self._pick(seq, tok[seq.slot],
                                         logits[seq.slot]), done)

    # ---------------------------------------------------------- sampling
    def _pick(self, seq: Sequence, greedy_tok, logits) -> int:
        """Greedy, or the reference's seeded host-side Gumbel sampling (the
        same numpy draws, so sampled tokens match too)."""
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
        seq.generated.append(token)
        if seq.t_first_token is None:
            seq.t_first_token = t
        elif seq.t_last_token is not None:
            self._intertoken.append(t - seq.t_last_token)
        seq.t_last_token = t
        if self.on_token is not None:
            self.on_token(seq.req.rid, token, detokenize([token]))
        if seq.done:
            seq.t_finish = t
            self.scheduler.finish(seq)
            self.finished.append(seq)
            done.append(seq)

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

    # ----------------------------------------------------------- metrics
    def metrics(self) -> dict:
        """Aggregate serving metrics over finished requests.  Every key is
        always present; percentiles are None with nothing measured."""
        fin = self.finished

        def pct(xs, q):
            if len(xs) == 0:
                return None
            return float(np.percentile(np.asarray(xs), q))

        gen = sum(len(s.generated) for s in fin)
        span = (max(s.t_finish for s in fin)
                - min(s.t_arrival for s in fin)) if fin else 0.0
        lat = [s.t_finish - s.t_arrival for s in fin]
        ttft = [s.t_first_token - s.t_arrival for s in fin
                if s.t_first_token is not None]
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
            "intertoken_p50_s": pct(self._intertoken, 50),
            "intertoken_p95_s": pct(self._intertoken, 95),
            "preempt_thrash": self.scheduler.num_thrash,
            "queue_wait_p95_s": pct(self.scheduler.queue_waits, 95),
        }

    def summary(self) -> dict:
        """Alias of :meth:`metrics`."""
        return self.metrics()
