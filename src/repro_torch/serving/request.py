"""Request/sequence dataclasses for the continuous-batching engine; a
copy of repro.serving.request (the port imports nothing of the reference).

A ``Request`` is what a client submits (prompt tokens, budget, sampling
knobs, arrival time).  A ``Sequence`` is the engine's mutable view of one
admitted request: its generated tokens, the KV blocks it owns, where its
chunked prefill has got to, and per-request latency metrics.  Preemption
resets a sequence to WAITING with ``prefill_pos = 0`` — its next
admission re-prefills prompt + already-generated tokens, which chunked
prefill makes token-exact, so evicted sequences resume losslessly.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field


class Phase(enum.Enum):
    WAITING = "waiting"    # queued (never admitted, or preempted)
    PREFILL = "prefill"    # admitted; prompt chunks still being ingested
    DECODE = "decode"      # one token per engine decode iteration
    FINISHED = "finished"


@dataclass(frozen=True)
class Request:
    rid: int
    prompt: tuple[int, ...]
    max_new_tokens: int
    temperature: float = 0.0  # 0 -> greedy (token-identical to the
    # static generate path); > 0 -> host-side categorical sampling
    arrival_time: float = 0.0  # seconds after engine start (simulation)
    # SLO deadlines, both relative to arrival (None = no deadline).
    # Exceeding one cancels the request cleanly (status 'deadline') —
    # it never silently queues forever.
    deadline_s: float | None = None       # total latency budget
    ttft_deadline_s: float | None = None  # first-token budget

    def __post_init__(self):
        if len(self.prompt) == 0:
            raise ValueError(f"request {self.rid}: empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError(f"request {self.rid}: max_new_tokens < 1")
        for name in ("deadline_s", "ttft_deadline_s"):
            v = getattr(self, name)
            if v is not None and v <= 0:
                raise ValueError(f"request {self.rid}: {name} must be > 0")


@dataclass
class Sequence:
    req: Request
    generated: list[int] = field(default_factory=list)
    blocks: list[int] = field(default_factory=list)  # owned pool block ids
    phase: Phase = Phase.WAITING
    slot: int = -1            # decode-batch row while admitted
    prefill_pos: int = 0      # tokens of ``prefill_tokens`` already ingested
    admit_seqno: int = -1     # admission order; preemption picks the max
    preemptions: int = 0
    t_arrival: float = 0.0
    t_first_token: float | None = None
    t_last_token: float | None = None  # previous token's emit time —
    # inter-token gap source; reset on preemption (the re-prefill gap is
    # queueing, not decode cadence)
    t_finish: float | None = None
    t_enqueue: float = 0.0    # last time it (re-)entered the waiting
    # queue; admit-time queue-wait metrics read it
    readmit_after_tick: int = 0  # preemption-thrash backoff: the
    # scheduler skips admitting this sequence until its tick passes
    # status: 'ok' while live/completed; a terminal failure mode
    # otherwise ('shed' rejected at admission, 'deadline' cancelled on
    # an expired SLO, 'disconnected' client went away, 'quarantined'
    # non-finite logits twice).  Only 'ok' FINISHED sequences carry a
    # full generation.
    status: str = "ok"

    @property
    def prefill_tokens(self) -> list[int]:
        """What (re-)prefill must ingest: prompt ⊕ tokens generated before
        a preemption (empty on first admission)."""
        return list(self.req.prompt) + list(self.generated)

    @property
    def num_tokens(self) -> int:
        return len(self.req.prompt) + len(self.generated)

    @property
    def done(self) -> bool:
        return len(self.generated) >= self.req.max_new_tokens

    def metrics(self) -> dict:
        out = {"rid": self.req.rid,
               "prompt_tokens": len(self.req.prompt),
               "new_tokens": len(self.generated),
               "preemptions": self.preemptions,
               "status": self.status}
        if self.t_first_token is not None:
            out["ttft_s"] = self.t_first_token - self.t_arrival
        if self.t_finish is not None:
            out["latency_s"] = self.t_finish - self.t_arrival
            if len(self.generated) > 1 and self.t_first_token is not None:
                out["intertoken_mean_s"] = (
                    (self.t_finish - self.t_first_token)
                    / (len(self.generated) - 1))
        return out


def detokenize(tokens) -> str:
    """Synthetic-vocab detokenizer (printable ASCII) for streamed output —
    the repo has no real tokenizer; this keeps the streaming API honest."""
    return "".join(chr(33 + int(t) % 94) for t in tokens)


def poisson_stream(n: int, vocab_size: int, *, max_new_tokens: int,
                   rate: float = 0.0, min_prompt: int = 4,
                   max_prompt: int = 24, temperature: float = 0.0,
                   seed: int = 0) -> list[Request]:
    """Deterministic simulated request stream: mixed-length random
    prompts with exponential inter-arrival gaps at ``rate`` req/s
    (rate <= 0: everything arrives at t=0).  Shared by launch.serve and
    benchmarks so arrival semantics can't drift between them."""
    import numpy as np

    rng = np.random.default_rng(seed)
    lens = rng.integers(min_prompt, max_prompt + 1, size=n)
    gaps = (np.zeros(n) if rate <= 0 else rng.exponential(1.0 / rate, n))
    arrivals = np.cumsum(gaps)
    return [Request(rid=i,
                    prompt=tuple(int(t) for t in
                                 rng.integers(0, vocab_size, size=L)),
                    max_new_tokens=max_new_tokens,
                    temperature=temperature,
                    arrival_time=float(a))
            for i, (L, a) in enumerate(zip(lens, arrivals))]
