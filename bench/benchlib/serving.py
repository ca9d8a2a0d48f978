"""The serving loop around the program's engine, and what each request
saw.

One tick is one ``Engine.run(arrivals, max_steps=1)`` call, carrying the
requests sent since the last tick (each with ``arrival_step=0``); the
engine's slots and queue persist between calls.  After each tick the
harness stamps the tick's end on every token a request got in it: the
tokens of a running request are its ``Engine.slots`` entry's
``generated``, those of a finished one ``ServeReport.tokens``.  When
requests are sent is the traffic source's to decide (``traffic/gen.py``:
``start``, then ``after_tick`` with the clients whose requests finished).
(The engine offers no submit/step pair and no per-token timestamps:
calling ``run`` once per tick and reading the slots is the only way in.)
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from benchlib.counts import ModelShape, tick_work


@dataclass
class Request:
    rid: int
    client: int
    prompt: tuple
    max_new_tokens: int
    sent: float
    first: Optional[float] = None     # end of the tick of its first token
    last: Optional[float] = None      # end of the last tick that gave one
    n: int = 0                        # tokens seen so far
    tokens: Optional[List[int]] = None  # all of them, once finished
    # (end of the tick, seconds since the tick before that gave one)
    gaps: List[tuple] = field(default_factory=list)


@dataclass
class Tick:
    index: int
    start: float
    end: float
    wall_ms: float          # the engine's own StepRecord.wall_ms
    n_prefill: int
    n_decode: int
    tokens: int             # tokens delivered by this tick
    prefill_lens: List[int]
    decode_ctx: List[int]
    flops: float = 0.0
    bytes: float = 0.0
    profiled: bool = False


class Loop:
    """Drives ``engine`` with the requests of ``traffic`` (a mix's
    ``Source``, ``traffic.gen.source``)."""

    def __init__(self, engine, traffic, shape: ModelShape,
                 clock: Callable[[], float] = time.perf_counter):
        from repro_torch.launch.engine import Request as EngineRequest
        self._req_cls = EngineRequest
        self.engine, self.traffic, self.shape = engine, traffic, shape
        self.clock = clock
        self.requests: Dict[int, Request] = {}
        self.pending: List[Request] = []
        self.ticks: List[Tick] = []
        self.failures: List[dict] = []

    def send(self, req, now: float) -> None:
        r = Request(req.rid, req.client, req.prompt, req.max_new_tokens,
                    sent=now)
        self.requests[r.rid] = r
        self.pending.append(r)

    def start(self) -> None:
        for req, sent in self.traffic.start(self.clock()):
            self.send(req, sent)

    def idle(self) -> bool:
        """Nothing to send the engine and nothing in it: a tick would do
        no work (an open loop between arrivals)."""
        eng = self.engine
        return not (self.pending or eng.queue
                    or any(s is not None for s in eng.slots))

    def poll(self) -> None:
        """While idle: take what the traffic sent meanwhile."""
        for req, sent in self.traffic.after_tick(self.clock(), []):
            self.send(req, sent)

    def tick(self, profiled: bool = False) -> Tick:
        """One engine step (the loop is not idle)."""
        eng = self.engine
        batch = [self._req_cls(rid=r.rid, prompt=r.prompt,
                               max_new_tokens=r.max_new_tokens,
                               arrival_step=0) for r in self.pending]
        self.pending = []
        t0 = self.clock()
        rep = eng.run(batch, max_steps=1)
        t1 = self.clock()
        self.failures.extend(rep.failures)
        seen = {s.rid: s.generated for s in eng.slots if s is not None}
        done = rep.tokens
        prefill_lens, decode_ctx, delivered = [], [], 0
        for rid, toks in list(seen.items()) + list(done.items()):
            r = self.requests[rid]
            new = len(toks) - r.n
            if new <= 0:
                continue
            decoded = new
            if r.n == 0:                  # admitted in this tick
                prefill_lens.append(len(r.prompt))
                r.first = t1
                decoded -= 1              # the prefill's own token
            else:
                r.gaps.append((t1, t1 - r.last))
            if decoded:                   # one decode row: token j of a
                # prompt of P attends P + j positions
                decode_ctx.append(len(r.prompt) + len(toks) - 1)
            r.n, r.last = len(toks), t1
            delivered += new
        for rid, toks in done.items():
            self.requests[rid].tokens = list(toks)
        for req, sent in self.traffic.after_tick(
                t1, [self.requests[rid].client for rid in done]):
            self.send(req, sent)
        step = rep.per_step[0]
        t = Tick(index=len(self.ticks), start=t0, end=t1,
                 wall_ms=step.wall_ms, n_prefill=step.n_prefill,
                 n_decode=step.n_decode, tokens=delivered,
                 prefill_lens=prefill_lens, decode_ctx=decode_ctx,
                 profiled=profiled)
        t.flops, t.bytes = tick_work(self.shape, prefill_lens, decode_ctx)
        self.ticks.append(t)
        return t

    def finished(self) -> Dict[int, Request]:
        return {rid: r for rid, r in self.requests.items()
                if r.tokens is not None}
