"""Spans and counters of the port's serving loop and model step.

One process-wide :class:`Tracer`, :data:`TRACER`, as ``resilience.METRICS``
and ``cuda_build.STATS`` are.  A span records its name, its start and end
on ``time.perf_counter_ns()`` (the clock a caller's ``time.perf_counter()``
reads, so a caller's own timestamps and the spans line up), its id, its
parent's id (0: none; the span open when it began), the request id
(``rid``) where it belongs to one request, and a few integer attributes
(the counters).  Ids come from the tracer's own counter.  Finished spans go
into a bounded buffer (:data:`CAPACITY`, many times a benchmark window's
spans); when it is full the oldest are dropped, and
:attr:`Tracer.horizon_ns` keeps the newest end among them.

Two kinds of sites:

* **Engine spans** (``launch/engine.py``), recorded always, a few clock
  reads a tick: ``tick`` (a whole engine step; attributes ``n_prefill``
  and ``n_decode``, and where the step decoded on a model with MoE layers
  ``moe_rows``, the rows the held experts computed (on the grouped
  expert kernel each held expert's kept rows, none padded; on the padded
  products held x capacity), and ``moe_assigned``, the active rows'
  (token, k) assignments that landed on held experts, both counted by
  each MoE layer (``layers.moe_apply``), summed over the layers inside
  the decode step and read with the logits' finite check;
  ``StepRecord.wall_ms`` is its duration); ``admit``
  (one request's admission: bucket and padding, ``LM.prefill`` into the
  cache slot, the finite check and the first sample; ``rid``, attributes
  ``prompt_tokens``, ``bucket_tokens`` and ``graph``, 1 where the prefill
  replayed a captured CUDA graph and 0 where it ran eagerly; its end is
  the first token's host time); ``decode.forward`` (the host inside
  the engine's decode step (``LM.decode_step`` and the sum of its MoE
  counts) until it returns: the enqueue of every layer's work,
  which waits for the device once its launch queue is full, or of one
  graph replay; attribute ``graph`` as ``admit``'s);
  ``decode.read`` (the blocking read of the logits' finite check, which
  waits out the device).  The rest of a tick, building the decode inputs
  included, is the ``tick`` span's self time (:func:`self_ns`).
* **Model spans** (:func:`model_span`: ``models/lm.py`` and the emitted
  kernels' launch path in ``core/codegen_cuda.py``): ``record_function``
  ranges named ``RANGE + name``, opened only while a ``torch.profiler``
  session records, so they land on the profiler's own clock among the
  device operations (``launch.profile_decode`` reads them): ``embed``,
  each layer's mixer (``attn``, ``mla``, ``mamba``) and MLP (``swiglu``,
  ``moe``), ``head``, and ``launch`` (an emitted kernel's signature
  lookup, output allocation, pointer array and ctypes call).  With no
  profiler recording a site costs a call and one flag read.

No environment variable or flag turns anything on or off.
"""

from __future__ import annotations

import bisect
import collections
import math
import time
from typing import Dict, List, Optional, Sequence, Tuple

from torch.autograd import profiler as _profiler

#: spans the buffer holds: a 51 s window of 69 ms ticks ends ~3,700
#: engine spans
CAPACITY = 1 << 17
#: the ``record_function`` name prefix of a model span
RANGE = "span:"
#: the model spans of a layer or of the embedding and head (all but
#: ``launch``): the classes ``launch.profile_decode`` splits device time by
MODEL = ("embed", "attn", "mla", "mamba", "swiglu", "moe", "head")


class Span:
    __slots__ = ("name", "start_ns", "end_ns", "id", "parent", "rid",
                 "attrs")

    def __init__(self, name: str, id: int, parent: int, rid: Optional[int],
                 attrs: Dict[str, int]):
        self.name, self.id, self.parent, self.rid = name, id, parent, rid
        self.attrs = attrs
        self.start_ns = self.end_ns = 0

    @property
    def ns(self) -> int:
        return self.end_ns - self.start_ns

    def __repr__(self):
        rid = "" if self.rid is None else f" rid={self.rid}"
        return (f"<Span {self.name} #{self.id} in #{self.parent}{rid} "
                f"{self.ns} ns {self.attrs}>")


class _Scope:
    __slots__ = ("tracer", "span")

    def __init__(self, tracer: "Tracer", span: Span):
        self.tracer, self.span = tracer, span

    def __enter__(self) -> Span:
        return self.span

    def __exit__(self, *exc) -> None:
        self.tracer.end(self.span)


class Tracer:
    """Spans of one process (see the module docstring)."""

    def __init__(self, capacity: int = CAPACITY):
        self.spans: collections.deque = collections.deque(maxlen=capacity)
        self.horizon_ns = -1      # the newest end of a dropped span
        self._ids = 0
        self._open: List[Span] = []

    def begin(self, name: str, rid: Optional[int] = None, **attrs) -> Span:
        """Open a span under the innermost open one; :meth:`end` records
        it, :meth:`discard` drops it."""
        self._ids += 1
        span = Span(name, self._ids, self._open[-1].id if self._open else 0,
                    rid, attrs)
        self._open.append(span)
        span.start_ns = time.perf_counter_ns()
        return span

    def _close(self, span: Span) -> None:
        # spans opened inside it and never ended close with it
        if self._open and self._open[-1] is span:
            self._open.pop()
        elif span in self._open:
            del self._open[self._open.index(span):]

    def end(self, span: Span, **attrs) -> Span:
        """Close ``span``, add ``attrs`` to it and record it."""
        span.end_ns = time.perf_counter_ns()
        if attrs:
            span.attrs.update(attrs)
        self._close(span)
        if len(self.spans) == self.spans.maxlen:
            self.horizon_ns = self.spans[0].end_ns
        self.spans.append(span)
        return span

    def discard(self, span: Span) -> None:
        """Close ``span`` without recording it."""
        self._close(span)

    def span(self, name: str, rid: Optional[int] = None, **attrs) -> _Scope:
        """``with tracer.span(name): ...``: :meth:`begin` and :meth:`end`
        around the block (an exception ends it too)."""
        return _Scope(self, self.begin(name, rid, **attrs))

    def ticks(self, windows: Sequence[Tuple[float, float]]
              ) -> Optional[List[Tuple[Span, List[Span]]]]:
        """The ``tick`` spans inside each window ``(start, end)`` of
        ``time.perf_counter()`` seconds, each with the spans under it, in
        the windows' order; None where the buffer has dropped a span that
        ended after the first window opened (its spans may be gone)."""
        if not windows:
            return []
        if self.horizon_ns >= math.floor(min(w[0] for w in windows) * 1e9):
            return None
        spans = list(self.spans)           # in the order they ended
        ends = [s.end_ns for s in spans]
        out = []
        for lo_s, hi_s in windows:
            lo, hi = math.floor(lo_s * 1e9), math.ceil(hi_s * 1e9)
            inside = [s for s in spans[bisect.bisect_left(ends, lo):
                                       bisect.bisect_right(ends, hi)]
                      if s.start_ns >= lo]
            by_id = {s.id: s for s in inside}
            for tick in (s for s in inside if s.name == "tick"):
                out.append((tick, [s for s in inside
                                   if _under(s, tick.id, by_id)]))
        return out


def _under(span: Span, root: int, by_id: Dict[int, Span]) -> bool:
    while span.parent in by_id:
        if span.parent == root:
            return True
        span = by_id[span.parent]
    return False


def self_ns(span: Span, spans: Sequence[Span]) -> int:
    """``span``'s duration less the part of it that its children among
    ``spans`` cover."""
    covered, end = 0, span.start_ns
    for s, e in sorted((max(c.start_ns, span.start_ns),
                        min(c.end_ns, span.end_ns))
                       for c in spans if c.parent == span.id):
        if e > end:
            covered += e - max(s, end)
            end = e
    return span.ns - covered


TRACER = Tracer()


def recording() -> bool:
    """Whether a ``torch.profiler`` session records (one flag read)."""
    return _profiler._is_profiler_enabled


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc) -> None:
        return None


_OFF = _Off()


def model_span(name: str):
    """A ``record_function`` range ``RANGE + name`` while a profiler
    records; a no-op context otherwise (one flag read)."""
    if _profiler._is_profiler_enabled:
        return _profiler.record_function(RANGE + name)
    return _OFF


def main() -> dict:
    """``python -m repro_torch.tracing``: the host cost of the spans, a
    CPU microbenchmark.  Prints, in ns, one decode tick's engine spans
    (``tick``, ``decode.forward``, ``decode.read``), an admission's
    ``admit`` span, and a model span site with no profiler recording."""
    import json
    import timeit
    number = 200_000
    tracer = Tracer()

    def tick():
        t = tracer.begin("tick")
        with tracer.span("decode.forward"):
            pass
        with tracer.span("decode.read"):
            pass
        tracer.end(t, n_prefill=0, n_decode=32)

    def admit():
        s = tracer.begin("admit", 1, prompt_tokens=57)
        s.attrs["bucket_tokens"] = 64
        tracer.end(s)

    def site():
        with model_span("swiglu"):
            pass

    def bare():
        pass

    out = {}
    for name, fn in (("decode_tick_spans", tick), ("admit_span", admit),
                     ("model_span_site_off", site), ("empty_call", bare)):
        best = min(timeit.repeat(fn, number=number, repeat=5))
        out[f"{name}_ns"] = best / number * 1e9
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
