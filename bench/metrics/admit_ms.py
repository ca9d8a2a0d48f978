"""Median ``admit`` span (repro_torch.tracing) of the window's unprofiled
ticks: one request's admission in ``Engine._admit``, from its bucket and
padding through ``LM.prefill``, the finite check, the cache insert and
the first sample, in ms.  None for a program without the tracer, or when
its buffer no longer holds the window."""
from benchlib import stats as C


def read(run):
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    ticks = tracing.TRACER.ticks([(t.start, t.end) for t in C.untraced(run)])
    if ticks is None:
        return None
    return C.pct([s.ns / 1e6 for _, under in ticks for s in under
                  if s.name == "admit"], 50)
