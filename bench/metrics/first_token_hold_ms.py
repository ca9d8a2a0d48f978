"""p75, over the admissions of the window's unprofiled ticks, of the time
a first token waits in the engine: the end of its ``tick`` span less the
end of its ``admit`` span (repro_torch.tracing), in ms.  None for a
program without the tracer, or when its buffer no longer holds the
window."""
from benchlib import stats as C


def read(run):
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    ticks = tracing.TRACER.ticks([(t.start, t.end) for t in C.untraced(run)])
    if ticks is None:
        return None
    return C.pct([(tick.end_ns - s.end_ns) / 1e6 for tick, under in ticks
                  for s in under if s.name == "admit"], 75)
