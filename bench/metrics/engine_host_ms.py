"""Median self time of the ``tick`` spans (repro_torch.tracing) of the
window's unprofiled ticks that prefilled nothing: the tick less its
``decode.forward`` and ``decode.read`` spans, the engine's own host time
(the decode inputs from Python lists, sampling and its read, slot
bookkeeping, the closing synchronise), in ms.  None for a program
without the tracer, or when its buffer no longer holds the window."""
from benchlib import stats as C


def read(run):
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    ticks = tracing.TRACER.ticks([(t.start, t.end) for t in C.untraced(run)])
    if ticks is None:
        return None
    return C.pct([tracing.self_ns(tick, under) / 1e6 for tick, under in ticks
                  if not tick.attrs["n_prefill"] and tick.attrs["n_decode"]],
                 50)
