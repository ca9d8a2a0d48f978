"""Median, over the window's unprofiled ticks that prefilled nothing, of
the tick's ``decode.forward`` spans (repro_torch.tracing): the host
inside ``LM.decode_step`` until it returns, the enqueue of every layer's
work, in ms.  Once the device's launch queue is full the enqueue waits
for the device, so this is the host's cost only where the device keeps
up.  None for a program without the tracer, or when its buffer
no longer holds the window."""
from benchlib import stats as C


def read(run):
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    ticks = tracing.TRACER.ticks([(t.start, t.end) for t in C.untraced(run)])
    if ticks is None:
        return None
    return C.pct([sum(s.ns for s in under if s.name == "decode.forward")
                   / 1e6 for tick, under in ticks
                   if not tick.attrs["n_prefill"] and tick.attrs["n_decode"]],
                 50)
