"""The padded share of the rows the held experts computed in the window's
unprofiled decode-only ticks: 100 x (1 - the sum of ``moe_assigned`` over
the sum of ``moe_rows``), the counters of each decode tick's ``tick``
span (repro_torch.tracing): the drop-free buffer gives every held expert
every decode row, of which only the rows routed to it are of use.  None
for a program without these counters, or when the tracer's buffer no
longer holds the window."""
from benchlib import stats as C


def read(run):
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    ticks = tracing.TRACER.ticks([(t.start, t.end) for t in C.untraced(run)])
    if ticks is None:
        return None
    attrs = [tick.attrs for tick, _ in ticks
             if not tick.attrs["n_prefill"] and "moe_rows" in tick.attrs]
    rows = sum(a["moe_rows"] for a in attrs)
    if not rows:
        return None
    return 100.0 * (1.0 - sum(a["moe_assigned"] for a in attrs) / rows)
