"""Shared by the metric readers (``bench/metrics``): percentiles and the
window's tick sets."""

import numpy as np


def pct(values, q):
    """The ``q``-th percentile (linear between order statistics), or None
    for no values."""
    return float(np.percentile(np.asarray(values, float), q)) \
        if len(values) else None


def untraced(run):
    """The window's ticks the profiler did not run over."""
    return [t for t in run.ticks if not t.profiled]


def decode_tick_ms(run):
    walls = [t.wall_ms for t in untraced(run) if t.n_prefill == 0
             and t.n_decode]
    return pct(walls, 50)


def roofline(run, prefill: bool):
    from benchlib.peaks import bound_s
    if not run.traced:
        return None
    pairs = [(t, s) for t, s in run.traced if bool(t.n_prefill) == prefill
             and t.tokens]
    busy = sum(s.busy_ns for _, s in pairs) / 1e9
    if not pairs or busy <= 0:
        return None
    return 100.0 * sum(bound_s(t.flops, t.bytes) for t, _ in pairs) / busy
