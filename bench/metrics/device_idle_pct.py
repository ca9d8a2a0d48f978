"""The device's idle share of a decode-only tick: one less the mean
device-busy time of the profiled decode-only ticks over the mean length,
on the host clock, of the window's unprofiled decode-only ticks.

The profiler's host activity slows the host (it doubles the host-bound
MoE's tick), so the profiled ticks' own length would read the profiler's
overhead; the device time of their operations does not change with it,
and the length is taken from ticks that it did not run over."""
from benchlib import stats as C


def read(run):
    if not run.traced:
        return None
    busy = [s.busy_ns / 1e9 for t, s in run.traced
            if not t.n_prefill and t.n_decode]
    wall = [t.end - t.start for t in C.untraced(run)
            if not t.n_prefill and t.n_decode]
    if not busy or not wall or sum(busy) <= 0:
        return None
    return 100.0 * (1.0 - (sum(busy) / len(busy)) / (sum(wall) / len(wall)))
