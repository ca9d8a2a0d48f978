"""The 95th percentile of every gap, inside the window, between successive
ticks that gave a request new tokens (one gap a tick, after its first)."""
from benchlib import stats as C


def read(run):
    gaps = [g * 1e3 for r in run.requests.values() for end, g in r.gaps
            if end <= run.t_close and end - g >= run.t_open]
    return C.pct(gaps, 95)
