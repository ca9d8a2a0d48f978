"""The 75th percentile, over every request sent inside the window, of the
time from its sending to the end of the tick that first gave it a token.
The highest percentile with ten requests or more beyond it in every
cell's window (the MoE's holds 41 to 56)."""
from benchlib import stats as C


def read(run):
    ttft = [(r.first - r.sent) * 1e3 for r in run.requests.values()
            if run.t_open <= r.sent < run.t_close and r.first is not None]
    return C.pct(ttft, 75)
