"""The work's roofline share on the profiled ticks that prefilled: the
sum of each tick's bound (its prefills and its decode rows) over the sum
of its device-busy time."""
from benchlib import stats as C


def read(run):
    return C.roofline(run, prefill=True)
