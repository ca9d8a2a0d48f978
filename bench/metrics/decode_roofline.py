"""The work's roofline share on the profiled ticks that prefilled
nothing: the sum of each tick's bound (benchlib.counts, benchlib.peaks)
over the sum of its device-busy time."""
from benchlib import stats as C


def read(run):
    return C.roofline(run, prefill=False)
