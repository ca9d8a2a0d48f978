"""Median, over the window's unprofiled ticks that prefilled, of the tick's
wall_ms less decode_tick_ms, a prefill."""
from benchlib import stats as C


def read(run):
    dec = C.decode_tick_ms(run)
    if dec is None:
        return None
    per = [(t.wall_ms - dec) / t.n_prefill for t in C.untraced(run)
           if t.n_prefill]
    return C.pct(per, 50)
