"""Tokens delivered in the window (each prefill's first token included) over
the window's seconds."""


def read(run):
    if run.window_s <= 0:
        return None
    return sum(t.tokens for t in run.ticks) / run.window_s
