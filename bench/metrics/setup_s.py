"""Process start to the window's opening: import, weights, warm-up and the
first tick's prefills."""


def read(run):
    return run.setup_s
