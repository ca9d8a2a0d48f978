"""Median StepRecord.wall_ms of the window's unprofiled ticks that
prefilled nothing."""
from benchlib import stats as C


def read(run):
    return C.decode_tick_ms(run)
