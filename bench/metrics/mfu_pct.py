"""The whole step's share of the chip's float32 peak: the operations the
window's unprofiled ticks needed (benchlib.counts) over their seconds on
the host clock times 495 TFLOP/s."""
from benchlib.peaks import FLOAT32_FLOPS


def read(run):
    ticks = [t for t in run.ticks if not t.profiled]
    secs = sum(t.end - t.start for t in ticks)
    if secs <= 0:
        return None
    return 100.0 * sum(t.flops for t in ticks) / secs / FLOAT32_FLOPS
