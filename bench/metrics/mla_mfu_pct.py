"""The whole step's share of the chip's float32 peak, as ``mfu_pct``
defines it, with the operations of an MLA and DeepSeek-MoE model
(``benchlib.counts_mla``): the operations the window's unprofiled ticks
needed over their seconds on the host clock times 495 TFLOP/s."""
from benchlib import counts_mla
from benchlib.peaks import FLOAT32_FLOPS


def read(run):
    ticks = [t for t in run.ticks if not t.profiled]
    secs = sum(t.end - t.start for t in ticks)
    if secs <= 0:
        return None
    shape = counts_mla.config_shape()
    ops = sum(counts_mla.tick_work(shape, t.prefill_lens, t.decode_ctx)[0]
              for t in ticks)
    return 100.0 * ops / secs / FLOAT32_FLOPS
