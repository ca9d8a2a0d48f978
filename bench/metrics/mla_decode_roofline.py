"""The work's roofline share on the profiled ticks that prefilled
nothing, as ``decode_roofline`` defines it, with the work of an MLA and
DeepSeek-MoE model (``benchlib.counts_mla``): the sum of each tick's
bound (``benchlib.peaks``) over the sum of its device-busy time."""
from benchlib import counts_mla
from benchlib.peaks import bound_s


def read(run):
    if not run.traced:
        return None
    pairs = [(t, s) for t, s in run.traced if not t.n_prefill and t.tokens]
    busy = sum(s.busy_ns for _, s in pairs) / 1e9
    if not pairs or busy <= 0:
        return None
    shape = counts_mla.config_shape()
    return 100.0 * sum(bound_s(*counts_mla.tick_work(
        shape, t.prefill_lens, t.decode_ctx)) for t, _ in pairs) / busy
