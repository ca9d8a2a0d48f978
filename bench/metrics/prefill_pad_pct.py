"""The padded share of prefill positions in the window's unprofiled
ticks: 100 x the sum of (bucket_tokens - prompt_tokens) over the sum of
bucket_tokens, the counters of each ``admit`` span (repro_torch.tracing).
None for a program without the tracer, or when its buffer no longer
holds the window."""
from benchlib import stats as C


def read(run):
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    ticks = tracing.TRACER.ticks([(t.start, t.end) for t in C.untraced(run)])
    if ticks is None:
        return None
    admits = [s.attrs for _, under in ticks for s in under
              if s.name == "admit"]
    bucket = sum(a["bucket_tokens"] for a in admits)
    if not bucket:
        return None
    return 100.0 * sum(a["bucket_tokens"] - a["prompt_tokens"]
                       for a in admits) / bucket
