"""The readers of the program's spans and counters (``admit_ms``,
``first_token_hold_ms``, ``prefill_pad_pct``, ``decode_launch_ms``,
``engine_host_ms``) on a traced CPU run of the small cell: each reports,
the padded share is the one the run's own requests and the mix's buckets
give, a request's time to first token holds its admission and its hold,
and each reader finds nothing, without raising, in a program without the
tracer or once its buffer has dropped the window."""

import math
import sys

import pytest
import torch

from bench_small import SMALL_PROFILE, small_config, small_mix
from benchlib import runner, spec

BENCH = spec.load()
SPAN_METRICS = ("admit_ms", "first_token_hold_ms", "prefill_pad_pct",
                "decode_launch_ms", "engine_host_ms")


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """One traced run of the small cell (the program's plan cache in a
    directory of its own, one torch thread): its result line and its
    record."""
    from repro_torch import pipeline
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_TORCH_KERNEL_CACHE",
                  str(tmp_path_factory.mktemp("cache")))
        pipeline.reset_default_cache()
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        keep = {}
        try:
            out = runner.run_cell(BENCH, "qwen2-7b.chat", 23, 4.0, True,
                                  device="cpu", cfg=small_config("qwen2-7b"),
                                  mix=small_mix(), log=lambda msg: None,
                                  keep=keep, profile=SMALL_PROFILE)
        finally:
            torch.set_num_threads(threads)
            pipeline.reset_default_cache()
    return out, keep["run"]


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_traced_run_reports_it(traced, name):
    out, run = traced
    assert out["correct"] is True
    m = out["metrics"][name]
    assert math.isfinite(m["value"]) and m["value"] >= 0
    assert m["unit"] == next(x["unit"] for x in BENCH["per_layer"]
                             if x["name"] == name)


def test_pad_share_is_the_requests_own(traced):
    out, run = traced
    buckets = small_mix()["engine"]["prompt_buckets"]
    lens = [n for t in run.ticks if not t.profiled for n in t.prefill_lens]
    padded = [min(b for b in buckets if b >= n) for n in lens]
    assert lens
    want = 100.0 * sum(b - n for b, n in zip(padded, lens)) / sum(padded)
    assert out["metrics"]["prefill_pad_pct"]["value"] == pytest.approx(
        want, rel=1e-12)


def test_time_to_first_token_holds_admission_and_hold(traced):
    from repro_torch import tracing
    out, run = traced
    ticks = tracing.TRACER.ticks([(t.start, t.end) for t in run.ticks])
    admits = {s.rid: (tick, s) for tick, under in ticks for s in under
              if s.name == "admit"}
    inside = [r for r in run.requests.values()
              if run.t_open <= r.sent and r.first is not None
              and r.first <= run.t_close]
    assert inside
    for r in inside:
        tick, admit = admits[r.rid]
        # the admission plus the first token's hold in the engine
        assert r.first - r.sent >= (tick.end_ns - admit.start_ns) / 1e9


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_reader_finds_nothing_past_the_buffer(traced, monkeypatch, name):
    from repro_torch import tracing
    out, run = traced
    held = tracing.Tracer()
    held.spans.extend(tracing.TRACER.spans)
    assert spec.reader(name)(run) is not None
    held.horizon_ns = math.floor(run.ticks[0].start * 1e9)
    monkeypatch.setattr(tracing, "TRACER", held)
    assert spec.reader(name)(run) is None


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_reader_finds_nothing_without_the_tracer(traced, monkeypatch, name):
    import repro_torch
    out, run = traced
    monkeypatch.delattr(repro_torch, "tracing")
    monkeypatch.setitem(sys.modules, "repro_torch.tracing", None)
    assert spec.reader(name)(run) is None
