"""The port's tracer (``repro_torch.tracing``) on the CPU.

* the engine's spans nest under their ``tick`` with the right parent ids,
  and a request's ``admit`` span carries its id;
* a ``tick`` span's duration is the step's ``StepRecord.wall_ms``;
* an MoE engine's ``tick`` counts ``moe_assigned`` as the router's own
  choice does and ``moe_rows`` as MoE layers x held experts x capacity;
* self time, the bounded buffer and the window query;
* model spans record nothing without a profiler, and under a CPU
  ``torch.profiler`` each is a range that holds its ``aten::`` ops (and
  nothing in the tracer).
"""

import dataclasses
import math

import pytest
import torch

from repro_torch import tracing as T
from repro_torch.launch import serve as S
from repro_torch.launch.engine import Engine, Request
from repro_torch.models import layers as L
import torch_port  # noqa: F401

TINY = dict(reduced=True, n_layers=2, backend="cuda", device="cpu",
            max_batch=3, max_len=48, prompt_buckets=(8, 16), n_requests=6,
            arrival_rate=1.5, prompt_lens=(3, 14), gen_lens=(2, 6), seed=3)


@pytest.fixture
def tracer(monkeypatch):
    """A tracer of the test's own in place of the process's."""
    t = T.Tracer()
    monkeypatch.setattr(T, "TRACER", t)
    return t


@pytest.fixture(scope="module")
def served():
    """A warmed tiny engine, its trace and its report, and the spans of
    its run (a tracer of its own)."""
    cfg = S.ServeConfig(**TINY)
    engine = S.build_engine(cfg)
    engine.warmup()
    trace = S.trace_for(cfg, engine.cfg.vocab)
    saved, T.TRACER = T.TRACER, T.Tracer()
    try:
        report = engine.run(trace)
        spans = list(T.TRACER.spans)
    finally:
        T.TRACER = saved
    return engine, trace, report, spans


def _span(name, start, end, id, parent=0):
    s = T.Span(name, id, parent, None, {})
    s.start_ns, s.end_ns = start, end
    return s


def test_engine_spans_nest_under_their_tick(served):
    engine, trace, report, spans = served
    by_id = {s.id: s for s in spans}
    ticks = [s for s in spans if s.name == "tick"]
    assert len(ticks) == report.steps
    assert {s.name for s in spans} == {"tick", "admit", "decode.forward",
                                       "decode.read"}
    assert all(t.parent == 0 for t in ticks)
    for s in spans:
        if s.name == "tick":
            continue
        tick = by_id[s.parent]
        assert tick.name == "tick"
        assert tick.start_ns <= s.start_ns <= s.end_ns <= tick.end_ns
    for tick in ticks:
        under = [s for s in spans if s.parent == tick.id]
        assert sum(s.name == "admit" for s in under) == \
            tick.attrs["n_prefill"]
        forward = [s for s in under if s.name == "decode.forward"]
        read = [s for s in under if s.name == "decode.read"]
        assert len(forward) == len(read) == (tick.attrs["n_decode"] > 0)
        if forward:
            assert forward[0].end_ns <= read[0].start_ns
    # ids from the tracer's own counter: one each, in the order begun
    assert len({s.id for s in spans}) == len(spans)


def test_admit_span_carries_its_request(served):
    engine, trace, report, spans = served
    admits = {s.rid: s for s in spans if s.name == "admit"}
    assert sorted(admits) == sorted(r.rid for r in trace)
    for req in trace:
        a = admits[req.rid]
        assert a.attrs["prompt_tokens"] == len(req.prompt)
        assert a.attrs["bucket_tokens"] == engine._bucket(len(req.prompt))
    # the other spans of a tick belong to no one request
    assert all(s.rid is None for s in spans if s.name != "admit")


def test_tick_span_is_the_step_record(served):
    engine, trace, report, spans = served
    ticks = [s for s in spans if s.name == "tick"]
    ticks.sort(key=lambda s: s.start_ns)
    assert [r.wall_ms for r in report.per_step] == [t.ns / 1e6
                                                    for t in ticks]
    assert [(r.n_prefill, r.n_decode) for r in report.per_step] == [
        (t.attrs["n_prefill"], t.attrs["n_decode"]) for t in ticks]


def test_moe_tick_counts_the_routers_choice(tracer, monkeypatch):
    """A tiny MoE engine holding experts E/4 .. 3E/4 - 1, as one chip of an
    expert-parallel layer: each decoding tick's ``moe_assigned`` is the
    count, over the tick's active rows and the MoE layers, of the router's
    own ``top_ids`` that fall on a held expert, and its ``moe_rows`` is
    MoE layers x held experts x the capacity of ``max_batch`` tokens."""
    cfg = S.ServeConfig(**dict(TINY, arch="qwen3-moe-30b-a3b"))
    mc = S.model_config(cfg)
    base, count = mc.n_experts // 4, mc.n_experts // 2
    mc = dataclasses.replace(mc, expert_share=(base, count))
    engine = Engine(mc, device="cpu", max_batch=cfg.max_batch,
                    max_len=cfg.max_len, prompt_buckets=cfg.prompt_buckets,
                    seed=cfg.seed)
    engine.warmup()
    chosen, active = [], []
    route, inputs = L._route, engine._decode_inputs

    def routed(xn, p, c):
        w, ids = route(xn, p, c)
        chosen.append(ids)
        return w, ids

    def decode_inputs():
        active.append([s is not None for s in engine.slots])
        return inputs()

    monkeypatch.setattr(L, "_route", routed)
    monkeypatch.setattr(engine, "_decode_inputs", decode_inputs)
    report = engine.run(S.trace_for(cfg, mc.vocab))
    assert report.n_completed == cfg.n_requests

    layers = sum(mc.mlp_of(i) == "moe" for i in range(mc.n_layers))
    b = cfg.max_batch
    capacity = min(b, max(1, math.ceil(b * mc.top_k * mc.capacity_factor
                                       / mc.n_experts)))
    # the prefills route a bucket's tokens, a decode step max_batch rows
    assert b not in cfg.prompt_buckets
    decode = [ids for ids in chosen if ids.shape[0] == b]
    ticks = [s for s in tracer.spans if s.name == "tick"
             and s.attrs["n_decode"]]
    assert layers and len(decode) == layers * len(ticks) == \
        layers * len(active)
    got, want = [], []
    for t, (tick, rows) in enumerate(zip(ticks, active)):
        ids = torch.stack(decode[t * layers:(t + 1) * layers])
        held = ((ids >= base) & (ids < base + count)).sum((0, 2))
        assert tick.attrs["moe_rows"] == layers * count * capacity
        got.append(tick.attrs["moe_assigned"])
        want.append(int(held[torch.tensor(rows)].sum()))
    assert got == want
    # the count sees the held experts: some assignments fall elsewhere
    assert 0 < sum(got) < layers * mc.top_k * sum(map(sum, active))


def test_rejected_request_leaves_no_admit_span(tracer):
    engine = S.build_engine(S.ServeConfig(**dict(TINY, n_requests=0)))
    report = engine.run([Request(0, tuple(range(20)), 4, 0),  # no bucket
                         Request(1, (1, 2, 3), 3, 0)])
    assert report.n_rejected == 1
    assert [s.rid for s in tracer.spans if s.name == "admit"] == [1]
    assert not tracer._open


def test_spans_nest_by_the_open_span(tracer):
    with tracer.span("tick") as tick:
        a = tracer.begin("admit", 7, prompt_tokens=3)
        tracer.end(a, bucket_tokens=8)
        with tracer.span("decode.forward") as f:
            inner = tracer.begin("attn")
        # an inner span left open closes with its parent
    assert [s.name for s in tracer.spans] == ["admit", "decode.forward",
                                              "tick"]
    assert a.parent == f.parent == tick.id and tick.parent == 0
    assert a.rid == 7 and a.attrs == {"prompt_tokens": 3,
                                      "bucket_tokens": 8}
    assert inner not in tracer.spans and not tracer._open


def test_self_time():
    parent = _span("tick", 0, 100, 1)
    kids = [_span("a", 10, 30, 2, 1), _span("b", 20, 50, 3, 1),
            _span("c", 60, 70, 4, 1),
            _span("grandchild", 0, 100, 5, 2),   # not a child: ignored
            _span("other", 80, 95, 6, 9),        # another parent's
            _span("late", 90, 130, 7, 1)]        # clipped to the parent
    # children cover 10-50, 60-70 and 90-100
    assert T.self_ns(parent, kids) == 100 - 40 - 10 - 10
    assert T.self_ns(parent, []) == 100


def test_buffer_drops_the_oldest_and_the_window_query(tracer):
    small = T.Tracer(capacity=4)
    ticks = []
    for _ in range(3):
        with small.span("tick") as t:
            small.end(small.begin("decode.forward"))
        ticks.append(t)
    # six spans in a buffer of four: the first tick and its child dropped
    assert [s.name for s in small.spans] == ["decode.forward", "tick",
                                             "decode.forward", "tick"]
    assert small.horizon_ns == ticks[0].end_ns
    windows = [(t.start_ns / 1e9, t.end_ns / 1e9) for t in ticks]
    assert small.ticks(windows) is None
    got = small.ticks(windows[1:])
    assert [tick for tick, _ in got] == ticks[1:]
    assert [[s.name for s in under] for _, under in got] == [
        ["decode.forward"], ["decode.forward"]]
    assert small.ticks([]) == []


def _tiny_lm():
    from repro_torch import configs as C
    from repro_torch.models.lm import LM
    cfg = C.get_reduced_config("smollm-135m", n_layers=2)
    model = LM(cfg)
    params = model.init_params(0, "cpu")
    cache = model.init_cache(2, 16, "cpu")
    return model, params, cache


def _decode(model, params, cache):
    return model.decode_step(params, cache, torch.zeros((2, 1),
                                                        dtype=torch.long),
                             torch.tensor([3, 5]))


def test_model_spans_record_nothing_without_a_profiler(tracer):
    assert not T.recording()
    assert T.model_span("attn") is T.model_span("head")
    model, params, cache = _tiny_lm()
    _decode(model, params, cache)
    assert not tracer.spans


def test_model_spans_hold_their_ops_on_the_profiler_timeline(tracer):
    model, params, cache = _tiny_lm()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        assert T.recording()
        _decode(model, params, cache)
    assert not T.recording()
    names = ["embed", "attn", "swiglu", "attn", "swiglu", "head"]
    # ranges on the profiler's timeline alone: nothing in the tracer
    assert not tracer.spans
    events = prof.events()
    ranges = sorted((e for e in events if e.name.startswith(T.RANGE)),
                    key=lambda e: e.time_range.start)
    assert [e.name[len(T.RANGE):] for e in ranges] == names
    for r in ranges:
        ops = []
        for e in events:
            up = e.cpu_parent
            while up is not None and up is not r:
                up = up.cpu_parent
            if up is r and e.name.startswith("aten::"):
                ops.append(e)
        assert ops, r.name
        for e in ops:
            assert r.time_range.start <= e.time_range.start
            assert e.time_range.end <= r.time_range.end


def test_profile_split_by_span_and_launching_call():
    """``profile_decode.split``: a kernel's class is the model span that
    held the runtime call that launched it (by correlation id), an idle
    stretch's the innermost program span at its midpoint."""
    from repro_torch.launch.profile_decode import TIMED, split
    host = [(0, 1000, TIMED, 0),
            (100, 400, "span:attn", 0),
            (150, 200, "span:launch", 0),
            (160, 170, "cudaLaunchKernelExC", 7),
            (250, 300, "aten::mm", 3),
            (260, 270, "cudaLaunchKernel", 8),
            (500, 900, "span:swiglu", 0),
            (510, 520, "cudaLaunchKernel", 9),
            (950, 960, "cudaMemcpyAsync", 10)]
    device = [(300, 500, "emit_g0", 7), (520, 600, "gemm", 8),
              (600, 800, "emit_g1", 9), (960, 980, "memcpy", 10),
              (985, 990, "lost", 99)]
    out = split(host, device, steps=1)
    ms = 1e-6
    assert out["device_ms_per_step_by_class"] == {
        "attn": {"emit_g0": pytest.approx(200 * ms),
                 "gemm": pytest.approx(80 * ms)},
        "swiglu": {"emit_g1": pytest.approx(200 * ms)},
        "other": {"memcpy": pytest.approx(20 * ms)},
        "unlinked": {"lost": pytest.approx(5 * ms)}}
    assert out["device_busy_ms"] == pytest.approx(505 * ms)
    # idle: 0-300 under launch (midpoint 150), 500-520 and 800-960 under
    # swiglu, 980-985 and 990-1000 outside any span
    assert out["device_idle_ms_per_step_by_span"] == {
        "launch": pytest.approx(300 * ms), "swiglu": pytest.approx(180 * ms),
        "other": pytest.approx(15 * ms)}
    assert list(out["device_ms_per_step_by_kernel"])[:2] == ["emit_g0",
                                                            "emit_g1"]


def test_profile_split_by_product_path():
    """``profile_decode.split`` sums each model span's device time by the
    product path of the emitted kernel that ran (``CudaKernel.
    product_path`` by the name the profiler shows), and every other
    operation under ``NOT_EMITTED``."""
    from repro_torch.launch import profile_decode as PD
    paths = {"emit_region_g1_23_ab": "tc3xtf32", "emit_region_g0_5_cd": "fma"}
    host = [(0, 1000, PD.TIMED, 0),
            (100, 400, "span:attn", 0),
            (160, 170, "cudaLaunchKernel", 7),
            (260, 270, "cudaLaunchKernel", 8),
            (500, 900, "span:swiglu", 0),
            (510, 520, "cudaLaunchKernel", 9),
            (530, 540, "cudaLaunchKernel", 10)]
    device = [(300, 500, "void emit_region_g0_5_cd(KArgs)", 7),
              (520, 600, "gemm", 8),
              (600, 800, "void emit_region_g1_23_ab(KArgs)", 9),
              (800, 850, "emit_region_g1_23_ab", 10)]
    out = PD.split(host, device, steps=2, paths=paths)
    ms = 1e-6 / 2
    assert out["device_ms_per_step_by_product_path"] == {
        "fma": {"attn": pytest.approx(200 * ms)},
        PD.NOT_EMITTED: {"attn": pytest.approx(80 * ms)},
        "tc3xtf32": {"swiglu": pytest.approx(250 * ms)}}
    assert PD.product_path("gemm", paths) == PD.NOT_EMITTED
    assert set(PD.split(host, device, steps=2)[
        "device_ms_per_step_by_product_path"]) == {PD.NOT_EMITTED}
