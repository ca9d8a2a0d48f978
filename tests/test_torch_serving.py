"""The port's continuous-batching engine on the CPU.

* its ragged mixed prefill+decode trace emits exactly the tokens of
  decoding each sequence alone (its own sequential oracle);
* on the reference's trace and weights it emits the reference engine's
  greedy tokens (``repro.launch.engine`` on ``backend="jax"``), for
  smollm-135m, llama3.2-1b and qwen3-moe-30b-a3b, the latter also at its
  full config's capacity factor, where experts drop tokens;
* after warmup nothing compiles: no pipeline compile, no nvcc build.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro import pipeline as JP
from repro.launch.engine import Engine as JEngine
from repro.launch.engine import synth_trace as j_synth_trace
from repro_torch.launch import serve as S
from repro_torch.launch.engine import Engine, synth_trace
from repro_torch.models.lm import LM as TLM
import torch_port  # noqa: F401

TINY = dict(reduced=True, n_layers=2, backend="cuda", device="cpu",
            max_batch=3, max_len=48, prompt_buckets=(8, 16), n_requests=6,
            arrival_rate=1.5, prompt_lens=(3, 14), gen_lens=(2, 6), seed=3)


def _oracle(engine, req):
    """Per-sequence sequential greedy decode: no batching, no padding."""
    m, params = engine.model, engine.params
    lg, cache = m.prefill(params, torch.tensor([req.prompt]),
                          max_len=engine.max_len)
    tok = int(lg[0, -1].argmax())
    toks, pos = [tok], len(req.prompt)
    for _ in range(req.max_new_tokens - 1):
        lg, cache = m.decode_step(params, cache, torch.tensor([[tok]]), pos)
        tok = int(lg[0, -1].argmax())
        toks.append(tok)
        pos += 1
    return toks


def test_ragged_trace_matches_sequential_oracle():
    cfg = S.ServeConfig(**TINY)
    engine = S.build_engine(cfg)
    trace = S.trace_for(cfg, engine.cfg.vocab)
    engine.warmup()
    report = engine.run(trace)
    assert report.n_completed == len(trace)
    assert report.n_rejected == 0 and report.n_evicted_stalled == 0
    assert report.decode_recompiles == 0
    for req in trace:
        assert report.tokens[req.rid] == _oracle(engine, req), req.rid


def test_trace_is_the_reference_trace():
    a = synth_trace(9, seed=5, arrival_rate=0.7, vocab=77)
    b = j_synth_trace(9, seed=5, arrival_rate=0.7, vocab=77)
    assert [(r.rid, r.prompt, r.max_new_tokens, r.arrival_step)
            for r in a] == [(r.rid, r.prompt, r.max_new_tokens,
                             r.arrival_step) for r in b]


@pytest.mark.parametrize("arch,backend,capacity_factor", [
    pytest.param("smollm-135m", "torch", None, id="torch"),
    pytest.param("smollm-135m", "cuda", None, id="cuda"),
    pytest.param("llama3.2-1b", "cuda", None, id="llama3.2-1b-cuda"),
    pytest.param("qwen3-moe-30b-a3b", "cuda", None,
                 id="qwen3-moe-30b-a3b-cuda"),
    # the full config's capacity factor: experts drop tokens at the
    # engine's shapes (padding and free slots route too)
    pytest.param("qwen3-moe-30b-a3b", "torch", 1.25,
                 id="qwen3-moe-30b-a3b-drops-torch")])
def test_greedy_tokens_equal_reference_engine(arch, backend, capacity_factor,
                                              tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_KERNEL_CACHE", str(tmp_path))
    JP.reset_default_cache()
    over = {} if capacity_factor is None else {
        "capacity_factor": capacity_factor}
    try:
        mc = JC.with_pipeline(
            JC.get_reduced_config(arch, n_layers=2, **over),
            options=JP.CompileOptions(backend="jax"))
        ref = JEngine(mc, max_batch=3, max_len=48, prompt_buckets=(8, 16),
                      seed=0, repromote_after=None)
        trace = j_synth_trace(5, seed=0, prompt_lens=(3, 14),
                              gen_lens=(2, 6), vocab=mc.vocab)
        want = ref.run(trace)
    finally:
        JP.reset_default_cache()
    cfg = S.ServeConfig(**dict(TINY, arch=arch, backend=backend,
                               n_requests=5, seed=0, arrival_rate=1.0))
    mc = dataclasses.replace(S.model_config(cfg), **over)
    params = TLM(mc).from_jax_params(jax.tree.map(np.asarray, ref.params),
                                     "cpu")
    engine = Engine(mc, params=params, device="cpu", max_batch=3,
                    max_len=48, prompt_buckets=(8, 16), seed=0)
    got = engine.run(trace)
    assert got.n_completed == want.n_completed == len(trace)
    assert got.tokens == want.tokens
    assert got.decode_recompiles == 0


def test_no_compile_after_warmup_and_kernels_named():
    cfg = S.ServeConfig(**dict(TINY, n_requests=3))
    engine = S.build_engine(cfg)
    engine.warmup()
    assert sorted(engine.kernels) == sorted(
        f"{p}/g0:{n}" for p, n in [
            ("attention_prefill8", 5), ("attention_prefill16", 5),
            ("attention_decode", 5), ("swiglu_prefill8", "22+23"),
            ("swiglu_prefill16", "22+23"), ("swiglu_decode", "22+23")])
    report = engine.run(S.trace_for(cfg, engine.cfg.vocab))
    assert report.decode_recompiles == 0
    # CPU tensors run each kernel's plain version: no launch is counted
    assert set(report.kernel_launches.values()) == {0}
    assert report.to_json()["n_completed"] == 3


def test_oversized_request_is_rejected_not_wedged():
    cfg = S.ServeConfig(**dict(TINY, n_requests=0))
    engine = S.build_engine(cfg)
    from repro_torch.launch.engine import Request
    trace = [Request(0, tuple(range(20)), 4, 0),       # no bucket fits
             Request(1, (1, 2, 3), 60, 0),             # past max_len
             Request(2, (1, 2, 3), 3, 0)]
    report = engine.run(trace)
    assert report.n_rejected == 2 and report.n_completed == 1
    assert [f["rid"] for f in report.failures] == [0, 1]


def test_bursts_split_a_timeline_at_its_idle_gaps():
    """``profile_decode.bursts``: events in any order, split where the
    card sat idle longer than the gap (an event inside another's span
    keeps the burst open)."""
    from repro_torch.launch.profile_decode import bursts
    events = [(300.0, 310.0, "c"), (0.0, 50.0, "a"), (10.0, 20.0, "b"),
              (75.0, 80.0, "x"), (1000.0, 1001.0, "d")]
    assert [[n for _, _, n in b] for b in bursts(events, 100.0)] == [
        ["a", "b", "x"], ["c"], ["d"]]
    assert bursts([], 1.0) == []
