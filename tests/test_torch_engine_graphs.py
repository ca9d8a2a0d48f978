"""The engine's CUDA graphs where there is no card.

* ``ModelConfig`` captures by default (``cuda_graphs`` True);
* a CPU engine captures nothing: it serves the tokens of an engine with
  ``cuda_graphs=False``, replays no graph, and its ``admit`` and
  ``decode.forward`` spans read ``graph`` = 0;
* a prefill writes its cache straight into the slot it is given;
* a prompt whose prefill is not finite leaves no trace in the cache: the
  requests co-batched with it get the tokens they get where its prefill
  never wrote its slot.

The card side (captures, replays equal to the eager steps, graph memory)
is ``tests/test_torch_cuda.py``'s.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import tracing as T
from repro_torch.launch import serve as S
from repro_torch.launch.engine import Engine
from repro_torch.models.common import ModelConfig
import torch_port  # noqa: F401

ARCHS = ["smollm-135m", "qwen2-7b", "qwen3-moe-30b-a3b"]
TINY = dict(reduced=True, n_layers=2, backend="cuda", device="cpu",
            max_batch=3, max_len=48, prompt_buckets=(8, 16), n_requests=6,
            arrival_rate=1.5, prompt_lens=(3, 14), gen_lens=(2, 6), seed=3)


def _served(arch, graphs):
    """A tiny CPU engine of ``arch`` with ``cuda_graphs=graphs``, run on
    the tiny trace: the engine, its report and its spans."""
    cfg = S.ServeConfig(**dict(TINY, arch=arch))
    mc = dataclasses.replace(S.model_config(cfg), cuda_graphs=graphs)
    engine = Engine(mc, device="cpu", max_batch=cfg.max_batch,
                    max_len=cfg.max_len, prompt_buckets=cfg.prompt_buckets,
                    seed=cfg.seed)
    engine.warmup()
    saved, T.TRACER = T.TRACER, T.Tracer()
    try:
        report = engine.run(S.trace_for(cfg, mc.vocab))
        spans = list(T.TRACER.spans)
    finally:
        T.TRACER = saved
    return engine, report, spans


def test_model_config_captures_by_default():
    assert ModelConfig().cuda_graphs is True


@pytest.mark.parametrize("arch", ARCHS)
def test_cpu_engine_captures_nothing_and_serves_the_eager_tokens(arch):
    engine, report, spans = _served(arch, True)
    eager, eager_report, _ = _served(arch, False)
    assert engine.cfg.cuda_graphs and not eager.cfg.cuda_graphs
    assert engine._graphs == {} and engine.graph_replays == 0
    assert report.n_completed == len(report.tokens) > 0
    assert report.tokens == eager_report.tokens
    assert report.kernel_launches == eager_report.kernel_launches


@pytest.mark.parametrize("arch", ARCHS)
def test_cpu_engine_spans_read_graph_zero(arch):
    engine, report, spans = _served(arch, True)
    admits = [s for s in spans if s.name == "admit"]
    forwards = [s for s in spans if s.name == "decode.forward"]
    assert len(admits) == len(report.tokens)
    assert len(forwards) == sum(r.n_decode > 0 for r in report.per_step)
    assert forwards and all(s.attrs["graph"] == 0
                            for s in admits + forwards)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_writes_its_slot(arch):
    """``Engine._prefill`` returns ``LM.prefill``'s logits and writes its
    cache into the one slot it is given, every other slot untouched."""
    engine = S.build_engine(S.ServeConfig(**dict(TINY, arch=arch)))
    engine.warmup()
    before = {k: v.clone() for k, v in engine.caches.items()}
    rng = np.random.default_rng(0)
    padded = np.zeros((1, 16), np.int64)
    padded[0, :11] = rng.integers(0, engine.cfg.vocab, 11)
    logits = engine._prefill(padded, 1)
    want, cache = engine.model.prefill(engine.params,
                                       torch.from_numpy(padded),
                                       max_len=engine.max_len)
    assert torch.equal(logits, want)
    for name, t in engine.caches.items():
        assert torch.equal(t[:, 1], cache[name][:, 0])
        for slot in (0, 2):
            assert torch.equal(t[:, slot], before[name][:, slot])


def _served_with_a_poisoned_prefill(arch, writes: bool):
    """A tiny CPU engine of ``arch`` (an MoE one holding half its experts,
    as one chip of an expert-parallel layer does: the assignments to the
    others point at a held expert's first row with weight 0) on the tiny
    trace, the third prefill after the warm-up made non-finite: its
    logits NaN, and its slot's cache NaN where ``writes`` (the prefill
    wrote it before the check) or left as it was before (a prefill that
    never wrote).  The report."""
    cfg = S.ServeConfig(**dict(TINY, arch=arch))
    mc = S.model_config(cfg)
    if mc.n_experts:
        mc = dataclasses.replace(mc, expert_share=(0, mc.n_experts // 2))
    engine = Engine(mc, device="cpu", max_batch=cfg.max_batch,
                    max_len=cfg.max_len, prompt_buckets=cfg.prompt_buckets,
                    seed=cfg.seed)
    engine.warmup()
    real, calls = engine._prefill_into, []

    def prefill_into(tokens, slot, out=None):
        calls.append(None)
        if len(calls) != 3:
            return real(tokens, slot, out)
        kept = {k: t[:, slot].clone() for k, t in engine.caches.items()}
        logits = real(tokens, slot, out)
        for name, t in engine.caches.items():
            if writes:
                t.index_fill_(1, slot, float("nan"))
            else:
                t.index_copy_(1, slot, kept[name])
        return logits.fill_(float("nan"))

    engine._prefill_into = prefill_into
    return engine.run(S.trace_for(cfg, mc.vocab))


@pytest.mark.parametrize("arch", ARCHS)
def test_poisoned_prefill_leaves_no_trace(arch):
    """A prefill whose logits are not finite wrote its cache into the
    slot before the check: the engine clears that row, so the free slot's
    decode row stays finite and, in an MoE layer, adds nothing to the
    live rows.  Every other request completes with the tokens it gets
    where the poisoned prefill never wrote its slot."""
    got = _served_with_a_poisoned_prefill(arch, writes=True)
    want = _served_with_a_poisoned_prefill(arch, writes=False)
    assert got.n_poisoned == want.n_poisoned == 1
    assert [f["reason"] for f in got.failures] == ["nonfinite_prefill"]
    assert got.n_completed == got.n_requests - 1 == len(got.tokens)
    assert got.tokens == want.tokens
