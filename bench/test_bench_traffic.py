"""The traffic generator (``traffic/gen.py``, ``traffic/closed.py``):
the same seed gives the same requests, every block of ``strata``
requests spans the length distribution by strata, the lengths follow the
truncated log-normal of the mix's means, the first outputs follow the
residual life, and a mix's loop and keys are what code reads."""

import math
import sys
import types

import numpy as np
import pytest

from bench_small import small_mix
from benchlib import spec
from traffic import closed, gen

MIX = spec.traffic("chat-closed32")


def _stream(seed, n=80, mix=MIX, vocab=152064):
    src = gen.source(mix, vocab, seed)
    reqs = src.first()
    reqs += [src.next(i % src.clients) for i in range(n)]
    return reqs


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 11, 2 ** 40 + 3])
def test_same_seed_same_requests(seed):
    a, b = _stream(seed), _stream(seed)
    assert a == b
    assert [r.rid for r in a] == list(range(len(a)))
    assert a != _stream(seed + 1)


def test_strata_blocks():
    src = gen.source(MIX, 1000, 5)
    src.first()
    k = closed.STRATA
    sizes = [src.next_sizes() for _ in range(4 * k)]
    for b in range(4):
        block = sizes[b * k:(b + 1) * k]
        for key, vals in (("prompt_tokens", [s[0] for s in block]),
                          ("output_tokens", [s[1] for s in block])):
            values, probs = gen.length_pmf(MIX[key])
            cdf = dict(zip(values.tolist(), np.cumsum(probs).tolist()))
            for j, v in enumerate(sorted(vals)):
                # the j-th smallest draw lies in the j-th slice of the
                # probability: P(L < v) <= (j + 1) / k <= ... and P(L <= v)
                # >= j / k
                below = cdf.get(v - 1, 0.0)
                assert below <= (j + 1) / k + 1e-12
                assert cdf[v] >= j / k - 1e-12


def test_prompts_and_first_outputs():
    reqs = _stream(3, n=200)
    p, o = MIX["prompt_tokens"], MIX["output_tokens"]
    first = reqs[:MIX["clients"]]
    assert all(1 <= r.max_new_tokens <= o["max"] for r in first)
    later = reqs[MIX["clients"]:]
    assert all(o["min"] <= r.max_new_tokens <= o["max"] for r in later)
    assert all(p["min"] <= len(r.prompt) <= p["max"] for r in reqs)
    assert max(len(r.prompt) for r in reqs) <= \
        MIX["engine"]["prompt_buckets"][-1]
    assert all(len(r.prompt) + r.max_new_tokens <= MIX["engine"]["max_len"]
               for r in reqs)
    ids = np.concatenate([r.prompt for r in reqs])
    assert ids.min() >= 0 and ids.max() < 152064
    assert ids.max() > 100000          # uniform over the whole vocabulary


@pytest.mark.parametrize("key", ["prompt_tokens", "output_tokens"])
def test_lengths_are_the_published_lognormal(key):
    spec_ = dict(MIX[key])
    # untruncated, the distribution has the published mean ...
    values, probs = gen.length_pmf(dict(spec_, min=1, max=200000))
    assert abs((values * probs).sum() - spec_["mean"]) < 0.01 * spec_["mean"]
    # ... and its median is exp(mu)
    median = values[np.searchsorted(np.cumsum(probs), 0.5)]
    mu = math.log(spec_["mean"]) - spec_["sigma"] ** 2 / 2
    assert abs(median - math.exp(mu)) <= 1
    # truncated to the mix's range, the served mean (PERF.md, the mix's
    # cuts) falls short of it by the dropped tail
    values, probs = gen.length_pmf(spec_)
    served = {"prompt_tokens": 57.38, "output_tokens": 174.62}[key]
    assert abs((values * probs).sum() - served) < 0.01
    assert values.min() == spec_["min"] and values.max() == spec_["max"]


def test_residual_life_mean():
    values, probs = gen.length_pmf(MIX["output_tokens"])
    r, pr = gen.residual_life(values, probs)
    mean_l = (values * probs).sum()
    # a discrete residual life R = 1 .. L has E[R] = E[L (L + 1)] / 2 E[L]
    want = (values * (values + 1) * probs).sum() / (2 * mean_l)
    assert abs((r * pr).sum() - want) < 1e-6
    rng = np.random.default_rng(0)
    draws = gen.stratified(rng, r, pr, 20000)
    assert abs(draws.mean() - want) < 1.0
    assert draws.min() >= 1 and draws.max() <= values.max()


def test_stratified_follows_the_pmf():
    values, probs = gen.length_pmf(MIX["prompt_tokens"])
    rng = np.random.default_rng(1)
    vals = np.concatenate([gen.stratified(rng, values, probs, 16)
                           for _ in range(4000)])
    counts = np.bincount(vals - values.min(), minlength=len(values))
    want = probs * len(vals)
    big = want > 200
    assert np.all(np.abs(counts[big] - want[big]) < 5 * np.sqrt(want[big]))


def test_small_mix_runs():
    reqs = _stream(9, n=20, mix=small_mix(), vocab=256)
    assert len(reqs) == 28


def test_every_seed_sends_the_same_sizes():
    a, b = _stream(11, n=120), _stream(12, n=120)
    assert sorted((len(r.prompt), r.max_new_tokens) for r in a[:32]) == \
        sorted((len(r.prompt), r.max_new_tokens) for r in b[:32])
    assert [(len(r.prompt), r.max_new_tokens) for r in a[32:]] == \
        [(len(r.prompt), r.max_new_tokens) for r in b[32:]]
    assert [r.prompt for r in a] != [r.prompt for r in b]


def test_closed_loop_sends_when_a_request_finishes():
    src = gen.source(MIX, 1000, 4)
    start = src.start(1.0)
    assert len(start) == MIX["clients"]
    assert all(sent == 1.0 for _, sent in start)
    nxt = src.after_tick(2.5, [3, 7])
    assert [(r.client, sent) for r, sent in nxt] == [(3, 2.5), (7, 2.5)]
    assert [r.rid for r, _ in nxt] == [32, 33]
    assert src.after_tick(3.0, []) == []


@pytest.mark.parametrize("key", [
    ("think_ms", 500), ("token_ids", "uniform_vocab"),
    ("engine", {"max_batch": 8, "max_len": 40, "prompt_buckets": [8],
                "max_queue": 4}),
    ("output_tokens", dict(MIX["output_tokens"], p99=900))],
    ids=["think_ms", "token_ids", "engine.max_queue", "output_tokens.p99"])
def test_a_key_no_code_reads_is_refused(key):
    mix = dict(MIX)
    mix[key[0]] = key[1]
    with pytest.raises(ValueError, match="no code reads"):
        gen.source(mix, 1000, 1)


def test_loop_is_found_by_module_name(monkeypatch):
    assert isinstance(gen.source(MIX, 1000, 1), closed.Source)

    class Source:
        def __init__(self, mix, vocab, seed):
            self.args = (mix["loop"], vocab, seed)
    monkeypatch.setitem(sys.modules, "traffic.burst_test",
                        types.SimpleNamespace(Source=Source))
    got = gen.source(dict(MIX, loop="burst_test"), 1000, 3)
    assert got.args == ("burst_test", 1000, 3)
    with pytest.raises(ValueError):
        gen.source(dict(MIX, loop="../x"), 1000, 1)
    with pytest.raises(ModuleNotFoundError):
        gen.source(dict(MIX, loop="no_such_loop"), 1000, 1)


def test_idle_loop_polls_its_source():
    """Between arrivals (an open loop) the serving loop asks its source
    again instead of ticking an idle engine; a request keeps the time it
    was sent."""
    from benchlib.serving import Loop

    class Source:
        calls = 0

        def start(self, now):
            return []

        def after_tick(self, now, finished):
            assert finished == []
            self.calls += 1
            return ([(gen.Req(0, 0, (1, 2), 3), now - 0.5)]
                    if self.calls == 3 else [])
    engine = types.SimpleNamespace(queue=[], slots=[None, None])
    clock = iter(range(10, 100)).__next__
    loop = Loop(engine, Source(), shape=None, clock=clock)
    loop.start()
    polls = 0
    while loop.idle():
        loop.poll()
        polls += 1
    assert polls == 3
    assert [(r.rid, r.sent) for r in loop.pending] == [(0, 12.5)]
