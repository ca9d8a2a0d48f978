"""The traffic generator's shared parts: a mix's parameters
(``traffic/<name>.json``), its length distributions, and the requests.

A mix's ``loop`` names the module under ``traffic/`` that decides when
requests are sent (``"closed"``: ``traffic/closed.py``).  Each such
module has a ``Source(mix, vocab, seed)`` with two methods, which the
serving loop (``benchlib/serving.py``) calls:

* ``start(now)``: the requests sent when the run starts, as ``(Req,
  sent)`` pairs;
* ``after_tick(now, finished)``: after each engine step that ended at
  ``now``, given the clients whose requests finished in it, and again and
  again with none while the engine is idle, the requests sent since the
  last call, each with the time it was sent (at or before ``now``).

So a new kind of loop (open, bursty) is a new module beside this one; a
new mix of a known kind is a data file alone.

A length is ``{"dist": "lognormal", "mean": m, "sigma": s, "min": lo,
"max": hi}``: the log-normal of mean ``m`` and shape ``s`` (``mu = ln m
- s**2 / 2``) over the integers, a length ``n`` taking the probability
of ``(n - 1, n]``, truncated to ``[lo, hi]`` as serving benchmarks drop
the requests that do not fit.  ``stratified`` draws ``n`` lengths, one
from each of ``n`` equal slices of the distribution's probability, in a
shuffled order.

Token ids are uniform over the vocabulary, drawn per request from
``--seed`` and the request's id, so they do not depend on the order in
which requests are sent.
"""

from __future__ import annotations

import importlib
import math
from dataclasses import dataclass
from typing import Dict, Iterable, Tuple

import numpy as np

SEED_MOD = 2 ** 64
#: keys of a mix that describe it and that no code reads
DOC_KEYS = {"why", "source", "cuts"}
#: the keys every mix has, whatever its loop
COMMON_KEYS = {"loop", "engine"}
ENGINE_KEYS = {"max_batch", "max_len", "prompt_buckets"}
LENGTH_KEYS = {"dist", "mean", "sigma", "min", "max"}


@dataclass(frozen=True)
class Req:
    rid: int
    client: int
    prompt: Tuple[int, ...]
    max_new_tokens: int


def seq(seed: int, *key: int) -> np.random.SeedSequence:
    return np.random.SeedSequence([seed % SEED_MOD, *key])


def check_keys(mix: dict, own: Iterable[str]) -> None:
    """Refuse a mix with a key that its loop does not read: a knob that
    no code implements would run as if it were not there."""
    extra = set(mix) - set(own) - COMMON_KEYS - DOC_KEYS
    extra |= {f"engine.{k}" for k in set(mix["engine"]) - ENGINE_KEYS}
    for name in ("prompt_tokens", "output_tokens"):
        if name in mix:
            extra |= {f"{name}.{k}" for k in set(mix[name]) - LENGTH_KEYS}
    if extra:
        raise ValueError(f"mix keys that no code reads: {sorted(extra)}")


def length_pmf(spec: Dict) -> Tuple[np.ndarray, np.ndarray]:
    """The lengths ``lo..hi`` and their probabilities."""
    if spec["dist"] != "lognormal":
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    lo, hi, s = int(spec["min"]), int(spec["max"]), float(spec["sigma"])
    mu = math.log(float(spec["mean"])) - s * s / 2

    def cdf(x):
        return 0.0 if x <= 0 else 0.5 * (1.0 + math.erf(
            (math.log(x) - mu) / (s * math.sqrt(2.0))))
    n = np.arange(lo, hi + 1)
    p = np.array([cdf(k) - cdf(k - 1) for k in n.tolist()])
    return n, p / p.sum()


def stratified(rng: np.random.Generator, values: np.ndarray,
               probs: np.ndarray, n: int) -> np.ndarray:
    """``n`` draws from ``(values, probs)``, one from each of ``n`` equal
    slices of the probability, shuffled."""
    cdf = np.cumsum(probs)
    u = (np.arange(n) + rng.random(n)) / n
    idx = np.minimum(np.searchsorted(cdf, u * cdf[-1], side="right"),
                     len(values) - 1)
    return rng.permutation(values[idx])


def residual_life(values: np.ndarray, probs: np.ndarray
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """The residual life ``R`` of a length ``L`` drawn from ``(values,
    probs)``: ``P(R = r) ~ P(L >= r)`` for ``r = 1 .. max L``, the
    remaining length of the request in flight at a random moment of a
    loop that has run for ever."""
    r = np.arange(1, int(values.max()) + 1)
    tail = np.array([probs[values >= k].sum() for k in r.tolist()])
    return r, tail / tail.sum()


def prompt(seed: int, rid: int, n: int, vocab: int) -> Tuple[int, ...]:
    rng = np.random.default_rng(seq(seed, 2, rid))
    return tuple(rng.integers(0, vocab, n).tolist())


def source(mix: dict, vocab: int, seed: int):
    """The mix's ``Source``, from the module its ``loop`` names."""
    loop = str(mix.get("loop"))
    if not loop.isidentifier():
        raise ValueError(f"unknown loop {loop!r}")
    return importlib.import_module(f"traffic.{loop}").Source(mix, vocab,
                                                              seed)
