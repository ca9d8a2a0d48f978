"""A closed loop (``"loop": "closed"``): ``clients`` clients that each
send their next request at the moment they see the last one finish (no
think time).

The sizes come from the mix's own ``sizes_seed``, not from ``--seed``:
every run sends the same sizes, and ``--seed`` deals the clients' first
requests out in another order and draws the token ids.  In a closed loop
the ticks at which requests finish together follow from the sizes
alone, and with sizes drawn from ``--seed`` the share of requests
admitted two to a tick moved the 90th percentile of time to first token
between modes some 20 % apart from seed to seed; fixed sizes keep each
run on one of those modes and hide the other.

Prompt and output lengths are drawn apart, each by strata of
``STRATA`` (``traffic/gen.py``).  Each client's first output length is
drawn from the residual life of the output length, by strata: the loop
starts as if it had run for ever, so requests finish at a steady rate
from the first tick.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from traffic import gen

KEYS = {"clients", "prompt_tokens", "output_tokens", "sizes_seed"}
#: lengths are drawn in blocks of this many requests, one from each equal
#: slice of the distribution's probability
STRATA = 16


class Source:
    """The requests of a closed-loop mix, in the order they are sent."""

    def __init__(self, mix: dict, vocab: int, seed: int):
        gen.check_keys(mix, KEYS)
        self.vocab, self.seed = int(vocab), int(seed)
        self.sizes_seed = int(mix["sizes_seed"])
        self.clients = int(mix["clients"])
        self._p = gen.length_pmf(mix["prompt_tokens"])
        self._o = gen.length_pmf(mix["output_tokens"])
        self._sizes: List[Tuple[int, int]] = []
        self._block = 0
        self.sent = 0

    def _refill(self) -> None:
        rng = np.random.default_rng(gen.seq(self.sizes_seed, 1,
                                            self._block))
        self._block += 1
        p = gen.stratified(rng, *self._p, STRATA)
        o = gen.stratified(rng, *self._o, STRATA)
        self._sizes.extend(zip(p.tolist(), o.tolist()))

    def _make(self, client: int, plen: int, out: int) -> gen.Req:
        rid = self.sent
        self.sent += 1
        return gen.Req(rid, client, gen.prompt(self.seed, rid, plen,
                                               self.vocab), int(out))

    def next_sizes(self) -> Tuple[int, int]:
        if not self._sizes:
            self._refill()
        return self._sizes.pop(0)

    def first(self) -> List[gen.Req]:
        """Every client's first request: the same sizes for every seed,
        dealt to the clients in the seed's order."""
        rng = np.random.default_rng(gen.seq(self.sizes_seed, 0))
        prompts = [self.next_sizes()[0] for _ in range(self.clients)]
        outs = gen.stratified(rng, *gen.residual_life(*self._o),
                              self.clients)
        deal = np.random.default_rng(gen.seq(self.seed, 0)).permutation(
            self.clients)
        sizes = list(zip(prompts, outs.tolist()))
        return [self._make(c, *sizes[int(deal[c])])
                for c in range(self.clients)]

    def next(self, client: int) -> gen.Req:
        """The next request of ``client``, which saw its last one finish."""
        plen, out = self.next_sizes()
        return self._make(client, plen, out)

    def start(self, now: float) -> List[Tuple[gen.Req, float]]:
        return [(r, now) for r in self.first()]

    def after_tick(self, now: float, finished: List[int]
                   ) -> List[Tuple[gen.Req, float]]:
        return [(self.next(c), now) for c in finished]
