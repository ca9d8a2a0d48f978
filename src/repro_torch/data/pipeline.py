"""Deterministic, restart-safe synthetic LM data: the port of
``repro.data.pipeline``.

Batches are a pure function of (seed, step): after a failure and a
restart the pipeline replays exactly, which is what makes a resume from a
checkpoint bitwise reproducible.  The tokens are the reference's own: the
same numpy draws from ``SeedSequence([seed, step])``, a skewed (zipf-ish)
marginal with short-range structure so that the loss falls, as int32.
They are moved to the caller's device (the card unless it asks for the
CPU).

``host_slice`` is one process's rows of the global batch, for a job of
several processes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch


@dataclass(frozen=True)
class SyntheticLMData:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0

    def numpy_batch(self, step: int) -> Dict[str, np.ndarray]:
        """The reference's arrays for ``step``: tokens and the labels
        shifted by one, (global_batch, seq_len) int32 each."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step]))
        b, s = self.global_batch, self.seq_len
        # zipf-ish marginals + markov-ish structure: the next token depends
        # on the previous one half the time
        base = rng.zipf(1.5, size=(b, s + 1)) % self.vocab
        prev = np.roll(base, 1, axis=1)
        mix = rng.random((b, s + 1)) < 0.5
        toks = np.where(mix, (prev * 7 + 3) % self.vocab, base)
        toks = toks.astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def batch(self, step: int, device="cuda") -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                for k, v in self.numpy_batch(step).items()}

    def host_slice(self, step: int, process_index: int, process_count: int,
                   device="cuda") -> Dict[str, torch.Tensor]:
        per = self.global_batch // process_count
        sl = slice(process_index * per, (process_index + 1) * per)
        return {k: torch.from_numpy(np.ascontiguousarray(v[sl])).to(device)
                for k, v in self.numpy_batch(step).items()}
