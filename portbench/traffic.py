"""The traffic generator: one general generator, driven by a mix's data
file (`traffic/<mix>.json`).

Lengths are seeded clamped log-normals, the arithmetic of
`repro_torch.obs.workload._clamped_lognormal` copied here and frozen
(with a lower clamp added): `round(lognormal(log(median), sigma))`
clamped to [min, max]. The sizes and their order come from the mix's own
`sizes_seed` alone: a block of `sizes_block` requests' sizes, repeated,
each repetition in an order of its own. `--seed` draws the tokens only.
So every seed offers the same work in the same order (the closed loop's
timing depends on the order, and seeds that reordered it spread the
tails by up to 9% where two runs of one seed agreed to 0.5%), and one
seed always offers the same requests.

Prompts are uniform token ids from [FIRST_TOKEN, vocab). Each prompt of a
run starts with a token no other prompt of the run starts with (drawn
without replacement), so prompts share no prefix and the prefix cache
reuses nothing where the mix shares nothing. A mix with `shared` draws
`documents` documents (distinct first tokens too); each request is one of
them, chosen uniformly, plus a fresh question of `question` tokens
(uniform in [min, max]).
"""
from __future__ import annotations

import math
from typing import Dict, Iterator, List, Tuple

import numpy as np

FIRST_TOKEN = 2          # ids below it are left to the harness's warm-up
WARMUP_TOKEN = 1         # every warm-up prompt starts with it


def clamped_lognormal(rng: np.random.Generator, median: float, sigma: float,
                      lo: int, hi: int) -> int:
    """`repro_torch.obs.workload._clamped_lognormal`'s arithmetic, with
    mu = log(median) and a lower clamp."""
    return int(min(max(round(float(rng.lognormal(math.log(median), sigma))),
                       lo), hi))


def _draw(rng, p: dict) -> int:
    return clamped_lognormal(rng, p["median"], p["sigma"], p["min"], p["max"])


def size_block(mix: dict) -> List[Dict[str, int]]:
    """The mix's fixed block of request sizes, from `sizes_seed` alone."""
    rng = np.random.default_rng(mix["sizes_seed"])
    out = []
    for _ in range(mix["sizes_block"]):
        if mix.get("shared"):
            sh = mix["shared"]
            out.append({"doc": int(rng.integers(sh["documents"])),
                        "question": int(rng.integers(
                            sh["question"]["min"],
                            sh["question"]["max"] + 1)),
                        "output": _draw(rng, mix["output"])})
        else:
            out.append({"prompt": _draw(rng, mix["prompt"]),
                        "output": _draw(rng, mix["output"])})
    return out


def doc_lengths(mix: dict) -> List[int]:
    """Lengths of a shared mix's documents, from `sizes_seed` alone."""
    sh = mix["shared"]
    rng = np.random.default_rng([mix["sizes_seed"], 1])
    return [_draw(rng, sh["doc"]) for _ in range(sh["documents"])]


def prefill_lengths(mix: dict) -> Tuple[int, int]:
    """Least and most prompt tokens one prefill of the window computes. A
    shared request reuses its document's full pages (and may reuse part
    of the next page by copy-on-write), so it computes its question plus
    up to a page less one."""
    if mix.get("shared"):
        q = mix["shared"]["question"]
        return q["min"], q["max"] + mix["block_size"] - 1
    return mix["prompt"]["min"], mix["prompt"]["max"]


class Traffic:
    """The requests of one run: `next()` -> (prompt tokens, max new
    tokens), endlessly, block after block."""

    def __init__(self, mix: dict, vocab: int, seed: int):
        self.vocab = int(vocab)
        self.rng = np.random.default_rng(seed % 2 ** 64)
        self.block = size_block(mix)
        self.sizes_seed = mix["sizes_seed"]
        # a distinct first token for every prompt (and document) of the run
        self._firsts = iter(self.rng.permutation(
            np.arange(FIRST_TOKEN, self.vocab)).tolist())
        self.docs: List[List[int]] = []
        if mix.get("shared"):
            self.docs = [self._tokens(n) for n in doc_lengths(mix)]
        self._it = self._requests()

    def _tokens(self, n: int, first: bool = True) -> List[int]:
        body = self.rng.integers(FIRST_TOKEN, self.vocab, size=n).tolist()
        if first and n:
            body[0] = next(self._firsts)
        return body

    def _requests(self) -> Iterator[Tuple[List[int], int]]:
        order = np.random.default_rng([self.sizes_seed, 2])
        while True:
            for i in order.permutation(len(self.block)).tolist():
                r = self.block[i]
                if "doc" in r:
                    prompt = self.docs[r["doc"]] + self._tokens(
                        r["question"], first=False)
                else:
                    prompt = self._tokens(r["prompt"])
                yield prompt, r["output"]

    def next(self) -> Tuple[List[int], int]:
        return next(self._it)
