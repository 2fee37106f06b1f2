"""Per-request token sampling for the serving gateway.

The engine's decode step returns last-position logits for every slot;
sampling happens host-side so each slot in one lockstep batch can decode
with its own strategy (greedy, temperature, top-k, top-p) and its own seeded
PRNG stream. Greedy (temperature == 0) reproduces the historical hard-coded
argmax bit-for-bit, so the gateway's default path matches the plain engine.

Sampling math is float64 on host: renormalizing a float32 softmax after
top-k/top-p masking loses enough precision to make seeded streams drift
across platforms; float64 keeps them reproducible.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass(frozen=True)
class SamplingParams:
    """Declarative sampling spec, one per request (JSON-friendly — it rides
    inside the gateway's TaskSpec payload).

    temperature: 0.0 => greedy argmax; > 0 scales logits before softmax.
    top_k: keep only the k highest logits (0 disables).
    top_p: nucleus sampling — keep the smallest prefix of the sorted
        distribution with cumulative mass >= top_p (1.0 disables).
    seed: per-request PRNG seed; None draws a nondeterministic seed.
    """
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: Optional[int] = None

    @property
    def is_greedy(self) -> bool:
        return self.temperature <= 0.0

    def to_payload(self) -> dict:
        return {"temperature": self.temperature, "top_k": self.top_k,
                "top_p": self.top_p, "seed": self.seed}

    @staticmethod
    def from_payload(d: dict) -> "SamplingParams":
        return SamplingParams(
            temperature=float(d.get("temperature", 0.0)),
            top_k=int(d.get("top_k", 0)),
            top_p=float(d.get("top_p", 1.0)),
            seed=d.get("seed"))


GREEDY = SamplingParams()


def apply_top_k(logits: np.ndarray, k: int) -> np.ndarray:
    """Mask all but the k highest logits to -inf. k <= 0 is a no-op."""
    if k <= 0 or k >= logits.shape[-1]:
        return logits
    kth = np.sort(logits)[..., -k]
    return np.where(logits < kth, -np.inf, logits)


def apply_top_p(probs: np.ndarray, p: float) -> np.ndarray:
    """Nucleus mask on a probability vector: zero everything outside the
    smallest top-sorted prefix with cumulative mass >= p, renormalize.
    Always keeps at least the argmax."""
    if p >= 1.0:
        return probs
    order = np.argsort(probs)[::-1]
    csum = np.cumsum(probs[order])
    # first index where cumulative mass reaches p; keep through that index
    cut = int(np.searchsorted(csum, p)) + 1
    keep = order[:max(cut, 1)]
    out = np.zeros_like(probs)
    out[keep] = probs[keep]
    return out / out.sum()


def sample_token(logits, params: SamplingParams,
                 rng: Optional[np.random.Generator] = None) -> int:
    """Draw one token id from a 1-D logits vector under `params`."""
    logits = np.asarray(logits, np.float64).reshape(-1)
    if params.is_greedy:
        return int(np.argmax(logits))
    logits = logits / params.temperature
    if params.top_k:
        logits = apply_top_k(logits, params.top_k)
    logits = logits - logits.max()
    probs = np.exp(logits)
    probs = probs / probs.sum()
    if params.top_p < 1.0:
        probs = apply_top_p(probs, params.top_p)
    if rng is None:
        rng = np.random.default_rng(params.seed)
    return int(rng.choice(probs.shape[0], p=probs))


class Sampler:
    """Stateful per-request sampler: SamplingParams + a private PRNG stream.

    One Sampler is attached to each engine Request, so two slots decoding in
    the same lockstep batch draw from independent streams — batch
    composition never changes a seeded request's output.
    """

    def __init__(self, params: SamplingParams = GREEDY):
        self.params = params
        self._rng = np.random.default_rng(params.seed)

    def sample(self, logits) -> int:
        return sample_token(logits, self.params, self._rng)
