"""End-to-end metrics from the client's own timestamps: each request's
submit time and the time each of its tokens reached the client's
callback. Nothing here reads the program's telemetry.

A window is [t0, t1]. Rates count all the tokens delivered in it over all
of its seconds; tails are taken over every request the window touched,
the slow ones and those still waiting included."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np

TAIL = 90.0


@dataclass
class ClientRequest:
    prompt: List[int]
    max_new: int
    submit: float
    times: List[float] = field(default_factory=list)
    tokens: List[int] = field(default_factory=list)
    status: str = "queued"              # the gateway's final status
    handle: object = field(default=None, repr=False)


def _in(ts, t0, t1):
    return [t for t in ts if t0 <= t <= t1]


def _tail(values) -> Optional[float]:
    return float(np.percentile(values, TAIL)) if values else None


def output_tokens_per_s(reqs, t0: float, t1: float) -> Optional[float]:
    n = sum(len(_in(r.times, t0, t1)) for r in reqs)
    return n / (t1 - t0) if n else None


def tpot_p90_ms(reqs, t0: float, t1: float) -> Optional[float]:
    """Per request with at least two tokens in the window: (last - first
    token time in the window) / (its tokens in the window - 1); the 90th
    percentile over all such requests, in ms."""
    per = []
    for r in reqs:
        ts = _in(r.times, t0, t1)
        if len(ts) >= 2:
            per.append((ts[-1] - ts[0]) / (len(ts) - 1) * 1e3)
    return _tail(per)


def ttft_p90_ms(reqs, t0: float, t1: float) -> Optional[float]:
    """Per request submitted in the window: submit to first token, or to
    the window's end for one still waiting then; the 90th percentile, in
    ms."""
    per = []
    for r in reqs:
        if not t0 <= r.submit <= t1:
            continue
        first = r.times[0] if r.times and r.times[0] <= t1 else t1
        per.append((first - r.submit) * 1e3)
    return _tail(per)


METRICS: Dict[str, Callable] = {
    "output_tokens_per_s": output_tokens_per_s,
    "tpot_p90_ms": tpot_p90_ms,
    "ttft_p90_ms": ttft_p90_ms,
}
