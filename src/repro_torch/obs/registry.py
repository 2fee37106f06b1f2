"""Unified metrics registry: counters, gauges, fixed-bucket histograms.

PRs 1-5 grew four disconnected metric silos — `gateway/metrics.py`
request telemetry, `kvcache/metrics.py` hit/miss counters, the engine's
speculative-decode counters, and the chunked scheduler's chunk counters —
each with its own `*_summary()` and its own dashboard table. This module
is the one sink they all register into:

  * **Instruments** (`Counter`, `Gauge`, `Histogram`) for metrics owned
    directly by the registry's user. Histograms use fixed buckets so
    percentiles cost O(buckets) memory regardless of sample count and
    merge exactly across replicas (bucket-wise addition) — the property
    raw-sample percentiles lack.
  * **Scopes**: a named provider callable returning the silo's existing
    summary dict (or None when the feature is off). The silos keep their
    `*_summary()` APIs — they become thin views registered at gateway
    construction — and `snapshot()` returns everything as one coherent
    nested dict: ``{"gateway": {...}, "kvcache": {...}, ...}``.

`core.reporting.unified_dashboard` renders a snapshot as one table; the
bench regression gate diffs snapshot-derived JSON fields across PRs.
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, Optional, Sequence

# latency-in-ms buckets: ~2.5x steps from 50us to 10s, the range one
# engine step / request lifetime can realistically land in
DEFAULT_BUCKETS = (0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0,
                   100.0, 250.0, 500.0, 1000.0, 2500.0, 5000.0, 10000.0)


class Counter:
    """Monotonic count."""
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n: int = 1):
        if n < 0:
            raise ValueError(f"counters only go up, got inc({n})")
        self.value += n


class Gauge:
    """Last-written value."""
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float):
        self.value = float(v)


class Histogram:
    """Fixed-bucket histogram with percentile estimates.

    `buckets` are inclusive upper bounds; one overflow bucket catches the
    tail. Percentiles are bucket-resolution estimates: the reported value
    is the upper bound of the bucket holding the p-th sample (clamped to
    the exact observed max), which is the standard monitoring trade —
    bounded memory and exact cross-replica merges for ~one-bucket-width
    error. Exact percentiles over raw samples (the gateway's TTFT/ITL
    reductions) remain the right tool where samples are already retained.
    """
    __slots__ = ("buckets", "counts", "n", "total", "vmin", "vmax")

    def __init__(self, buckets: Sequence[float] = DEFAULT_BUCKETS):
        if not buckets or list(buckets) != sorted(buckets):
            raise ValueError("buckets must be a non-empty ascending sequence")
        self.buckets = tuple(float(b) for b in buckets)
        self.counts = [0] * (len(self.buckets) + 1)   # +1 overflow
        self.n = 0
        self.total = 0.0
        self.vmin: Optional[float] = None
        self.vmax: Optional[float] = None

    def observe(self, v: float):
        v = float(v)
        i = 0
        for b in self.buckets:
            if v <= b:
                break
            i += 1
        self.counts[i] += 1
        self.n += 1
        self.total += v
        self.vmin = v if self.vmin is None else min(self.vmin, v)
        self.vmax = v if self.vmax is None else max(self.vmax, v)

    def percentile(self, p: float) -> Optional[float]:
        """Upper bound of the bucket holding the p-th percentile sample,
        clamped to the observed max (None on an empty histogram)."""
        if self.n == 0:
            return None
        need = p / 100.0 * self.n
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= need and c:
                bound = (self.buckets[i] if i < len(self.buckets)
                         else self.vmax)
                return min(bound, self.vmax)
        return self.vmax

    def merge(self, other: "Histogram") -> "Histogram":
        """Exact cross-replica aggregation (bucket-wise addition)."""
        if self.buckets != other.buckets:
            raise ValueError("cannot merge histograms with different buckets")
        out = Histogram(self.buckets)
        out.counts = [a + b for a, b in zip(self.counts, other.counts)]
        out.n = self.n + other.n
        out.total = self.total + other.total
        mins = [m for m in (self.vmin, other.vmin) if m is not None]
        maxs = [m for m in (self.vmax, other.vmax) if m is not None]
        out.vmin = min(mins) if mins else None
        out.vmax = max(maxs) if maxs else None
        return out

    def summary(self) -> dict:
        return {
            "count": self.n,
            "mean": self.total / self.n if self.n else None,
            "p50": self.percentile(50),
            "p95": self.percentile(95),
            "max": self.vmax,
        }


class MetricsRegistry:
    """Named instruments plus silo scopes; `snapshot()` is the one dict.

    Instrument names use dotted paths (``"engine.step_ms"``); the first
    segment becomes the snapshot scope, so registry-owned instruments and
    provider scopes land in the same namespace. Instruments are
    get-or-create: asking twice for the same name returns the same object
    (asking with a different type is an error — two call sites silently
    feeding different instruments under one name is exactly the
    split-silo bug this registry exists to end).
    """

    def __init__(self):
        # leaf lock for async-gateway mode: get-or-create from two worker
        # threads must hand back ONE instrument (a lost race would fork a
        # metric into two objects, silently splitting its counts)
        self._mu = threading.RLock()
        self._instruments: Dict[str, object] = {}
        self._scopes: Dict[str, Callable[[], Optional[dict]]] = {}

    # ----------------------------------------------------- instruments
    def _get(self, name: str, typ, factory):
        with self._mu:
            inst = self._instruments.get(name)
            if inst is None:
                inst = self._instruments[name] = factory()
            elif not isinstance(inst, typ):
                raise TypeError(f"metric {name!r} is {type(inst).__name__}, "
                                f"not {typ.__name__}")
            return inst

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge, Gauge)

    def histogram(self, name: str,
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get(name, Histogram, lambda: Histogram(buckets))

    # ---------------------------------------------------------- scopes
    def register_scope(self, name: str,
                       provider: Callable[[], Optional[dict]]):
        """Attach a silo: `provider()` is called at snapshot time and may
        return None to mean "feature off, omit the scope"."""
        with self._mu:
            self._scopes[name] = provider

    # -------------------------------------------------------- snapshot
    def snapshot(self) -> dict:
        """One coherent dict: ``{scope: {metric: value}}`` over every
        registered silo (in registration order, Nones omitted) and every
        registry-owned instrument (histograms expand to their summary
        stats as ``<name>_<stat>`` keys)."""
        # copy the maps under the lock, call the providers outside it:
        # a provider (e.g. the gateway's summary) takes its own silo lock,
        # and holding the registry lock across that call would add a
        # registry -> silo edge the lock hierarchy does not allow
        with self._mu:
            scopes = dict(self._scopes)
            instruments = dict(self._instruments)
        snap: Dict[str, dict] = {}
        for name, provider in scopes.items():
            d = provider()
            if d is not None:
                snap[name] = dict(d)
        for name, inst in sorted(instruments.items()):
            scope, _, key = name.rpartition(".")
            scope = scope or "metrics"
            dst = snap.setdefault(scope, {})
            if isinstance(inst, Histogram):
                for stat, v in inst.summary().items():
                    dst[f"{key}_{stat}"] = v
            else:
                dst[key] = inst.value
        return snap
