"""Fixed-bucket latency histogram: the port's copy of `Histogram` from
`repro.obs.registry` (the engine's per-step-kind wall times). The rest of
the reference registry (counters, gauges, scopes, snapshots) comes with the
gateway slice.
"""
from __future__ import annotations

from typing import Optional, Sequence

# latency-in-ms buckets: ~2.5x steps from 50us to 10s, the range one
# engine step / request lifetime can realistically land in
DEFAULT_BUCKETS = (0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0,
                   100.0, 250.0, 500.0, 1000.0, 2500.0, 5000.0, 10000.0)


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
