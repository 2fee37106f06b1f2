"""Continuous telemetry: a sampler thread turning snapshots into series.

`Gateway.snapshot()` (PR 6) is point-in-time: one call, one dict. This
module adds the time axis. `TimeSeriesSampler` runs a daemon thread that
calls a snapshot source at a fixed cadence, flattens every numeric leaf
into a dotted series name (``gateway.completed``, ``kvcache.blocks_in_use``,
``slo.tiers.0.goodput_tokens``...), and appends ``(t, value)`` points into
per-series ring buffers with bounded retention. On top of the rings sit
windowed aggregates — last/mean/min/max/p95 plus a first-to-last rate for
counters — so "what did queue depth look like over the last 60 s" is one
call, not a log-scraping exercise.

Lock discipline (audited by `concurrency.locks.audit_serving_stack`): the
sampler's lock is a **leaf**. The snapshot source is called *outside* it —
the source takes the gateway/metrics/registry locks — and only the cheap
ring append happens under `_mu`. Taking the sampler lock around the
source call would add a sampler -> gateway edge while the exporter thread
holds sampler under nothing, inviting exactly the inversion the PR 9
auditor exists to catch.

Sampling never takes down serving: a source that raises is counted in
``sample_errors`` and skipped; the thread keeps its cadence.
"""
from __future__ import annotations

import json
import math
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

Point = Tuple[float, float]


def flatten_numeric(obj, prefix: str = "") -> Dict[str, float]:
    """Flatten nested dicts/lists to ``{dotted.name: float}`` over numeric
    leaves. Bools become 0/1; None and strings are skipped; non-finite
    values are skipped (a NaN point would poison every window aggregate)."""
    out: Dict[str, float] = {}
    _flatten_into(obj, prefix, out)
    return out


def _flatten_into(obj, prefix: str, out: Dict[str, float]):
    if isinstance(obj, bool):
        out[prefix] = 1.0 if obj else 0.0
    elif isinstance(obj, (int, float)):
        v = float(obj)
        if math.isfinite(v):
            out[prefix] = v
    elif isinstance(obj, dict):
        for k, v in obj.items():
            _flatten_into(v, f"{prefix}.{k}" if prefix else str(k), out)
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            _flatten_into(v, f"{prefix}.{i}" if prefix else str(i), out)
    # None / str / other leaves: not a series


def _p95(values: Sequence[float]) -> float:
    xs = sorted(values)
    return xs[min(len(xs) - 1, int(math.ceil(0.95 * len(xs))) - 1)]


class TimeSeriesSampler:
    """Ring-buffered time series sampled from a snapshot source.

    Parameters
    ----------
    source : callable returning a (possibly nested) dict — typically
        ``gw.snapshot`` — called once per tick, outside the sampler lock.
    interval_s : sampling cadence.
    capacity : per-series retention (points); with the default 0.1 s
        cadence, 600 points ~= the last minute.
    """

    def __init__(self, source: Callable[[], dict], *,
                 interval_s: float = 0.1, capacity: int = 600):
        if interval_s <= 0:
            raise ValueError(f"interval_s must be > 0, got {interval_s}")
        if capacity < 2:
            raise ValueError(f"capacity must be >= 2, got {capacity}")
        self.source = source
        self.interval_s = float(interval_s)
        self.capacity = int(capacity)
        # leaf lock: guards only the series maps, never held across source()
        self._mu = threading.Lock()
        self._series: Dict[str, deque] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.samples = 0
        self.sample_errors = 0
        self.epoch = time.perf_counter()

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "TimeSeriesSampler":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="ts-sampler")
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5.0)

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    def _run(self):
        while not self._stop.is_set():
            self.sample_now()
            self._stop.wait(self.interval_s)

    # ------------------------------------------------------------- sampling
    def sample_now(self) -> int:
        """Take one sample immediately (also used by tests and by serve's
        final flush so short runs always have at least one point). Returns
        the number of series updated."""
        t = time.perf_counter() - self.epoch
        try:
            snap = self.source()
        except Exception:
            # a telemetry tick must never take down serving
            with self._mu:
                self.sample_errors += 1
            return 0
        flat = flatten_numeric(snap)
        with self._mu:
            for name, v in flat.items():
                ring = self._series.get(name)
                if ring is None:
                    ring = self._series[name] = deque(maxlen=self.capacity)
                ring.append((t, v))
            self.samples += 1
        return len(flat)

    # -------------------------------------------------------------- queries
    def names(self) -> List[str]:
        with self._mu:
            return sorted(self._series)

    def series(self, name: str) -> List[Point]:
        with self._mu:
            ring = self._series.get(name)
            return list(ring) if ring else []

    def recent(self, seconds: Optional[float] = None,
               prefix: str = "") -> Dict[str, List[Point]]:
        """Every series (optionally name-prefix filtered), trimmed to the
        trailing window. ``seconds=None`` returns full retention."""
        with self._mu:
            items = [(n, list(r)) for n, r in self._series.items()
                     if n.startswith(prefix)]
        if seconds is None:
            return dict(sorted(items))
        out = {}
        for name, pts in items:
            if not pts:
                continue
            cut = pts[-1][0] - seconds
            out[name] = [p for p in pts if p[0] >= cut]
        return dict(sorted(out.items()))

    def window(self, name: str,
               seconds: Optional[float] = None) -> Optional[dict]:
        """Windowed aggregate over the trailing ``seconds`` of one series:
        ``{n, last, mean, min, max, p95, rate_per_s}``. The rate is the
        first-to-last slope — for a monotonic counter that is its average
        increase rate over the window; for a gauge it is drift. None when
        the series has no points in the window."""
        pts = self.series(name)
        if seconds is not None and pts:
            cut = pts[-1][0] - seconds
            pts = [p for p in pts if p[0] >= cut]
        if not pts:
            return None
        vals = [v for _, v in pts]
        dt = pts[-1][0] - pts[0][0]
        rate = (vals[-1] - vals[0]) / dt if dt > 0 else 0.0
        return {"n": len(vals), "last": vals[-1],
                "mean": sum(vals) / len(vals),
                "min": min(vals), "max": max(vals), "p95": _p95(vals),
                "rate_per_s": rate}

    # -------------------------------------------------------------- exports
    def export_jsonl(self, path) -> "Path":  # noqa: F821 — typing only
        """One JSON object per series per line:
        ``{"name": ..., "points": [[t, v], ...]}`` — grep/pandas-friendly
        offline format, also served by the metrics endpoint at
        ``/series.jsonl``."""
        from pathlib import Path
        path = Path(path)
        with self._mu:
            items = sorted((n, list(r)) for n, r in self._series.items())
        with open(path, "w") as f:
            for name, pts in items:
                f.write(json.dumps(
                    {"name": name,
                     "points": [[round(t, 6), v] for t, v in pts]}) + "\n")
        return path

    def to_jsonl(self) -> str:
        with self._mu:
            items = sorted((n, list(r)) for n, r in self._series.items())
        return "".join(
            json.dumps({"name": n,
                        "points": [[round(t, 6), v] for t, v in pts]}) + "\n"
            for n, pts in items)

    def stats(self) -> dict:
        """Registry-scope provider: the sampler observing itself."""
        with self._mu:
            n_series = len(self._series)
            n_points = sum(len(r) for r in self._series.values())
            return {"running": self.running, "interval_s": self.interval_s,
                    "capacity": self.capacity, "samples": self.samples,
                    "sample_errors": self.sample_errors,
                    "n_series": n_series, "points_retained": n_points}
