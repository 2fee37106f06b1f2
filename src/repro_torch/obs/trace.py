"""Span tracer: ring-buffered, disabled by default, Perfetto-exportable.

The port's copy of `repro.obs.trace`, with a `fence` for CUDA tensors in
place of the reference's `jax.block_until_ready`.

Where does a token's latency actually go — queue wait, chunk planning, jit
dispatch, pool scatter, retire? The per-silo counters answer "how much"
but never "when"; this module records *spans* (named, nested wall-clock
intervals) along the full request path and exports them as Chrome trace
events (the JSON the Perfetto UI at https://ui.perfetto.dev loads
directly), so a multi-request run becomes a zoomable timeline instead of
a table of percentiles.

Design constraints, in order:

  * **Zero cost when off.** Tracing is process-global and disabled by
    default; ``span()`` then returns a shared no-op context manager — one
    function call and one ``is None`` check per instrumentation site, no
    allocation. Instrumented hot loops (one span per engine step, not per
    token per slot) stay honest: the gateway benchmark machine-checks the
    enabled-tracing overhead under 3% tokens/s.
  * **Bounded when on.** Finished spans land in a ring buffer
    (``capacity`` spans, oldest dropped first, drops counted) so a
    long-lived frontend can leave tracing on without unbounded growth.
  * **Device time attributed, not hidden.** A CUDA launch returns
    before the device finishes; the next host op then blocks and the
    device time is mis-charged to *it*. ``fence(x)`` calls
    for the calling thread's current stream when ``x`` holds a CUDA
    tensor — only while tracing is enabled — inside the dispatch span, so
    a dispatch span means launch + device compute. Not the whole device:
    another replica's thread may be capturing a CUDA graph, and a device
    synchronize is illegal then.

Track layout in the export: pid 1 ("serving host") holds the host/engine
spans, one tid per engine replica (the gateway itself shares tid 0 with
replica 0, which it drives synchronously). pid 2 ("requests") holds one
tid per request: a ``req<gid>`` span covering submit -> retire with
``queued`` / ``running`` phase spans nested inside — the Fig 6/7 queue
story, but per request and zoomable.
"""
from __future__ import annotations

import json
import threading
import time
from collections import deque
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import torch

HOST_PID = 1        # gateway/engine/jit spans, tid = replica id
REQUEST_PID = 2     # request-lifetime spans, tid = request gid


class _Span:
    """One finished span. perf_counter seconds, duration >= 0."""
    __slots__ = ("name", "cat", "t0", "dur", "pid", "tid", "args")

    def __init__(self, name, cat, t0, dur, pid, tid, args):
        self.name = name
        self.cat = cat
        self.t0 = t0
        self.dur = dur
        self.pid = pid
        self.tid = tid
        self.args = args


class _ActiveSpan:
    """Context manager recording one span into its tracer on exit."""
    __slots__ = ("_tracer", "_name", "_cat", "_tid", "_args", "_t0")

    def __init__(self, tracer: "Tracer", name: str, cat: str, tid: int,
                 args: Optional[Dict[str, Any]]):
        self._tracer = tracer
        self._name = name
        self._cat = cat
        self._tid = tid
        self._args = args

    def __enter__(self) -> "_ActiveSpan":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self._tracer._record(_Span(
            self._name, self._cat, self._t0,
            time.perf_counter() - self._t0, HOST_PID, self._tid,
            self._args))
        return False


class _NullSpan:
    """Shared no-op span: the disabled-tracing fast path."""
    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NULL = _NullSpan()


class Tracer:
    def __init__(self, capacity: int = 1 << 16):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._ring: deque = deque(maxlen=self.capacity)
        self.recorded = 0           # spans ever recorded
        self.dropped = 0            # spans evicted by the ring
        self._track_names: Dict[Tuple[int, int], str] = {}
        self._epoch = time.perf_counter()
        # leaf lock: worker threads record spans concurrently in async-
        # gateway mode, and exporting iterates the ring — a concurrent
        # append during that iteration raises RuntimeError, corrupting the
        # Perfetto export. Nothing under this lock calls out of the tracer.
        self._mu = threading.Lock()

    @property
    def epoch(self) -> float:
        """perf_counter origin of the exported timeline: every event's
        ``ts`` is ``(t - epoch) * 1e6``. Public so companion exporters
        (the flight recorder's lifecycle instants) can place their events
        on the same clock as the span events."""
        return self._epoch

    # -------------------------------------------------------- recording
    def span(self, name: str, *, cat: str = "serve", tid: int = 0,
             **args) -> _ActiveSpan:
        return _ActiveSpan(self, name, cat, tid, args or None)

    def add_span(self, name: str, t0: float, t1: float, *,
                 cat: str = "serve", pid: int = HOST_PID, tid: int = 0,
                 args: Optional[Dict[str, Any]] = None):
        """Record a span retroactively from perf_counter endpoints — the
        request-lifetime spans are emitted this way at retire time, from
        the timestamps `GatewayMetrics` already keeps."""
        self._record(_Span(name, cat, t0, max(t1 - t0, 0.0), pid, tid,
                           args))

    def _record(self, span: _Span):
        with self._mu:
            self.recorded += 1
            if len(self._ring) == self.capacity:
                self.dropped += 1
            self._ring.append(span)

    def set_track_name(self, pid: int, tid: int, name: str):
        with self._mu:
            self._track_names[(pid, tid)] = name

    # -------------------------------------------------------- reduction
    def __len__(self) -> int:
        with self._mu:
            return len(self._ring)

    def stats(self) -> dict:
        """Flat counters for the unified metrics snapshot."""
        with self._mu:
            return {
                "enabled": True,
                "capacity": self.capacity,
                "spans_recorded": self.recorded,
                "spans_buffered": len(self._ring),
                "spans_dropped": self.dropped,
            }

    def events(self) -> list:
        """Chrome-trace-event dicts: ``ph="X"`` complete events (ts/dur
        in microseconds since the tracer's epoch) preceded by ``ph="M"``
        process/track name metadata, sorted by begin time."""
        with self._mu:
            track_names = dict(self._track_names)
            ring = list(self._ring)
        evs = []
        for pid, pname in ((HOST_PID, "serving host"),
                           (REQUEST_PID, "requests")):
            evs.append({"ph": "M", "name": "process_name", "pid": pid,
                        "tid": 0, "ts": 0,
                        "args": {"name": pname}})
        for (pid, tid), name in sorted(track_names.items()):
            evs.append({"ph": "M", "name": "thread_name", "pid": pid,
                        "tid": tid, "ts": 0, "args": {"name": name}})
        spans = sorted(ring, key=lambda s: (s.t0, -s.dur))
        for s in spans:
            ev = {"ph": "X", "name": s.name, "cat": s.cat,
                  "ts": (s.t0 - self._epoch) * 1e6, "dur": s.dur * 1e6,
                  "pid": s.pid, "tid": s.tid}
            if s.args:
                ev["args"] = dict(s.args)
            evs.append(ev)
        return evs

    def export(self, path) -> Path:
        """Write the Perfetto-loadable Chrome trace JSON."""
        path = Path(path)
        with open(path, "w") as f:
            json.dump({"traceEvents": self.events(),
                       "displayTimeUnit": "ms"}, f)
            f.write("\n")
        return path


# ------------------------------------------------------- process-global API
#
# One tracer per process keeps every instrumentation site a plain module
# call — no tracer threading through constructors that predate this
# subsystem — and matches the export format (one trace file per process).

_TRACER: Optional[Tracer] = None

# track names announced while no tracer was active. ReplicaWorker threads
# name their track once, at thread start — if tracing is enabled *after*
# start_workers (the common serve order: build fleet, then arm
# observability), a fresh Tracer would otherwise have no thread_name
# metadata for the per-replica tracks and every async-mode span would
# render on anonymous tracks. Bounded: only long-lived tracks (one per
# replica worker) announce through the module API.
_PENDING_TRACKS: Dict[Tuple[int, int], str] = {}
_PENDING_MU = threading.Lock()


def enable(capacity: int = 1 << 16) -> Tracer:
    """Install (and return) a fresh process-global tracer, pre-seeded
    with every track name announced before this call."""
    global _TRACER
    t = Tracer(capacity)
    with _PENDING_MU:
        t._track_names.update(_PENDING_TRACKS)
    _TRACER = t
    return _TRACER


def disable() -> Optional[Tracer]:
    """Stop tracing; returns the detached tracer so a caller can still
    export what was captured."""
    global _TRACER
    t, _TRACER = _TRACER, None
    return t


def active() -> Optional[Tracer]:
    return _TRACER


def enabled() -> bool:
    return _TRACER is not None


def span(name: str, *, cat: str = "serve", tid: int = 0, **args):
    """Instrumentation-site entry point: a real span while tracing is
    enabled, the shared no-op otherwise."""
    t = _TRACER
    if t is None:
        return _NULL
    return t.span(name, cat=cat, tid=tid, **args)


def add_span(name: str, t0: float, t1: float, **kw):
    t = _TRACER
    if t is not None:
        t.add_span(name, t0, t1, **kw)


def set_track_name(pid: int, tid: int, name: str):
    """Name a track on the active tracer AND remember it for tracers
    enabled later — a worker thread names its replica track exactly once,
    at thread start, which may precede `enable()`."""
    with _PENDING_MU:
        _PENDING_TRACKS[(pid, tid)] = name
    t = _TRACER
    if t is not None:
        t.set_track_name(pid, tid, name)


def _cuda_devices(x, out: set):
    if isinstance(x, torch.Tensor):
        if x.is_cuda:
            out.add(x.device)
    elif isinstance(x, dict):
        for v in x.values():
            _cuda_devices(v, out)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _cuda_devices(v, out)


def fence(x):
    """Wait for the device work behind `x` (tensors, possibly nested in
    dicts, lists and tuples; launched on this thread's current stream) —
    only while tracing, and only for CUDA tensors — so device time lands in
    the enclosing dispatch span instead of whichever host op touches the
    result next. Returns `x` either way."""
    if _TRACER is not None:
        devices: set = set()
        _cuda_devices(x, devices)
        for dev in devices:
            torch.cuda.current_stream(dev).synchronize()
    return x


def traced(name: Optional[str] = None, *, cat: str = "serve"):
    """Decorator form of `span` for whole-function spans."""
    def deco(fn):
        label = name or fn.__qualname__

        def wrapper(*a, **kw):
            with span(label, cat=cat):
                return fn(*a, **kw)
        wrapper.__name__ = fn.__name__
        wrapper.__qualname__ = fn.__qualname__
        wrapper.__doc__ = fn.__doc__
        return wrapper
    return deco
