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

  * **Device time by region.** ``region(name)`` marks a stretch of a
    model step's launches (``attn.proj``, ``attn.core``, ``ffn``,
    ``moe.*``, ``logits``). While an engine step runs a ``device_timer``
    on its thread, a region records CUDA timing events at its ends on the
    step's stream (``perf_counter`` stamps on the CPU, where ops are
    synchronous; ``switch`` to the next adjacent region shares one) and
    never synchronizes; the step resolves them after the host read it
    already makes and adds ``device={"total_ms": ..., "<region>": ms,
    ...}`` to its span. While a CUDA graph is captured
    (``GraphCapture``), regions become external timing events, i.e. event
    nodes of the graph, which the graph hands to the step that replays it.
    An engine times one eager step in four and every fused dispatch
    (``device_timer(every=)``): marks and their reading are host work.
  * **On the profiler's clock.** While a ``torch.profiler`` records, every
    span and eager region also opens a ``record_function`` range of the
    same name, so a device trace shows which program span holds the
    device idle.

Track layout in the export: pid 1 ("serving host") holds the host/engine
spans, one tid per engine replica (the gateway itself shares tid 0 with
replica 0, which it drives synchronously). pid 2 ("requests") holds one
tid per request: a ``req<gid>`` span covering submit -> retire with
``queued`` / ``running`` phase spans nested inside — the Fig 6/7 queue
story, but per request and zoomable.
"""
from __future__ import annotations

import contextlib
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


def _mirror(name: str):
    """A `torch.profiler` range named `name`, entered, while a profiler
    records; None otherwise."""
    if not torch._C._autograd._profiler_enabled():
        return None
    rf = torch.autograd.profiler.record_function(name)
    rf.__enter__()
    return rf


class _ActiveSpan:
    """Context manager recording one span into its tracer on exit."""
    __slots__ = ("_tracer", "_name", "_cat", "_tid", "_args", "_t0",
                 "_range")

    def __init__(self, tracer: "Tracer", name: str, cat: str, tid: int,
                 args: Optional[Dict[str, Any]]):
        self._tracer = tracer
        self._name = name
        self._cat = cat
        self._tid = tid
        self._args = args

    def __enter__(self) -> "_ActiveSpan":
        self._range = _mirror(self._name)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter()
        if self._range is not None:
            self._range.__exit__(None, None, None)
        self._tracer._record(_Span(
            self._name, self._cat, self._t0, t1 - self._t0, HOST_PID,
            self._tid, self._args))
        return False

    def add_args(self, **args):
        """Add args before the span ends (a step's device times, known
        only after its host read)."""
        if self._args is None:
            self._args = {}
        self._args.update(args)


class _NullSpan:
    """Shared no-op span, region and step timer: the disabled-tracing fast
    path."""
    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def add_args(self, **args):
        pass

    def switch(self, name: str):
        pass

    def stop(self):
        pass

    def attach(self, span):
        pass


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
    _rearm()
    return _TRACER


def disable() -> Optional[Tracer]:
    """Stop tracing; returns the detached tracer so a caller can still
    export what was captured."""
    global _TRACER
    t, _TRACER = _TRACER, None
    _rearm()
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


# ------------------------------------------------------- device regions
#
# An engine step opens a `device_timer` on its thread and the model code's
# `region`s record into it; the step resolves them after its host read.
# While a thread captures a CUDA graph (`GraphCapture`), regions become
# the graph's own event nodes, and the graph hands them to the step timer
# of the thread that replays it.

_LOCAL = threading.local()  # .timer: the thread's StepTimer; .capture: the
                            # regions of the graph being captured; .mute:
                            # inside an untimed step (`cover(False)`)
_ARMED = False              # tracing on, or some thread capturing regions
_CAPTURES = 0
_ARM_MU = threading.Lock()


def _rearm():
    global _ARMED
    with _ARM_MU:
        _ARMED = _TRACER is not None or _CAPTURES > 0


def _graph_event():
    ev = torch.cuda.Event(enable_timing=True, external=True)
    ev.record()
    return ev


def _event_ms(a, b) -> float:
    return a.elapsed_time(b)


def _clock_ms(a, b) -> float:
    return 1e3 * (b - a)


class _Region:
    """A run of adjacent segments on one stream, each named, each timed
    from one mark to the next: `switch(name)` ends the current segment
    and starts the next with a single mark. Finished segments go to
    `sink` as (name, mark, mark)."""
    __slots__ = ("_name", "_sink", "_mark", "_eager", "_a", "_range")

    def __init__(self, name: str, sink: list, mark, eager: bool):
        self._name = name
        self._sink = sink
        self._mark = mark
        self._eager = eager     # run now, not captured: mirror it
        self._range = None

    def __enter__(self) -> "_Region":
        if self._eager:
            self._range = _mirror(self._name)
        self._a = self._mark()
        return self

    def _end(self):
        b = self._mark()
        self._sink.append((self._name, self._a, b))
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        return b

    def switch(self, name: str):
        b = self._end()
        self._name, self._a = name, b
        if self._eager:
            self._range = _mirror(name)

    def __exit__(self, *exc) -> bool:
        self._end()
        return False


class StepTimer:
    """One engine step's stream time and its regions' device time.
    Marks are CUDA timing events on the step's stream (the current one
    when the timer starts), or perf_counter stamps where the step runs on
    the CPU. Nothing synchronizes: `attach` reads the marks after the
    step's own host read, and then hands the events back to its thread's
    pool for the next step."""

    def __init__(self, device: torch.device):
        self._events: list = []
        if device.type == "cuda":
            self._stream = torch.cuda.current_stream(device)
            pools = _LOCAL.__dict__.setdefault("pools", {})
            self._pool = pools.setdefault(self._stream.device_index, [])
            self.mark = self._event
            self._ms = _event_ms
        else:
            self.mark = time.perf_counter
            self._ms = _clock_ms
        self.regions: list = []     # (name, mark, mark)
        self._replays: list = []    # (graph's regions, mark, mark)
        self._end = None
        self._start = self.mark()

    def _event(self):
        pool = self._pool
        ev = pool.pop() if pool else torch.cuda.Event(enable_timing=True)
        ev.record(self._stream)
        self._events.append(ev)
        return ev

    def replayed(self, regions: list, a, b):
        """A graph replayed between marks `a` and `b` of this stream, its
        regions' events refreshed by the replay."""
        self._replays.append((regions, a, b))

    def stop(self):
        """Mark the end of the step's launches (before its host read)."""
        if self._end is None:
            self._end = self.mark()

    def read(self) -> Dict[str, float]:
        """{"total_ms": stream time of the step (of its graph replays, if
        it replayed one), "<region>": ms summed over its segments}."""
        self.stop()
        ms = self._ms
        segments = list(self.regions)
        if self._replays:
            total = sum(ms(a, b) for _, a, b in self._replays)
            for regions, _, _ in self._replays:
                segments += regions
        else:
            total = ms(self._start, self._end)
        out = {"total_ms": total}
        for name, a, b in segments:
            out[name] = out.get(name, 0.0) + ms(a, b)
        if self._events:
            self._pool.extend(self._events)
            self._events = []
        return out

    def attach(self, span):
        """Read the marks, add them to `span` as its `device` arg, and end
        this thread's timing."""
        if getattr(_LOCAL, "timer", None) is self:
            _LOCAL.timer = None
        span.add_args(device=self.read())


def device_timer(device, every: int = 1):
    """Time this thread's engine step by region until `attach`: a
    StepTimer while tracing is on, the shared no-op otherwise. With
    `every` > 1, one call in `every` of this thread's such calls (the
    first, then every `every`-th) times its step; the others are the
    no-op."""
    if _TRACER is None:
        return _NULL
    if every > 1:
        n = _LOCAL.__dict__.get("sampled", 0)
        _LOCAL.sampled = n + 1
        if n % every:
            return _NULL
    tm = StepTimer(torch.device(device))
    _LOCAL.timer = tm
    return tm


def step_timer() -> Optional[StepTimer]:
    """This thread's running step timer (None while tracing is off)."""
    if _TRACER is None:
        return None
    return getattr(_LOCAL, "timer", None)


def stop_timer():
    """Mark the end of this thread's step's launches, if it is timed."""
    tm = step_timer()
    if tm is not None:
        tm.stop()


def _open(name: str, eager: bool = True):
    loc = _LOCAL
    if getattr(loc, "mute", False):
        return _NULL
    sink = getattr(loc, "capture", None)
    if sink is not None:
        return _Region(name, sink, _graph_event, False)
    tm = getattr(loc, "timer", None)
    if tm is None or _TRACER is None:
        return _NULL
    return _Region(name, tm.regions, tm.mark, eager)


def region(name: str):
    """Instrumentation-site entry point for a stretch of a step's device
    work: a timed region (see `_Region`; `switch` moves on to the next
    adjacent one) inside a timed step or a graph capture, the shared
    no-op otherwise."""
    if not _ARMED:
        return _NULL
    return _open(name)


class _Mute:
    __slots__ = ("_was",)

    def __enter__(self):
        self._was = getattr(_LOCAL, "mute", False)
        _LOCAL.mute = True
        return self

    def __exit__(self, *exc) -> bool:
        _LOCAL.mute = self._was
        return False


def cover(timed: bool):
    """One step of a multi-step dispatch. Timed, it is a "covered_ms"
    segment and its regions record; untimed, its regions are muted, so a
    fused dispatch times its first step only (each event between two
    kernels costs device time). Shares of such a dispatch divide by its
    "covered_ms"."""
    if not _ARMED:
        return _NULL
    return _open("covered_ms", eager=False) if timed else _Mute()


class GraphCapture:
    """A CUDA graph's warm-up and captures on this thread. The thread's
    step timer is set aside for the whole of it (warm-up runs are not the
    step's work); inside `recording()` regions are external timing events
    (`regions`), which a capture turns into event nodes of its graph,
    whatever the tracing state."""

    def __init__(self):
        self.regions: list = []
        self._timer = None

    def __enter__(self) -> "GraphCapture":
        self._timer = getattr(_LOCAL, "timer", None)
        _LOCAL.timer = None
        return self

    def __exit__(self, *exc) -> bool:
        _LOCAL.timer = self._timer
        return False

    @contextlib.contextmanager
    def recording(self):
        global _CAPTURES
        _LOCAL.capture = self.regions
        with _ARM_MU:
            _CAPTURES += 1
        _rearm()
        try:
            yield self
        finally:
            _LOCAL.capture = None
            with _ARM_MU:
                _CAPTURES -= 1
            _rearm()
