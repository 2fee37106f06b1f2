"""Anomaly flight recorder: post-mortem traces for runs nobody traced.

The span tracer answers "where did the latency go" — but only if
``--trace`` was on when the anomaly happened, and anomalies do not
announce themselves in advance. The flight recorder closes that gap the
way an aircraft FDR does: a bounded ring of evidence records
continuously (the span ring buffer, which the tracer already keeps, plus
the last-K request lifecycle events), and when a *trigger* fires the
whole ring is dumped to a Perfetto-loadable ``flightrec-*.json``. The
run that sheds half a tier or double-finishes a request leaves behind a
zoomable timeline of its final seconds, even though tracing was "off".

Triggers:

  * **SLO breach** — a finished request violated its tier's `SLOSpec`
    (needs an attached tracker/spec set).
  * **Illegal lifecycle transition** — `GatewayMetrics` refused a state
    move (double-finish, token-after-reject); always a bug.
  * **Replica failure** — the gateway failed a replica over
    (`Gateway._fail_replica` reports it here).
  * **Deadline-shed spike** — more than `shed_spike[0]` deadline sheds
    inside a sliding `shed_spike[1]`-second window: the overload
    signature, as distinct from an isolated straggler.

Arming installs a process tracer only if none is active (and only that
owned tracer is torn down on disarm), so ``--flight-recorder`` composes
with ``--trace``: with both, the dump and the full trace share one span
ring. Dumps are capped at `max_dumps` per recorder so a pathological run
cannot fill the disk with near-identical post-mortems.

The recorder is a `GatewayMetrics` lifecycle observer (same protocol as
`SLOTracker`): attach via `Gateway.arm_flight_recorder(...)` or append
to `GatewayMetrics.observers` directly.
"""
from __future__ import annotations

import json
import logging
import time
from collections import deque
from pathlib import Path
from typing import TYPE_CHECKING, Dict, List, Optional, Tuple

from repro_torch.obs import trace as otrace
from repro_torch.obs.slo import SLOTracker

if TYPE_CHECKING:   # duck-typed at runtime: obs must not import gateway
    from repro_torch.gateway.metrics import RequestMetrics

now = time.perf_counter

logger = logging.getLogger("repro_torch.obs.flight")


class FlightRecorder:
    def __init__(self, out_dir=".", *, slo: Optional[SLOTracker] = None,
                 events_capacity: int = 512, trace_capacity: int = 1 << 14,
                 shed_spike: Tuple[int, float] = (8, 1.0),
                 max_dumps: int = 4):
        self.out_dir = Path(out_dir)
        self.slo = slo
        self.events: deque = deque(maxlen=int(events_capacity))
        self.trace_capacity = int(trace_capacity)
        self.shed_spike = shed_spike
        self.max_dumps = int(max_dumps)
        self.dumps: List[Path] = []
        self.trigger_counts: Dict[str, int] = {}
        self.suppressed = 0         # triggers past the max_dumps cap
        self.armed = False
        self._own_tracer = None
        self._shed_ts: deque = deque()
        # optional TimeSeriesSampler: when attached (Gateway.start_sampler
        # wires it), every dump also carries the recent metric series as
        # Perfetto counter tracks — the post-mortem shows queue depth,
        # active slots, and the pressure gauges *leading up to* the
        # anomaly, not just the spans during it
        self.sampler = None
        self.series_window_s = 30.0
        self.series_prefixes = ("gateway.queue_depth",
                                "gateway.active_slots", "pressure.")

    # ------------------------------------------------------------- arming
    def arm(self) -> "FlightRecorder":
        """Start recording evidence. Installs a process tracer only when
        none is active, so an explicit ``--trace`` keeps its own (larger)
        ring and the dump simply reads from it."""
        if otrace.active() is None:
            self._own_tracer = otrace.enable(self.trace_capacity)
        self.armed = True
        return self

    def disarm(self):
        """Stop recording; tears down the tracer only if we installed it
        (and it is still the active one)."""
        self.armed = False
        if self._own_tracer is not None \
                and otrace.active() is self._own_tracer:
            otrace.disable()
        self._own_tracer = None

    # ------------------------------------------------- lifecycle observer
    def lifecycle(self, kind: str, m: RequestMetrics):
        if not self.armed:
            return
        t = m.finish_t if kind in ("finish", "reject") else now()
        ev = {"t": t, "kind": kind, "request_id": m.request_id,
              "tier": m.tier, "status": m.status}
        if m.tenant is not None:
            ev["tenant"] = m.tenant
        if m.finish_reason is not None:
            ev["reason"] = m.finish_reason
        self.events.append(ev)
        if kind == "illegal":
            self.trigger("illegal_transition", request=m)
        elif kind == "finish" and self.slo is not None:
            violations = self.slo.spec_for(m.tier).violations(m)
            if violations:
                self.trigger("slo_breach", request=m,
                             violations=violations)
        elif kind == "reject" and m.status == "rejected" \
                and m.finish_reason != "over_capacity":
            n, window = self.shed_spike
            self._shed_ts.append(t)
            while self._shed_ts and self._shed_ts[0] < t - window:
                self._shed_ts.popleft()
            if len(self._shed_ts) >= n:
                self._shed_ts.clear()       # re-arm the window
                self.trigger("shed_spike", request=m,
                             sheds_in_window=n, window_s=window)

    def note_replica_failure(self, replica_id: int, error: str = ""):
        """Gateway hook: a replica was failed over."""
        if not self.armed:
            return
        self.events.append({"t": now(), "kind": "replica_failure",
                            "replica_id": replica_id, "error": error})
        self.trigger("replica_failure", replica_id=replica_id, error=error)

    def note(self, kind: str, *, dump: bool = False, **ctx):
        """Generic evidence event from outside the request lifecycle —
        brownout transitions, replica reintegration, poison quarantine,
        injected chaos faults. Rides the same ring as lifecycle events
        (host track in the Perfetto dump); `dump=True` also fires a
        trigger so the episode leaves a post-mortem file."""
        if not self.armed:
            return
        self.events.append({"t": now(), "kind": kind, **ctx})
        if dump:
            self.trigger(kind, **{k: v for k, v in ctx.items()
                                  if isinstance(v, (str, int, float, bool))})

    # ------------------------------------------------------------- dumping
    def trigger(self, reason: str, *, request: Optional[RequestMetrics] = None,
                **ctx) -> Optional[Path]:
        """Dump the evidence rings to ``flightrec-<seq>-<reason>.json``.
        Returns the path, or None once `max_dumps` is reached (the
        trigger is still counted, so `stats()` shows the suppression)."""
        self.trigger_counts[reason] = self.trigger_counts.get(reason, 0) + 1
        if len(self.dumps) >= self.max_dumps:
            self.suppressed += 1
            return None
        tracer = otrace.active() or self._own_tracer
        events = list(tracer.events()) if tracer is not None else []
        epoch = tracer.epoch if tracer is not None else \
            min((e["t"] for e in self.events), default=0.0)
        events.extend(self._instants(epoch))
        events.extend(self._counter_events(epoch))
        marker = {"ph": "i", "name": f"TRIGGER:{reason}", "cat": "flightrec",
                  "ts": (now() - epoch) * 1e6, "pid": otrace.HOST_PID,
                  "tid": 0, "s": "g",
                  "args": {k: v for k, v in ctx.items()}}
        if request is not None:
            marker["args"].update(request_id=request.request_id,
                                  tier=request.tier, tenant=request.tenant)
        events.append(marker)
        self.out_dir.mkdir(parents=True, exist_ok=True)
        path = self.out_dir / \
            f"flightrec-{len(self.dumps):03d}-{reason}.json"
        with open(path, "w") as f:
            json.dump({"traceEvents": events, "displayTimeUnit": "ms",
                       "otherData": {"trigger": reason, **{
                           k: v for k, v in ctx.items()
                           if isinstance(v, (str, int, float, bool))}}}, f)
            f.write("\n")
        self.dumps.append(path)
        logger.warning("flight recorder: %s -> %s", reason, path)
        return path

    def _instants(self, epoch: float) -> list:
        """The lifecycle ring as Perfetto instant events, placed on the
        request tracks (thread scope) so each sits next to that request's
        spans; replica failures land on the host track."""
        out = []
        for e in self.events:
            ts = (e["t"] - epoch) * 1e6
            if e["kind"] == "replica_failure":
                out.append({"ph": "i", "name": "replica_failure",
                            "cat": "lifecycle", "ts": ts,
                            "pid": otrace.HOST_PID,
                            "tid": e.get("replica_id", 0), "s": "p",
                            "args": {"error": e.get("error", "")}})
                continue
            args = {k: v for k, v in e.items() if k not in ("t", "kind")}
            rid = e.get("request_id")
            if rid is None:
                # request-less generic events (brownout, reintegration,
                # chaos faults) land on the host track
                out.append({"ph": "i", "name": e["kind"], "cat": "lifecycle",
                            "ts": ts, "pid": otrace.HOST_PID, "tid": 0,
                            "s": "p", "args": args})
                continue
            out.append({"ph": "i", "name": e["kind"], "cat": "lifecycle",
                        "ts": ts, "pid": otrace.REQUEST_PID,
                        "tid": rid, "s": "t", "args": args})
        return out

    def _counter_events(self, epoch: float) -> list:
        """The sampler's recent window as Perfetto ``ph="C"`` counter
        events (one counter track per series, host process) so the dump
        shows the metric time series alongside the spans. No-op without
        an attached sampler."""
        if self.sampler is None:
            return []
        out = []
        for prefix in self.series_prefixes:
            for name, pts in self.sampler.recent(self.series_window_s,
                                                 prefix=prefix).items():
                for t, v in pts:
                    out.append({"ph": "C", "name": name, "cat": "series",
                                "ts": (t + self.sampler.epoch - epoch) * 1e6,
                                "pid": otrace.HOST_PID, "tid": 0,
                                "args": {"value": v}})
        return out

    # ------------------------------------------------------------- scope
    def stats(self) -> dict:
        """Flat counters for the "flight" scope of the unified snapshot."""
        return {
            "armed": self.armed,
            "events_buffered": len(self.events),
            "dumps": len(self.dumps),
            "suppressed": self.suppressed,
            "triggers": dict(self.trigger_counts),
            "last_dump": str(self.dumps[-1]) if self.dumps else None,
        }
