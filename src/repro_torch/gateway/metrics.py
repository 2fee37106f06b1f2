"""Serving telemetry: per-request latency tracking + gateway-level gauges.

Per request we record the queue/decode timeline (submit -> dispatch ->
first token -> finish) from which TTFT, per-token latency, and tokens/sec
derive. Per gateway step we sample queue depth and slot occupancy gauges.
`summary()` reduces everything to the throughput/latency-percentile shape
the paper's Fig 6/7 dashboards use; `core/reporting.py` renders it
(`gateway_dashboard`) with the same ascii/markdown machinery as the
training-sweep figures.
"""
from __future__ import annotations

import logging
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.obs import trace as otrace

logger = logging.getLogger("repro_torch.gateway")


def now() -> float:
    return time.perf_counter()


def percentile(xs: Sequence[float], p: float) -> Optional[float]:
    """Exact percentile over raw samples; None (NOT NaN) when the series
    is empty — NaN used to leak through `summary()` into dashboard rows
    and JSON files, where it is both unreadable and invalid JSON. None
    survives `json.dump` as null and renders as an em-dash in
    `core.reporting` tables."""
    if not xs:
        return None
    return float(np.percentile(np.asarray(xs, float), p))


def _ms(x: Optional[float]) -> Optional[float]:
    """Seconds -> milliseconds, passing empty-series None through."""
    return None if x is None else x * 1e3


# Legal request-lifecycle transitions. The strict chain is
# queued -> running -> done|failed|rejected; the extra edges are the
# gateway's real recovery paths: running -> queued is a replica-failure
# requeue, queued -> rejected|failed covers deadline expiry / 429
# admission rejection / total-outage abort before dispatch. Terminal
# states have no exits — a caller trying to leave one is a lifecycle bug
# (e.g. double-finish), which is logged and counted instead of silently
# overwriting `status` and double-counting the aggregate counters.
_TRANSITIONS = {
    "queued": ("running", "rejected", "failed"),
    "running": ("queued", "done", "rejected", "failed"),
    "done": (),
    "rejected": (),
    "failed": (),
}


@dataclass
class RequestMetrics:
    request_id: int
    prompt_len: int = 0
    submit_t: Optional[float] = None
    dispatch_t: Optional[float] = None
    first_token_t: Optional[float] = None
    finish_t: Optional[float] = None
    token_ts: List[float] = field(default_factory=list)
    retries: int = 0
    replica_id: Optional[int] = None
    status: str = "queued"        # queued | running | done | rejected | failed
    tenant: Optional[str] = None  # multi-tenant attribution (None = untagged)
    tier: int = 0                 # priority tier, 0 = premium
    deadline_s: Optional[float] = None   # submit-relative deadline, if any
    finish_reason: Optional[str] = None  # why a terminal reject/fail happened

    @property
    def ttft(self) -> Optional[float]:
        """Time to first token, measured from submit (includes queueing)."""
        if self.first_token_t is None or self.submit_t is None:
            return None
        return self.first_token_t - self.submit_t

    @property
    def queue_wait(self) -> Optional[float]:
        if self.dispatch_t is None or self.submit_t is None:
            return None
        return self.dispatch_t - self.submit_t

    @property
    def n_tokens(self) -> int:
        return len(self.token_ts)

    @property
    def inter_token_latencies(self) -> List[float]:
        return [b - a for a, b in zip(self.token_ts, self.token_ts[1:])]

    # per-request ITL distribution: the gaps THIS caller experienced
    # between consecutive streamed tokens. itl_max is the request's worst
    # stall — the number a chunked-prefill scheduler exists to bound
    # (a peer's monolithic prompt prefill lands here on the phased path).
    @property
    def itl_p50(self) -> Optional[float]:
        itls = self.inter_token_latencies
        return percentile(itls, 50) if itls else None

    @property
    def itl_p95(self) -> Optional[float]:
        itls = self.inter_token_latencies
        return percentile(itls, 95) if itls else None

    @property
    def itl_max(self) -> Optional[float]:
        itls = self.inter_token_latencies
        return max(itls) if itls else None

    @property
    def tokens_per_sec(self) -> Optional[float]:
        if self.finish_t is None or self.first_token_t is None:
            return None
        span = self.finish_t - self.first_token_t
        if span <= 0 or self.n_tokens <= 1:
            return None
        return (self.n_tokens - 1) / span


class GatewayMetrics:
    """Collects RequestMetrics plus step-sampled gauges for one gateway."""

    # one gauge tuple is sampled per gateway step; a long-lived frontend
    # would otherwise grow the list one entry per decoded token forever,
    # so retention is windowed (the dashboard plots recent history anyway)
    MAX_GAUGES = 100_000

    def __init__(self, total_slots: int = 0):
        # guards every lifecycle mutation and summary() — worker threads
        # report lifecycle edges concurrently in async-gateway mode. A leaf
        # lock: nothing called under it ever re-enters the gateway.
        self._mu = threading.RLock()
        self.requests: Dict[int, RequestMetrics] = {}
        self.total_slots = total_slots
        # (t, queue_depth, active_slots) sampled once per gateway step
        self.gauges: deque = deque(maxlen=self.MAX_GAUGES)
        self.dispatched = 0
        self.completed = 0
        self.rejected = 0
        self.failed = 0
        self.retried = 0
        self.illegal_transitions = 0
        # terminal rejections split by cause ("deadline", "brownout",
        # "over_capacity", "request_error", ...): the per-cause counters
        # behind the gateway's shed-by-cause gauges, so the time series
        # shows WHICH pressure valve opened, not just that one did
        self.reject_reasons: Dict[str, int] = {}
        self._t0: Optional[float] = None
        # lifecycle observers: callables `(kind, m)` invoked after each
        # lifecycle edge with the event kind ("submit", "dispatch",
        # "first_token", "requeue", "finish", "reject", "illegal") and the
        # RequestMetrics involved. SLO trackers and the flight recorder
        # attach here — they watch the stream instead of polling, so a
        # breach can trigger a dump while the evidence is still buffered.
        self.observers: List = []

    def _notify(self, kind: str, m: RequestMetrics):
        # snapshot: an observer may detach itself (or attach another) from
        # inside its lifecycle hook, and another thread may register one
        # concurrently — iterating the live list would silently skip the
        # observer after a removal's index shift
        for obs in tuple(self.observers):
            try:
                obs.lifecycle(kind, m)
            except Exception:       # observers must never break serving
                logger.exception("lifecycle observer failed on %s", kind)

    def _transition(self, m: RequestMetrics, new: str) -> bool:
        """Move `m` along the request lifecycle; refuse, log, and count an
        illegal move (the caller must then skip its side effects — counter
        bumps, timestamps — so aggregates stay consistent)."""
        if new in _TRANSITIONS[m.status]:
            m.status = new
            return True
        self.illegal_transitions += 1
        logger.error("request %d: illegal state transition %s -> %s "
                     "(keeping %s)", m.request_id, m.status, new, m.status)
        assert _TRANSITIONS.get(new) is not None, \
            f"unknown request state {new!r}"
        self._notify("illegal", m)
        return False

    # ------------------------------------------------------------ lifecycle
    def submit(self, request_id: int, prompt_len: int, *,
               tenant: Optional[str] = None, tier: int = 0,
               deadline_s: Optional[float] = None) -> RequestMetrics:
        with self._mu:
            t = now()
            if self._t0 is None:
                self._t0 = t
            m = RequestMetrics(request_id, prompt_len, submit_t=t,
                               tenant=tenant, tier=tier,
                               deadline_s=deadline_s)
            self.requests[request_id] = m
            self._notify("submit", m)
            return m

    def dispatch(self, request_id: int, replica_id: int):
        with self._mu:
            m = self.requests[request_id]
            if not self._transition(m, "running"):
                return
            if m.dispatch_t is not None:      # re-dispatch after failure
                m.retries += 1
                self.retried += 1
                m.token_ts.clear()
                m.first_token_t = None
            m.dispatch_t = now()
            m.replica_id = replica_id
            self.dispatched += 1
            self._notify("dispatch", m)

    def token(self, request_id: int):
        with self._mu:
            m = self.requests[request_id]
            t = now()
            first = m.first_token_t is None
            if first:
                m.first_token_t = t
            m.token_ts.append(t)
            if first:
                self._notify("first_token", m)

    def requeue(self, request_id: int):
        """Replica failure sent the request back to the queue."""
        with self._mu:
            m = self.requests[request_id]
            if self._transition(m, "queued"):
                self._notify("requeue", m)

    def finish(self, request_id: int):
        with self._mu:
            m = self.requests[request_id]
            if not self._transition(m, "done"):
                return
            m.finish_t = now()
            self.completed += 1
            self._emit_request_trace(m)
            self._notify("finish", m)

    def reject(self, request_id: int, *, status: str = "rejected",
               reason: Optional[str] = None):
        with self._mu:
            m = self.requests[request_id]
            if not self._transition(m, status):
                return
            m.finish_t = now()
            m.finish_reason = reason
            cause = reason or "unspecified"
            self.reject_reasons[cause] = self.reject_reasons.get(cause, 0) + 1
            if status == "rejected":
                self.rejected += 1
            else:
                self.failed += 1
            self._emit_request_trace(m)
            self._notify("reject", m)

    def _emit_request_trace(self, m: RequestMetrics):
        """When tracing is enabled, lay the request's whole lifetime onto
        its own track (pid `REQUEST_PID`, tid = gid): one submit->retire
        span with queued/running phase spans nested inside — so the
        Perfetto timeline answers "where did THIS request's latency go"
        next to the host-side engine spans."""
        tr = otrace.active()
        if tr is None or m.submit_t is None or m.finish_t is None:
            return
        pid, tid = otrace.REQUEST_PID, m.request_id
        tr.set_track_name(pid, tid, f"req{m.request_id}")
        args = {"status": m.status, "prompt_len": m.prompt_len,
                "tokens": m.n_tokens, "replica": m.replica_id,
                "retries": m.retries, "tier": m.tier}
        if m.tenant is not None:
            args["tenant"] = m.tenant
        if m.finish_reason is not None:
            args["reason"] = m.finish_reason
        tr.add_span(f"req{m.request_id}", m.submit_t, m.finish_t,
                    cat="request", pid=pid, tid=tid, args=args)
        if m.dispatch_t is not None:
            tr.add_span("queued", m.submit_t, m.dispatch_t, cat="request",
                        pid=pid, tid=tid)
            tr.add_span("running", m.dispatch_t, m.finish_t, cat="request",
                        pid=pid, tid=tid)
        else:       # rejected before ever dispatching
            tr.add_span("queued", m.submit_t, m.finish_t, cat="request",
                        pid=pid, tid=tid)

    def reject_reason_counts(self) -> Dict[str, int]:
        """Copy of the terminal-rejection-by-cause counters (thread-safe;
        the gateway samples these into per-step pressure gauges)."""
        with self._mu:
            return dict(self.reject_reasons)

    def record_gauges(self, queue_depth: int, active_slots: int):
        with self._mu:      # summary() iterates the deque; appends during
            # that iteration would raise RuntimeError mid-reduction
            self.gauges.append((now(), queue_depth, active_slots))

    # ------------------------------------------------------------ reduction
    def summary(self) -> dict:
        with self._mu:
            return self._summary_locked()

    def _summary_locked(self) -> dict:
        done = [m for m in self.requests.values() if m.status == "done"]
        ttfts = [m.ttft for m in done if m.ttft is not None]
        itls = [lat for m in done for lat in m.inter_token_latencies]
        # per-request worst stall, then percentiles ACROSS requests: the
        # pooled itl percentiles above dilute a rare long stall with every
        # fast gap in the run, while stall_p95 answers "how bad does the
        # worst pause get for a typical unlucky request"
        stalls = [m.itl_max for m in done if m.itl_max is not None]
        total_tokens = sum(m.n_tokens for m in done)
        t_end = max((m.finish_t for m in done), default=now())
        duration = (t_end - self._t0) if self._t0 is not None else 0.0
        util = ([a / self.total_slots for _, _, a in self.gauges]
                if self.total_slots else [])
        depths = [d for _, d, _ in self.gauges]
        return {
            "n_requests": len(self.requests),
            "dispatched": self.dispatched,
            "completed": self.completed,
            "rejected": self.rejected,
            "failed": self.failed,
            "retried": self.retried,
            "illegal_transitions": self.illegal_transitions,
            "total_tokens": total_tokens,
            "duration_s": duration,
            "throughput_tok_s": total_tokens / duration if duration else 0.0,
            "throughput_req_s": len(done) / duration if duration else 0.0,
            # empty series report None (rendered as an em-dash, serialized
            # as JSON null), never NaN — see `percentile`
            "ttft_p50_ms": _ms(percentile(ttfts, 50)),
            "ttft_p90_ms": _ms(percentile(ttfts, 90)),
            "ttft_p99_ms": _ms(percentile(ttfts, 99)),
            "itl_p50_ms": _ms(percentile(itls, 50)),
            "itl_p95_ms": _ms(percentile(itls, 95)),
            "itl_p99_ms": _ms(percentile(itls, 99)),
            "itl_max_ms": (max(itls) * 1e3 if itls else None),
            "stall_p50_ms": _ms(percentile(stalls, 50)),
            "stall_p95_ms": _ms(percentile(stalls, 95)),
            "stall_max_ms": (max(stalls) * 1e3 if stalls else None),
            "mean_queue_depth": float(np.mean(depths)) if depths else 0.0,
            "mean_slot_utilization": float(np.mean(util)) if util else 0.0,
            # instantaneous (last-step) gauges: the time-series sampler
            # turns these into the live queue-depth/active-slots series
            # the watch sparklines and flight dumps plot
            "queue_depth": self.gauges[-1][1] if self.gauges else 0,
            "active_slots": self.gauges[-1][2] if self.gauges else 0,
        }
