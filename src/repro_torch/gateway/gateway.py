"""Request router: the queue-backed, multi-replica front door for serving.

This is the paper's queue/worker architecture applied to inference. Incoming
prompts are published to the durable `TaskQueue` (priorities, journaling,
lease-based redelivery) instead of an engine's naive FIFO list; dispatch
pulls tasks only when a replica has a free slot, so the queue — not engine
memory — holds the backlog. Engine replicas are the dispensable workers: a
replica that throws mid-decode is marked unhealthy, its leased requests are
nacked back to the queue and re-dispatched to surviving replicas (fail
forward, at-least-once). A pluggable `DispatchPolicy` decides placement:

  * round-robin      — rotate over replicas with free capacity
  * least-loaded     — fewest occupied slots first
  * prefix-affinity  — same prompt prefix -> same replica (cache locality)

Each request carries its own `SamplingParams` and exposes a `TokenStream`
plus a `RequestMetrics` record; gauges and percentiles come out through
`GatewayMetrics.summary()` / `core.reporting.gateway_dashboard`.

The port's copy of `repro.gateway.gateway`: the same placement, streaming,
retries and accounting over the port's `ServeEngine` replicas, which
`Gateway.build` creates on `device`.
"""
from __future__ import annotations

import itertools
import threading
import time
import uuid
import zlib
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core.queue import TaskQueue
from repro_torch.core.tasks import TaskSpec
from repro_torch.gateway.metrics import GatewayMetrics, RequestMetrics
from repro_torch.gateway.workers import ReplicaWorker, WorkerDied
from repro_torch.obs import trace as otrace
from repro_torch.obs.registry import MetricsRegistry
from repro_torch.gateway.sampler import GREEDY, SamplingParams
from repro_torch.gateway.streaming import TokenStream
from repro_torch.serve.engine import Request, ServeEngine


# --------------------------------------------------------------- replicas

class EngineReplica:
    """One ServeEngine plus the health/load view the dispatcher needs,
    and the lifecycle record the probation/reintegration manager keeps:
    when it failed, how often, and when it last rejoined the fleet."""

    def __init__(self, replica_id: int, engine: ServeEngine):
        self.replica_id = replica_id
        self.engine = engine
        self.healthy = True
        self.failed_at: Optional[float] = None      # perf_counter of death
        self.failures = 0
        self.reintegrations = 0
        self.reintegrated_at: Optional[float] = None
        self.last_error: Optional[str] = None

    def free_slots(self) -> int:
        return self.engine.free_slots()

    def load(self) -> int:
        return self.engine.active_count() + self.engine.pending_count()

    def __repr__(self):
        return (f"EngineReplica({self.replica_id}, load={self.load()}, "
                f"healthy={self.healthy})")


# --------------------------------------------------------------- policies

class DispatchPolicy:
    """Chooses a replica for a task among those with free capacity."""
    name = "base"

    def choose(self, eligible: List[EngineReplica], spec: TaskSpec,
               replicas: List[EngineReplica]) -> EngineReplica:
        raise NotImplementedError


class RoundRobin(DispatchPolicy):
    name = "round-robin"

    def __init__(self):
        self._turn = itertools.count()

    def choose(self, eligible, spec, replicas):
        return eligible[next(self._turn) % len(eligible)]


class LeastLoaded(DispatchPolicy):
    name = "least-loaded"

    def choose(self, eligible, spec, replicas):
        return min(eligible, key=lambda r: (r.load(), r.replica_id))


class PrefixAffinity(DispatchPolicy):
    """Requests sharing a prompt prefix land on the replica that actually
    holds their prefilled KV. Replicas with a paged cache are ranked by
    `ServeEngine.cached_prefix_tokens` — a radix-index probe returning how
    many leading prompt tokens are resident — so routing reflects real
    cached bytes, not a string heuristic. When nothing is cached anywhere
    (cold start, or dense replicas that always report 0), falls back to the
    original prefix-hash placement so future same-prefix traffic still
    converges on one replica, then least-loaded.
    """
    name = "prefix-affinity"

    def __init__(self, prefix_len: int = 8):
        self.prefix_len = prefix_len

    def preferred_id(self, prompt: List[int], n_replicas: int) -> int:
        key = zlib.crc32(repr(list(prompt[:self.prefix_len])).encode())
        return key % max(n_replicas, 1)

    @staticmethod
    def _cached_tokens(replica, prompt) -> int:
        """Radix probe, 0 for anything without one (dense engines report 0
        themselves; policy unit tests use bare stub replicas)."""
        eng = getattr(replica, "engine", None)
        probe = getattr(eng, "cached_prefix_tokens", None)
        return probe(prompt) if probe is not None else 0

    def choose(self, eligible, spec, replicas):
        prompt = spec.payload.get("prompt", [])
        best, best_tokens = None, 0
        for r in eligible:
            cached = self._cached_tokens(r, prompt)
            if cached > best_tokens or \
                    (cached == best_tokens and best is not None
                     and cached > 0 and r.load() < best.load()):
                best, best_tokens = r, cached
        if best is not None and best_tokens > 0:
            return best
        want = self.preferred_id(prompt, len(replicas))
        for r in eligible:
            if r.replica_id == want:
                return r
        return min(eligible, key=lambda r: (r.load(), r.replica_id))


POLICIES: Dict[str, Callable[[], DispatchPolicy]] = {
    RoundRobin.name: RoundRobin,
    LeastLoaded.name: LeastLoaded,
    PrefixAffinity.name: PrefixAffinity,
}


# --------------------------------------------------------------- brownout

@dataclass
class BrownoutConfig:
    """Graceful-degradation ladder thresholds. `depth_high` queue depth or
    any fresh deadline-shed marks a gateway step "hot"; `escalate_steps`
    consecutive hot steps climb one level, `cool_steps` consecutive calm
    steps descend one. Levels: 0 normal, 1 shed batch-tier intake
    (tier >= shed_tier_min rejected 503 "brownout"), 2 additionally run
    engines degraded (speculation + fused lanes off, chunk budget capped
    at `chunk_cap`) — premium traffic is the last thing touched."""
    depth_high: int = 8
    escalate_steps: int = 3
    cool_steps: int = 6
    shed_tier_min: int = 2
    chunk_cap: int = 8


class BrownoutController:
    """Owns the ladder state machine; `tick()` runs once per gateway step
    *before* dispatch so a shed decision applies to this step's intake.
    Every transition lands in the flight recorder."""

    def __init__(self, gateway: "Gateway", cfg: Optional[BrownoutConfig]):
        self.gw = gateway
        self.cfg = cfg or BrownoutConfig()
        self.level = 0
        self._hot = 0
        self._cool = 0
        self._last_sheds = 0
        self.transitions: List[Tuple[int, int]] = []   # (from, to)

    def tick(self, depth: int):
        sheds = self.gw._pressure_sheds
        hot = depth >= self.cfg.depth_high or sheds > self._last_sheds
        self._last_sheds = sheds
        if hot:
            self._hot += 1
            self._cool = 0
            if self._hot >= self.cfg.escalate_steps and self.level < 2:
                self._set_level(self.level + 1, depth)
                self._hot = 0
        else:
            self._cool += 1
            self._hot = 0
            if self._cool >= self.cfg.cool_steps and self.level > 0:
                self._set_level(self.level - 1, depth)
                self._cool = 0

    def _set_level(self, level: int, depth: int):
        prev, self.level = self.level, level
        self.transitions.append((prev, level))
        degraded = level >= 2
        for r in self.gw.replicas:
            if getattr(r.engine, "degraded", False) != degraded:
                r.engine.set_degraded(degraded,
                                      chunk_cap=self.cfg.chunk_cap)
        flight = self.gw.flight
        if flight is not None and hasattr(flight, "note"):
            flight.note("brownout", level=level, prev=prev, depth=depth,
                        dump=(level == 0 and prev > 0))

    def should_shed(self, tier: int) -> bool:
        return self.level >= 1 and tier >= self.cfg.shed_tier_min

    def stats(self) -> dict:
        return {"level": self.level, "transitions": len(self.transitions),
                "shed_tier_min": self.cfg.shed_tier_min}


# --------------------------------------------------------------- requests

@dataclass
class GatewayRequest:
    """Caller-facing handle: identity, stream, metrics, lifecycle status."""
    gid: int
    task_id: str
    prompt: List[int]
    max_new_tokens: int
    eos_id: Optional[int]
    sampling: SamplingParams
    priority: int = 0
    deadline: Optional[float] = None          # absolute perf_counter time
    tenant: Optional[str] = None              # multi-tenant attribution
    tier: int = 0                             # priority tier, 0 = premium
    stream: TokenStream = None
    metrics: RequestMetrics = None
    replica_id: Optional[int] = None
    engine_req: Optional[Request] = field(default=None, repr=False)

    @property
    def status(self) -> str:
        """queued | running | done | rejected | failed — single-sourced
        from the metrics record so handle and telemetry can never drift."""
        return self.metrics.status if self.metrics else "queued"

    @property
    def output(self) -> List[int]:
        return list(self.engine_req.output) if self.engine_req else []

    @property
    def error(self) -> Optional[BaseException]:
        """Request-scoped failure (e.g. sampling error), if any."""
        return self.engine_req.error if self.engine_req else None

    @property
    def done(self) -> bool:
        return self.status == "done"

    @property
    def finished(self) -> bool:
        return self.status in ("done", "rejected", "failed")


# ---------------------------------------------------------------- gateway

class Gateway:
    def __init__(self, engines: List[ServeEngine], *,
                 policy: str | DispatchPolicy = "round-robin",
                 journal_path: Optional[str] = None,
                 session_id: str = "serve",
                 lease_seconds: float = 30.0,
                 max_retries: int = 2,
                 admit_budget: Optional[int] = None,
                 probation_seconds: Optional[float] = None,
                 retry_backoff_s: float = 0.0,
                 poison_threshold: int = 2,
                 brownout: Optional[BrownoutConfig] = None,
                 slo=None, flight=None,
                 async_workers: bool = False,
                 worker_idle_s: float = 0.001,
                 async_step_wait_s: float = 0.002):
        """admit_budget enables admission control *by token budget* rather
        than slot count: a request's demand is prompt_len + max_new_tokens,
        and (a) demand > admit_budget (or > every replica's per-request
        token capacity) is terminally rejected with a 429-style event on
        its TokenStream, (b) dispatch holds a request in the queue while
        the fleet's committed tokens + demand would exceed the budget or no
        replica has enough free KV blocks for it. With admit_budget=None,
        paged replicas still gate dispatch on their free-block capacity
        (they cannot ring-wrap like the dense layout), but nothing is
        rejected up front.

        Lifecycle knobs (all opt-in; defaults preserve the historical
        "unhealthy forever" behavior):
          * probation_seconds — a failed replica rejoins after this long,
            warm-reset (fresh KV pool/radix/scheduler, empty slots).
          * retry_backoff_s   — base of the per-request exponential retry
            backoff (delay = base * 2**(retries-1)) after a replica crash.
          * poison_threshold  — a request that has killed this many
            *distinct* replicas is buried as failed(poison) instead of
            being offered to the next victim (0/None disables).
          * brownout          — a BrownoutConfig arming the graceful-
            degradation ladder (shed batch tier, then degrade engines,
            before premium traffic is ever touched).

        Concurrency (async_workers=True): each replica runs on its own
        `ReplicaWorker` thread pumping dispatch + decode, so device
        compute overlaps across replicas instead of serializing through
        `step()`. `step()` then becomes the consumer-side pump: it waits
        (up to async_step_wait_s) for worker progress, supervises worker
        threads (a dead thread is a crash fault on its replica, and the
        worker is respawned), and returns the live-request count — the
        same contract TokenStream iteration and run() rely on in sync
        mode. Shared gateway state is guarded by one re-entrant lock;
        the queue / metrics / registry / tracer locks are leaves only
        ever taken under it. Call `shutdown()` (or use the gateway as a
        context manager) to stop the workers."""
        if not engines:
            raise ValueError("Gateway needs at least one engine replica")
        self.admit_budget = admit_budget
        self.queue = TaskQueue(journal_path)
        self.session_id = session_id
        # per-process nonce, fed into each task's payload so TaskSpec.make
        # digests to a fresh task_id: without it, a second run sharing a
        # journal would reuse run 1's (acked) ids and its requests would
        # silently never dispatch
        self._run_id = uuid.uuid4().hex[:12]
        self.lease_seconds = lease_seconds
        self.max_retries = max_retries
        self.policy = (POLICIES[policy]() if isinstance(policy, str)
                       else policy)
        self.replicas = [EngineReplica(i, e) for i, e in enumerate(engines)]
        self.metrics = GatewayMetrics(
            total_slots=sum(e.slots for e in engines))
        self._gid = itertools.count()
        self._by_gid: Dict[int, GatewayRequest] = {}
        # task_id -> handle, for every request this process knows (own
        # submissions and adopted journal-recovered tasks alike) — the
        # durable task identity, immune to gid renumbering across runs
        self._by_task: Dict[str, GatewayRequest] = {}
        # task_id -> (gwreq, replica) for everything leased from the queue
        self._inflight: Dict[str, Tuple[GatewayRequest, EngineReplica]] = {}
        # --- replica lifecycle / retry state ---
        self.probation_seconds = probation_seconds
        self.retry_backoff_s = retry_backoff_s
        self.poison_threshold = poison_threshold
        self._victims: Dict[str, set] = {}      # task_id -> replica_ids killed
        self._backoff_n: Dict[str, int] = {}    # task_id -> crash-retry count
        self._retry_at: Dict[str, float] = {}   # task_id -> earliest redispatch
        self._pressure_sheds = 0                # deadline sheds, brownout input
        self.brownout = (BrownoutController(self, brownout)
                         if brownout is not None else None)
        # tasks already marked failed by _abort_queued; their leases expire
        # and redeliver (they are deliberately never acked), so remember
        # them or each expiry would re-fail / re-adopt the same task
        self._aborted: set = set()
        # --- concurrency ---
        # one re-entrant lock guards all gateway maps/lifecycle state; the
        # queue/metrics/registry/tracer/stream locks are strictly below it
        # in the acquisition order (they never call back into the gateway)
        self._lock = threading.RLock()
        # progress: a token landed / a request went terminal (consumers
        # blocked in _step_async wake). work_ready: new work or capacity
        # appeared (idle workers wake). Same underlying lock.
        self._progress = threading.Condition(self._lock)
        self._work_ready = threading.Condition(self._lock)
        self.async_workers = bool(async_workers)
        self.worker_idle_s = worker_idle_s
        self.async_step_wait_s = async_step_wait_s
        self._workers: List[ReplicaWorker] = []
        for r in self.replicas:
            self._wire(r)
        # one registry unifies the per-silo summaries: each silo keeps its
        # `*_summary()` API (they stay the tested, documented views) and is
        # registered here as a snapshot scope, so `snapshot()` is the single
        # coherent telemetry dict for the whole serving stack
        self.registry = MetricsRegistry()
        self.registry.register_scope("gateway", self.summary)
        self.registry.register_scope("kvcache", self.kvcache_summary)
        self.registry.register_scope("scheduler", self.scheduler_summary)
        self.registry.register_scope("speculation", self.spec_summary)
        self.registry.register_scope("engine_steps", self.engine_step_summary)
        self.registry.register_scope("graph", self.graph_summary)
        self.registry.register_scope("trace", self._trace_summary)
        self.registry.register_scope("workers", self.workers_summary)
        if self.brownout is not None:
            self.registry.register_scope("brownout", self.brownout.stats)
        # continuous-telemetry attachments (armed via start_sampler /
        # arm_ledger): the time-series sampler thread and the per-tenant
        # utilization ledger
        self.sampler = None
        self.ledger = None
        # SLO tracker / flight recorder: lifecycle observers with registry
        # scopes, attachable at construction or later (set_slo /
        # arm_flight_recorder) — `slo` may also be a {tier: SLOSpec} dict
        self.slo = None
        self.flight = None
        if slo is not None:
            self.set_slo(slo)
        if flight is not None:
            self.arm_flight_recorder(flight)

    def set_slo(self, slo) -> "SLOTracker":
        """Attach per-tier SLO tracking: every terminal request is judged
        live and the report rides `snapshot()["slo"]`. Accepts an
        `SLOTracker` or a {tier: SLOSpec} mapping."""
        from repro_torch.obs.slo import SLOTracker
        tracker = slo if isinstance(slo, SLOTracker) else SLOTracker(slo)
        self.slo = tracker
        self.metrics.observers.append(tracker)
        self.registry.register_scope("slo", tracker.report)
        return tracker

    def arm_flight_recorder(self, flight="flightrec") -> "FlightRecorder":
        """Attach + arm the anomaly flight recorder (its dump triggers
        include SLO breaches when `set_slo` was called first). Accepts a
        `FlightRecorder` or an output directory for a default one."""
        from repro_torch.obs.flight import FlightRecorder
        rec = flight if isinstance(flight, FlightRecorder) \
            else FlightRecorder(flight)
        if rec.slo is None:
            rec.slo = self.slo
        self.flight = rec
        rec.arm()
        if getattr(rec, "sampler", None) is None:
            rec.sampler = self.sampler      # recent series ride the dumps
        self.metrics.observers.append(rec)
        self.registry.register_scope("flight", rec.stats)
        return rec

    def arm_ledger(self) -> "UtilizationLedger":
        """Attach the per-tenant utilization ledger: every replica's engine
        reports each dispatch's measured step time split across slots by
        token share (plus KV block-seconds), and the report rides
        `snapshot()["ledger"]`. Idempotent."""
        from repro_torch.obs.ledger import UtilizationLedger
        if self.ledger is None:
            self.ledger = UtilizationLedger()
            for r in self.replicas:
                r.engine.ledger = self.ledger
            self.registry.register_scope("ledger", self.ledger.stats)
        return self.ledger

    def start_sampler(self, *, interval_s: float = 0.1,
                      capacity: int = 600) -> "TimeSeriesSampler":
        """Start the continuous-telemetry sampler thread: `snapshot()` is
        pulled every `interval_s` seconds into ring-buffered time series
        (see `obs.timeseries`). Stopped by `shutdown()`. Idempotent — a
        running sampler is returned as-is."""
        from repro_torch.obs.timeseries import TimeSeriesSampler
        if self.sampler is None:
            self.sampler = TimeSeriesSampler(
                self.snapshot, interval_s=interval_s, capacity=capacity)
            self.registry.register_scope("sampler", self.sampler.stats)
            if self.flight is not None and \
                    getattr(self.flight, "sampler", None) is None:
                self.flight.sampler = self.sampler
        self.sampler.start()
        return self.sampler

    @classmethod
    def build(cls, params, cfg, *, replicas: int = 1, batch_slots: int = 4,
              cache_len: int = 256, window=None, prefill_mode: str = "decode",
              kv_layout: str = "dense", block_size: int = 16,
              pool_blocks: Optional[int] = None,
              decode_kernel: Optional[str] = None, fused_tokens: int = 1,
              spec_tokens: int = 0, drafter=None,
              scheduler: str = "phased", chunk_budget: int = 32,
              device="cuda", **kw) -> "Gateway":
        """`replicas` port `ServeEngine`s on `device` (the params must be
        there already), sharing the weights; `**kw` goes to `__init__`.
        decode_kernel=None lets each engine take its own default: the
        hand-written kernel on the paged layout."""
        engines = [ServeEngine(params, cfg, batch_slots=batch_slots,
                               cache_len=cache_len, window=window,
                               prefill_mode=prefill_mode, kv_layout=kv_layout,
                               block_size=block_size, pool_blocks=pool_blocks,
                               decode_kernel=decode_kernel,
                               fused_tokens=fused_tokens,
                               spec_tokens=spec_tokens, drafter=drafter,
                               scheduler=scheduler, chunk_budget=chunk_budget,
                               device=device)
                   for _ in range(replicas)]
        return cls(engines, **kw)

    # ------------------------------------------------------------- intake
    def submit(self, prompt: List[int], *, max_new_tokens: int = 16,
               eos_id: Optional[int] = None,
               sampling: Optional[SamplingParams] = None,
               priority: int = 0, timeout_s: Optional[float] = None,
               tenant: Optional[str] = None, tier: int = 0,
               on_token: Optional[Callable[[int], None]] = None
               ) -> GatewayRequest:
        """Publish one prompt to the queue; returns a handle whose `stream`
        yields tokens as they decode (iterating pumps the gateway).
        `tenant`/`tier` tag the request for per-tenant telemetry and SLO
        judgment; they ride the durable payload, so journal recovery keeps
        the attribution."""
        with otrace.span("gateway.submit", prompt_len=len(prompt)), \
                self._lock:
            gwreq = self._submit_impl(
                prompt, max_new_tokens=max_new_tokens, eos_id=eos_id,
                sampling=sampling, priority=priority, timeout_s=timeout_s,
                tenant=tenant, tier=tier, on_token=on_token)
            self._work_ready.notify_all()
            return gwreq

    def _submit_impl(self, prompt, *, max_new_tokens, eos_id, sampling,
                     priority, timeout_s, tenant, tier,
                     on_token) -> GatewayRequest:
        gid = next(self._gid)
        sampling = sampling or GREEDY
        payload = {"gid": gid, "run": self._run_id, "prompt": list(prompt),
                   "max_new_tokens": max_new_tokens, "eos_id": eos_id,
                   "sampling": sampling.to_payload(),
                   "timeout_s": timeout_s,
                   "tenant": tenant, "tier": tier}
        spec = TaskSpec.make(self.session_id, "serve_lm", payload,
                             priority=priority, max_retries=self.max_retries)
        gwreq = GatewayRequest(
            gid=gid, task_id=spec.task_id, prompt=list(prompt),
            max_new_tokens=max_new_tokens, eos_id=eos_id, sampling=sampling,
            priority=priority,
            deadline=(time.perf_counter() + timeout_s
                      if timeout_s is not None else None),
            tenant=tenant, tier=tier,
            stream=TokenStream(pump=self.step, on_token=on_token))
        gwreq.metrics = self.metrics.submit(gid, len(prompt), tenant=tenant,
                                            tier=tier, deadline_s=timeout_s)
        self._by_gid[gid] = gwreq
        self._by_task[spec.task_id] = gwreq
        if self._over_capacity(self._demand(gwreq)):
            # terminal 429 before the queue ever sees it: the request can
            # never fit, journaling it would only leak an undeliverable task
            gwreq.stream.finish(reason="over_capacity", code=429)
            self.metrics.reject(gid, reason="over_capacity")
            return gwreq
        self.queue.put(spec)
        return gwreq

    # ------------------------------------------------------------ dispatch
    def _eligible(self) -> List[EngineReplica]:
        return [r for r in self.replicas if r.healthy and r.free_slots() > 0]

    # ------------------------------------------- admission by token budget
    @staticmethod
    def _demand(gwreq: GatewayRequest) -> int:
        """KV positions the request commits if admitted."""
        return len(gwreq.prompt) + gwreq.max_new_tokens

    def _over_capacity(self, need: int) -> bool:
        """True when the request can NEVER be admitted by any *healthy*
        replica: larger than the token budget, or than every healthy
        replica's per-request capacity. The capacity bound always binds
        for paged replicas (they cannot ring-wrap); a dense replica caps
        requests only once admission control is switched on (historical
        ring semantics otherwise). Leaving such a request queued would
        livelock dispatch — it would be leased, found unplaceable, and
        released at the queue head forever, starving everything behind
        it."""
        if self.admit_budget is not None and need > self.admit_budget:
            return True
        healthy = [r for r in self.replicas if r.healthy]
        if not healthy:
            return False        # total outage: _abort_queued handles it

        def possible(r: EngineReplica) -> bool:
            if r.engine.kv_layout != "paged" and self.admit_budget is None:
                return True
            return need <= r.engine.token_capacity()

        return not any(possible(r) for r in healthy)

    def _committed_tokens(self) -> int:
        return sum(self._demand(g) for g, _ in self._inflight.values())

    def _fits(self, replica: EngineReplica, need: int) -> bool:
        """Can this replica take the request *right now*? Dense replicas
        keep the historical contract (a free slot is enough); paged
        replicas must actually have the blocks."""
        eng = replica.engine
        if eng.kv_layout != "paged":
            return True
        return need <= eng.token_capacity() \
            and need <= eng.free_token_capacity()

    def _dispatch_ready(self):
        # the lock covers the whole pull-lease-place loop (including the
        # deferred-release finally), so a concurrent worker can never
        # observe a task leased from the queue but not yet in _inflight
        with self._lock, otrace.span("gateway.dispatch"):
            self._dispatch_ready_impl()

    def _dispatch_ready_impl(self):
        # tasks inside their post-crash backoff window are held *leased*
        # for the duration of this loop (a release would put them straight
        # back at the heap head and get() would hand them out again — an
        # infinite loop), then returned to the queue on the way out
        deferred: List[str] = []
        try:
            self._dispatch_loop(deferred)
        finally:
            for tid in deferred:
                self.queue.release(tid)

    def _dispatch_loop(self, deferred: List[str]):
        while True:
            eligible = self._eligible()
            if not eligible:
                return
            spec = self.queue.get(lease_seconds=self.lease_seconds)
            if spec is None:
                return
            if spec.task_id in self._inflight:
                # our own lease expired mid-decode (a step can outlast it,
                # e.g. first-step jit compile); the queue's get() above
                # already re-leased it — keep the existing placement rather
                # than double-placing a still-running request
                continue
            gwreq = self._by_task.get(spec.task_id)
            if gwreq is None:                   # replayed from the journal
                gwreq = self._adopt(spec)
            if gwreq.deadline is not None and \
                    time.perf_counter() > gwreq.deadline:
                self._pressure_sheds += 1
                self._reject(gwreq, spec.task_id)
                continue
            if self.brownout is not None and \
                    self.brownout.should_shed(gwreq.tier):
                # brownout ladder level >= 1: batch-tier intake is shed
                # with an explicit 503 so clients can back off and retry
                self._reject(gwreq, spec.task_id,
                             reason="brownout", code=503)
                continue
            retry_at = self._retry_at.get(spec.task_id)
            if retry_at is not None:
                if time.perf_counter() < retry_at:
                    deferred.append(spec.task_id)
                    continue
                del self._retry_at[spec.task_id]
            need = self._demand(gwreq)
            if self._over_capacity(need):       # adopted/journal-replayed
                self._reject(gwreq, spec.task_id,
                             reason="over_capacity", code=429)
                continue
            fit = [r for r in eligible if self._fits(r, need)]
            if self.admit_budget is not None and \
                    self._committed_tokens() + need > self.admit_budget:
                fit = []
            if not fit:
                # admissible, just not *now*: hand it back (no retry
                # penalty) and stop pulling — capacity frees as slots retire
                self.queue.release(spec.task_id)
                return
            replica = self.policy.choose(fit, spec, self.replicas)
            self._place(gwreq, spec.task_id, replica)

    def _place(self, gwreq: GatewayRequest, task_id: str,
               replica: EngineReplica):
        req = Request(gwreq.gid, list(gwreq.prompt), gwreq.max_new_tokens,
                      gwreq.eos_id, gwreq.sampling)
        gwreq.engine_req = req
        gwreq.replica_id = replica.replica_id
        if self.ledger is not None:
            # engine request_id == gid (set above), so the ledger can map
            # every step share back to this request's tenant/tier
            self.ledger.tag(gwreq.gid, gwreq.tenant, gwreq.tier)
        replica.engine.enqueue(req)
        self._inflight[task_id] = (gwreq, replica)
        self.metrics.dispatch(gwreq.gid, replica.replica_id)

    def _adopt(self, spec: TaskSpec) -> GatewayRequest:
        """Journal recovery: a pending task published by a previous gateway
        process has no in-memory handle here; rebuild one from the durable
        payload (the paper's crash recovery — at-least-once delivery). The
        task keeps its journal identity but gets a fresh local gid, and its
        timeout restarts from adoption (the original absolute deadline did
        not survive the crash)."""
        p = spec.payload
        gid = next(self._gid)
        gwreq = GatewayRequest(
            gid=gid, task_id=spec.task_id, prompt=list(p.get("prompt", [])),
            max_new_tokens=int(p.get("max_new_tokens", 16)),
            eos_id=p.get("eos_id"),
            sampling=SamplingParams.from_payload(p.get("sampling") or {}),
            priority=spec.priority,
            deadline=(time.perf_counter() + p["timeout_s"]
                      if p.get("timeout_s") is not None else None),
            tenant=p.get("tenant"), tier=int(p.get("tier", 0)),
            stream=TokenStream(pump=self.step))
        gwreq.metrics = self.metrics.submit(
            gid, len(gwreq.prompt), tenant=gwreq.tenant, tier=gwreq.tier,
            deadline_s=p.get("timeout_s"))
        self._by_gid[gid] = gwreq
        self._by_task[spec.task_id] = gwreq
        return gwreq

    def _reject(self, gwreq: GatewayRequest, task_id: str, *,
                reason: str = "deadline", code: Optional[int] = None):
        """Terminal rejection while queued — deadline passed, or admission
        control ruled the request un-servable (429). Dropped before burning
        decode compute (an ack removes it; the journal keeps the record)."""
        self.queue.ack(task_id)
        self._forget_retry_state(task_id)
        gwreq.stream.finish(reason=reason, code=code)
        self.metrics.reject(gwreq.gid, reason=reason)

    # -------------------------------------------------------- engine hooks
    def _wire(self, replica: EngineReplica):
        eng = replica.engine
        # the gateway keeps its own handles; don't also retain finished
        # Requests engine-side (a long-lived frontend would leak them)
        eng.retain_finished = False
        # each replica's engine spans land on their own track in the trace
        eng.trace_tid = replica.replica_id

        def on_token(req: Request, tok: int):
            # called from the replica's owner thread mid-`engine.step`,
            # which deliberately does NOT hold the gateway lock — take it
            # for the map lookup + bookkeeping (stream/metrics locks nest
            # under it), then wake consumers blocked in _step_async
            with self._lock:
                gwreq = self._by_gid.get(req.request_id)
                if gwreq is not None and gwreq.engine_req is req:
                    gwreq.stream.push(tok)
                    self.metrics.token(gwreq.gid)
                    self._progress.notify_all()

        def on_finish(req: Request):
            with self._lock:
                gwreq = self._by_gid.get(req.request_id)
                if gwreq is None or gwreq.engine_req is not req:
                    return
                self.queue.ack(gwreq.task_id)
                self._inflight.pop(gwreq.task_id, None)
                self._forget_retry_state(gwreq.task_id)
                if req.error is not None:
                    # request-scoped failure (e.g. sampling blew up on NaN
                    # logits): deterministic, so retry is pointless — ack
                    # and fail just this request, replica stays healthy
                    self.metrics.reject(gwreq.gid, status="failed",
                                        reason="request_error")
                else:
                    self.metrics.finish(gwreq.gid)
                gwreq.stream.finish()
                self._progress.notify_all()
                self._work_ready.notify_all()

        eng.on_token = on_token
        eng.on_finish = on_finish

    # ------------------------------------------------------------- failure
    def _fail_replica(self, replica: EngineReplica, err: Exception):
        """Dispensable-worker semantics: mark the replica unhealthy (with
        probation enabled it rejoins warm-reset after `probation_seconds`)
        and nack its leased requests so the queue re-delivers them (to
        other replicas, after their backoff window) or dead-letters after
        max_retries. A request that has now killed `poison_threshold`
        distinct replicas is buried instead of requeued — one poison
        request must not assassinate the fleet serially.

        Callers in async mode already hold the gateway lock; the
        re-entrant acquire here makes the sync path equally safe."""
        with self._lock:
            self._fail_replica_impl(replica, err)

    def _fail_replica_impl(self, replica: EngineReplica, err: Exception):
        replica.healthy = False
        replica.failed_at = time.perf_counter()
        replica.failures += 1
        replica.last_error = repr(err)
        if self.flight is not None:
            self.flight.note_replica_failure(replica.replica_id, repr(err))
        victims = [(tid, gwreq) for tid, (gwreq, r) in self._inflight.items()
                   if r is replica]
        for tid, gwreq in victims:
            del self._inflight[tid]
            replica.engine.evict(gwreq.engine_req)
            gwreq.engine_req = None
            gwreq.stream.restart()
            killed = self._victims.setdefault(tid, set())
            killed.add(replica.replica_id)
            if self.poison_threshold and len(killed) >= self.poison_threshold:
                self.queue.bury(tid)
                self._forget_retry_state(tid)
                gwreq.stream.finish(reason="poison")
                self.metrics.reject(gwreq.gid, status="failed",
                                    reason="poison")
                if self.flight is not None and hasattr(self.flight, "note"):
                    self.flight.note("poison_quarantine", task_id=tid,
                                     replicas=sorted(killed), dump=True)
                continue
            if self.queue.nack(tid):            # retries exhausted
                self._forget_retry_state(tid)
                gwreq.stream.finish()
                self.metrics.reject(gwreq.gid, status="failed",
                                    reason="retries_exhausted")
            else:
                if self.retry_backoff_s > 0:
                    n = self._backoff_n[tid] = self._backoff_n.get(tid, 0) + 1
                    self._retry_at[tid] = (time.perf_counter()
                                           + self.retry_backoff_s
                                           * 2 ** (n - 1))
                self.metrics.requeue(gwreq.gid)

    def _forget_retry_state(self, task_id: str):
        self._victims.pop(task_id, None)
        self._backoff_n.pop(task_id, None)
        self._retry_at.pop(task_id, None)

    # ---------------------------------------------------- replica lifecycle
    def _recovery_pending(self) -> bool:
        """True when a dead replica will rejoin on its own — i.e. probation
        is enabled and someone is serving it. Gates the total-outage abort:
        queued work should wait out a probation window, not be failed."""
        return self.probation_seconds is not None and any(
            not r.healthy and r.failed_at is not None for r in self.replicas)

    def _maybe_reintegrate(self):
        if self.probation_seconds is None:
            return
        with self._lock:
            now = time.perf_counter()
            for r in self.replicas:
                if not r.healthy and r.failed_at is not None and \
                        now - r.failed_at >= self.probation_seconds:
                    self._reintegrate(r)

    def _reintegrate(self, replica: EngineReplica):
        """Warm reintegration after probation: the engine is rebuilt from
        scratch — fresh KV pool + radix index + scheduler, every slot
        empty — because the crash left its device state unaccounted for.
        Prefix-affinity needs no explicit flush: placement probes the
        (now empty) radix index, so stale affinity can't route here.
        In async mode only the replica's own worker calls this, so the
        reset can never race that engine's dispatches."""
        with self._lock:
            replica.engine.reset()
            replica.healthy = True
            replica.failed_at = None
            replica.reintegrations += 1
            replica.reintegrated_at = time.perf_counter()
            if self.flight is not None and hasattr(self.flight, "note"):
                self.flight.note("replica_reintegrated",
                                 replica=replica.replica_id,
                                 failures=replica.failures)

    def _abort_queued(self):
        """No healthy replica remains: mark everything still waiting as
        failed locally so run() terminates and streams unblock — but do NOT
        ack, so the tasks stay pending in the journal and a restarted
        gateway sharing it redelivers them (at-least-once; an ack here
        would journal unexecuted work as success and lose it forever)."""
        with self._lock:
            while (spec := self.queue.get(lease_seconds=self.lease_seconds)) \
                    is not None:
                if spec.task_id in self._aborted:  # expired lease, redelivered
                    continue
                self._aborted.add(spec.task_id)
                gwreq = self._by_task.get(spec.task_id)
                if gwreq is None:               # replayed, never dispatched
                    gwreq = self._adopt(spec)
                if not gwreq.finished:
                    gwreq.stream.finish()
                    self.metrics.reject(gwreq.gid, status="failed",
                                        reason="outage")

    # ------------------------------------------------------ async workers
    def start_workers(self, gates: Optional[Dict[int, object]] = None):
        """Spawn one `ReplicaWorker` thread per replica and switch the
        gateway into async mode (idempotent for `async_workers=True`
        construction: `step()` calls this lazily). `gates` maps
        replica_id -> harness gate for deterministic tests."""
        with self._lock:
            if self._workers:
                raise RuntimeError("workers already started")
            self.async_workers = True
            gates = gates or {}
            for r in self.replicas:
                w = ReplicaWorker(self, r, gate=gates.get(r.replica_id),
                                  idle_wait_s=self.worker_idle_s)
                self._workers.append(w)
        for w in self._workers:
            w.start()

    def _ensure_workers(self):
        if not self._workers:
            self.start_workers()

    def shutdown(self):
        """Stop every worker thread and join them. Idempotent; the gateway
        can keep serving synchronously afterwards (async_workers stays
        set, so a later step() would restart the fleet — call again after
        clearing it if that is not wanted)."""
        with self._lock:
            workers, self._workers = self._workers, []
            for w in workers:
                w.stop()
            self._work_ready.notify_all()
            self._progress.notify_all()
        for w in workers:
            w.join(timeout=5.0)
        # outside the gateway lock: the sampler thread's snapshot() takes
        # it, so joining under the lock could deadlock on a mid-tick stop
        if self.sampler is not None:
            self.sampler.stop()

    def __enter__(self) -> "Gateway":
        return self

    def __exit__(self, *exc) -> bool:
        self.shutdown()
        return False

    def _respawn_worker(self, idx: int, dead: ReplicaWorker):
        """Supervision: a worker thread died uncleanly. Treat it as a crash
        fault on its replica (leases nack back to the queue) and give the
        replica a fresh worker carrying the same gate, so probation-based
        reintegration still has an owner to run on."""
        rep = dead.replica
        if rep.healthy:
            self._fail_replica(rep, WorkerDied(
                f"worker thread for replica {rep.replica_id} died"))
        if self.flight is not None and hasattr(self.flight, "note"):
            self.flight.note("worker_respawned", replica=rep.replica_id)
        w = ReplicaWorker(self, rep, gate=dead.gate,
                          idle_wait_s=dead.idle_wait_s)
        self._workers[idx] = w
        w.start()

    def _step_async(self) -> int:
        """Consumer-side pump while workers own dispatch + decode:
        supervise worker threads, tick the brownout ladder, handle total
        outage, then wait (briefly) for worker progress. Returns the live
        request count — the same contract as the synchronous step, so
        TokenStream iteration, run(), and owl.replay work unchanged."""
        with self._lock:
            self._ensure_workers()
            for i, w in enumerate(list(self._workers)):
                if not w.is_alive() and not w.stopped_deliberately \
                        and w.ident is not None:
                    self._respawn_worker(i, w)
            if self.brownout is not None:
                self.brownout.tick(self.queue.depth())
            if not any(r.healthy for r in self.replicas) \
                    and not self._recovery_pending():
                self._abort_queued()
                self.metrics.record_gauges(self.queue.depth(), 0)
                return 0
            live = len(self._inflight) + self.queue.depth()
            if live:
                self._work_ready.notify_all()
                self._progress.wait(timeout=self.async_step_wait_s)
                live = len(self._inflight) + self.queue.depth()
            active = sum(r.engine.active_count() for r in self.replicas
                         if r.healthy)
            self.metrics.record_gauges(self.queue.depth(), active)
            self._sample_pressure_gauges()
            return live

    def worker_stats(self) -> List[dict]:
        return [w.stats() for w in self._workers]

    def workers_summary(self) -> Optional[dict]:
        """Worker-health scope for `snapshot()` (None while no worker
        fleet exists — sync mode, or before start_workers): fleet totals
        plus the per-worker rows `reporting.worker_health_table`
        renders."""
        stats = self.worker_stats()
        if not stats:
            return None
        return {"n_workers": len(stats),
                "alive": sum(1 for s in stats if s["alive"]),
                "pumps": sum(s["pumps"] for s in stats),
                "engine_steps": sum(s["engine_steps"] for s in stats),
                "pump_errors": sum(s["pump_errors"] for s in stats),
                "per_worker": stats}

    def _sample_pressure_gauges(self):
        """Per-step pressure gauges (S6 of the telemetry PR): brownout
        ladder level and sheds-by-cause sampled into registry gauges every
        gateway step, so the time series shows the ladder's transitions
        and which pressure valve opened — the cumulative counters alone
        can't show *when*."""
        g = self.registry.gauge
        g("pressure.brownout_level").set(
            self.brownout.level if self.brownout is not None else 0)
        for cause, n in self.metrics.reject_reason_counts().items():
            g(f"pressure.shed_{cause}").set(n)

    # ---------------------------------------------------------------- run
    def step(self) -> int:
        """Reintegrate probationed replicas, tick the brownout ladder,
        dispatch ready work, decode one lockstep token on every healthy
        replica (extending its leases immediately before the dispatch),
        sample gauges. Returns the number of requests still live (active
        anywhere + waiting in the queue).

        With async_workers=True this delegates to `_step_async`: the
        worker threads do the dispatching and decoding, and step() just
        supervises and waits for progress."""
        if self.async_workers:
            return self._step_async()
        with otrace.span("gateway.step"):
            return self._step_sync()

    def _step_sync(self) -> int:
        self._maybe_reintegrate()
        if self.brownout is not None:
            self.brownout.tick(self.queue.depth())
        self._dispatch_ready()
        active = 0
        for replica in self.replicas:
            if not replica.healthy or not replica.engine.has_work():
                continue
            # extend THIS replica's leases right before its dispatch: a
            # fused/spec/mixed step (or a first-step jit compile) can
            # outlast lease_seconds, and a between-steps heartbeat would
            # let the queue redeliver a request that is still decoding
            mine = [tid for tid, (_, r) in self._inflight.items()
                    if r is replica]
            if mine:
                self.queue.extend_leases(mine, self.lease_seconds)
            try:
                active += replica.engine.step()
            except Exception as err:        # noqa: BLE001 — fail forward
                self._fail_replica(replica, err)
        # re-extend everything still leased after the dispatches: lease
        # expiry is lazy (materialized only inside queue.get()), so healing
        # deadlines here — before any next get() can run — means a lease
        # that lapsed *during* a long dispatch is never observed as expired
        if self._inflight:
            self.queue.extend_leases(list(self._inflight), self.lease_seconds)
        depth = self.queue.depth()
        self.metrics.record_gauges(depth, active)
        self._sample_pressure_gauges()
        if not any(r.healthy for r in self.replicas):
            if self._recovery_pending():
                # capacity returns by itself after probation; don't fail
                # queued work, just don't hot-spin while waiting
                time.sleep(min(0.001, self.probation_seconds))
                return len(self._inflight) + depth
            self._abort_queued()
            return 0
        # _inflight already covers every placed request (decoding or
        # engine-pending), so adding `active` again would double-count
        return len(self._inflight) + depth

    def run(self) -> List[GatewayRequest]:
        """Drive until every submitted request reaches a terminal state."""
        while self.step() > 0:
            pass
        return [g for g in self._by_gid.values() if g.done]

    def reap(self) -> List[GatewayRequest]:
        """Release terminal requests from the gateway's maps and return
        them. A long-lived frontend calls this after consuming results so
        handle/telemetry retention stays bounded (aggregate counters —
        completed/rejected/failed/retried — survive; the reaped requests'
        per-request latency records do not feed later summary() calls).
        Callers keep any handles they already hold."""
        out = []
        for gid, g in list(self._by_gid.items()):
            if g.finished:
                out.append(g)
                del self._by_gid[gid]
                self._by_task.pop(g.task_id, None)
                self.metrics.requests.pop(gid, None)
        return out

    # ---------------------------------------------------------------- info
    def requests(self) -> List[GatewayRequest]:
        return list(self._by_gid.values())

    def summary(self) -> dict:
        return self.metrics.summary()

    def kvcache_summary(self) -> Optional[dict]:
        """Aggregated hit/miss/eviction counters over every paged replica
        (None when the fleet is all-dense). Rendered by
        `core.reporting.kvcache_summary_table` / `gateway_dashboard`."""
        ms = [r.engine.cache_metrics for r in self.replicas
              if r.engine.cache_metrics is not None]
        if not ms:
            return None
        agg = ms[0]
        for m in ms[1:]:
            agg = agg.merge(m)
        return agg.as_dict()

    def scheduler_summary(self) -> Optional[dict]:
        """Aggregated chunked-prefill scheduler counters over every
        replica running with scheduler="chunked" (None when the fleet is
        all-phased): chunks and prefill tokens dispatched, prefills in
        flight, realized tokens-per-chunk — the dashboard's scheduler
        section renders this."""
        ms = [r.engine.scheduler_metrics for r in self.replicas
              if r.engine.scheduler_metrics is not None]
        if not ms:
            return None
        # sum every integer counter the scheduler reports (so a new
        # counter in ChunkedScheduler.metrics() aggregates automatically);
        # identity fields pass through, the one ratio is recomputed
        agg = {k: (sum(m[k] for m in ms) if isinstance(v, int) else v)
               for k, v in ms[0].items()}
        agg["chunk_budget"] = ms[0]["chunk_budget"]
        agg["tokens_per_chunk"] = (agg["prefill_tokens_chunked"]
                                   / agg["chunks_dispatched"]
                                   if agg["chunks_dispatched"] else 0.0)
        return agg

    def spec_summary(self) -> Optional[dict]:
        """Aggregated speculative-decoding counters over every replica
        running with spec_tokens > 0 (None when none do): fleet-level
        acceptance rate and realized tokens-per-dispatch for the
        dashboard's speculation section."""
        ms = [r.engine.spec_metrics for r in self.replicas
              if r.engine.spec_metrics is not None]
        if not ms:
            return None
        agg = {k: sum(m[k] for m in ms)
               for k in ("dispatches", "tokens_drafted", "tokens_accepted",
                         "tokens_emitted", "tokens_rolled_back")}
        agg["spec_tokens"] = ms[0]["spec_tokens"]
        agg["drafter"] = ms[0]["drafter"]
        agg["acceptance_rate"] = (agg["tokens_accepted"]
                                  / agg["tokens_drafted"]
                                  if agg["tokens_drafted"] else 0.0)
        agg["tokens_per_dispatch"] = (agg["tokens_emitted"]
                                      / agg["dispatches"]
                                      if agg["dispatches"] else 0.0)
        return agg

    def engine_step_summary(self) -> Optional[dict]:
        """Host-side engine step-latency histograms, merged exactly across
        replicas (bucket-wise addition) and keyed by step type — prefill /
        decode / fused / spec / mixed — then flattened to
        ``<kind>_<stat>`` (ms) for the snapshot. None before any step."""
        merged: Dict[str, object] = {}
        for r in self.replicas:
            for kind, h in r.engine.step_times.items():
                prev = merged.get(kind)
                merged[kind] = h if prev is None else prev.merge(h)
        if not merged:
            return None
        out: Dict[str, object] = {}
        for kind in sorted(merged):
            for stat, v in merged[kind].summary().items():
                out[f"{kind}_{stat}"] = v
        return out

    def graph_summary(self) -> Optional[dict]:
        """The fused decode graphs' captures, replays and eager warm-up
        runs, summed over replicas (`serve.graph.FusedDecodeGraph`); None
        without a fused lane. A recapture after a replica's `reset()`
        shows as a second capture."""
        graphs = [r.engine._decode_fused for r in self.replicas
                  if r.engine._decode_fused is not None]
        if not graphs:
            return None
        return {k: sum(getattr(g, k) for g in graphs)
                for k in ("captures", "replays", "warmup_runs")}

    def _trace_summary(self) -> Optional[dict]:
        """Span-tracer counters while tracing is on (None otherwise)."""
        tr = otrace.active()
        return tr.stats() if tr is not None else None

    def snapshot(self) -> dict:
        """The one coherent telemetry dict: every registered scope —
        gateway request/latency stats, kvcache counters, scheduler and
        speculation counters, engine step-latency histograms, tracer
        state — in a single nested mapping. Scopes whose feature is off
        are omitted. Rendered by `core.reporting.unified_dashboard`."""
        return self.registry.snapshot()
