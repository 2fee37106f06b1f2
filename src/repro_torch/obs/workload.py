"""Trace-driven workload generator: what "millions of users" look like.

The serving benches so far offered synthetic uniform load — every prompt
the same few tokens, every request submitted up front. Production traffic
is nothing like that, and neither are the failures it induces: heavy-tailed
prompt/output lengths (one 4k-token prompt behind fifty chat turns),
arrival bursts (diurnal peaks, retry storms), and multiple tenants whose
priority tiers contend for the same KV pool. This module generates such a
workload from a seeded spec, replays it against a `Gateway` in real
(scaled) time, and round-trips it through a JSON *trace file* — so a run
that exposed a scheduling bug is replayable bit-for-bit, and a recorded
production trace can drive the same harness (the standardized,
reproducible-methodology point of the comparative-framework papers).

Pieces:

  * `TenantSpec` — one tenant: name, priority tier (0 = most latency-
    sensitive), traffic weight, and a shared per-tenant prompt prefix
    length (tenants with system prompts are what radix prefix caches eat).
  * `WorkloadSpec` — the generator knobs: Poisson arrivals whose rate is
    modulated by a diurnal burst window (raised-cosine bump of
    `burst_mult`x between `burst_start_frac` and `burst_end_frac` of the
    duration), log-normal prompt/output lengths clamped to the serving
    shape, per-tier deadlines.
  * `generate(spec)` — the seeded trace: a list of `WorkloadRequest`s
    sorted by arrival time. Same spec + seed -> same trace, always.
  * `save_trace` / `load_trace` — the JSON trace-file round trip.
  * `replay(gateway, requests)` — paced submission: each request is
    submitted when its arrival offset passes (wall clock, optionally
    scaled), tagged with its tenant/tier, prioritized by tier, and
    deadline-shed through the gateway's existing timeout/429 machinery.
"""
from __future__ import annotations

import json
import math
import time
import zlib
from dataclasses import asdict, dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np


@dataclass(frozen=True)
class TenantSpec:
    """One tenant of the multi-tenant workload."""
    name: str
    tier: int = 0               # 0 = highest-priority / tightest SLO
    weight: float = 1.0         # share of offered traffic
    prefix_len: int = 0         # shared leading tokens (system prompt)


# the default cast: two latency-sensitive interactive tenants, two
# standard API tenants, one bulk/batch tenant — enough tiers to make
# priority contention and per-tier SLO attainment visible
DEFAULT_TENANTS = (
    TenantSpec("acme-chat", tier=0, weight=2.0, prefix_len=12),
    TenantSpec("nimbus-ide", tier=0, weight=1.0, prefix_len=8),
    TenantSpec("initech-api", tier=1, weight=2.0, prefix_len=6),
    TenantSpec("umbrella-api", tier=1, weight=1.0),
    TenantSpec("hooli-batch", tier=2, weight=2.0),
)


@dataclass(frozen=True)
class WorkloadSpec:
    """Seeded generator knobs. All lengths are in tokens, times in
    seconds; arrival times are offsets from the start of the run."""
    seed: int = 0
    duration_s: float = 2.0
    base_rate_rps: float = 12.0
    # diurnal burst: arrival rate swells to burst_mult x base inside
    # [burst_start_frac, burst_end_frac) of the duration (raised cosine,
    # so the ramp is smooth like a compressed diurnal peak, not a step)
    burst_mult: float = 4.0
    burst_start_frac: float = 0.35
    burst_end_frac: float = 0.65
    # heavy-tailed lengths: log-normal, clamped to the serving shape
    prompt_len_mu: float = 2.2      # exp(2.2) ~ 9 tokens median
    prompt_len_sigma: float = 0.8
    prompt_len_max: int = 40
    output_len_mu: float = 1.4      # exp(1.4) ~ 4 tokens median
    output_len_sigma: float = 0.7
    output_len_max: int = 12
    vocab_size: int = 1024
    # per-tier deadline (submit -> must finish), None = no deadline.
    # Deadlines feed the gateway's shed path: a queued request whose
    # deadline passed is terminally rejected instead of burning decode.
    deadline_s_by_tier: Dict[int, Optional[float]] = field(
        default_factory=dict)
    tenants: Sequence[TenantSpec] = DEFAULT_TENANTS


@dataclass
class WorkloadRequest:
    """One generated request of the trace."""
    arrival_s: float
    tenant: str
    tier: int
    prompt: List[int]
    max_new_tokens: int
    deadline_s: Optional[float] = None      # relative to submission


def _burst_factor(spec: WorkloadSpec, t: float) -> float:
    """Arrival-rate multiplier at offset t: 1 outside the burst window,
    rising smoothly to burst_mult at its center (raised cosine)."""
    t0 = spec.burst_start_frac * spec.duration_s
    t1 = spec.burst_end_frac * spec.duration_s
    if not (t0 <= t < t1) or t1 <= t0:
        return 1.0
    phase = (t - t0) / (t1 - t0)
    return 1.0 + (spec.burst_mult - 1.0) * 0.5 * (1 - math.cos(
        2 * math.pi * phase))


def _tenant_prefix(tenant: TenantSpec, vocab: int) -> List[int]:
    """Deterministic shared prefix per tenant (its "system prompt"):
    same tenant -> same tokens across runs and processes, so replaying a
    trace reproduces the radix-cache hit pattern too."""
    h = zlib.crc32(tenant.name.encode())
    return [(h + 7 * j) % vocab for j in range(tenant.prefix_len)]


def _clamped_lognormal(rng: np.random.Generator, mu: float, sigma: float,
                       hi: int) -> int:
    return int(min(max(round(float(rng.lognormal(mu, sigma))), 1), hi))


def generate(spec: WorkloadSpec) -> List[WorkloadRequest]:
    """The seeded trace: Poisson arrivals at the burst-modulated rate
    (thinning over the peak rate), each assigned a tenant by weight and
    log-normal prompt/output lengths."""
    rng = np.random.default_rng(spec.seed)
    tenants = list(spec.tenants)
    weights = np.asarray([t.weight for t in tenants], float)
    weights = weights / weights.sum()
    prefixes = {t.name: _tenant_prefix(t, spec.vocab_size) for t in tenants}
    peak = spec.base_rate_rps * max(spec.burst_mult, 1.0)
    out: List[WorkloadRequest] = []
    t = 0.0
    while True:
        t += float(rng.exponential(1.0 / peak))
        if t >= spec.duration_s:
            break
        # thinning: accept at the instantaneous rate / peak rate
        if float(rng.random()) >= \
                spec.base_rate_rps * _burst_factor(spec, t) / peak:
            continue
        tenant = tenants[int(rng.choice(len(tenants), p=weights))]
        prefix = prefixes[tenant.name]
        p_len = _clamped_lognormal(rng, spec.prompt_len_mu,
                                   spec.prompt_len_sigma, spec.prompt_len_max)
        suffix = [int(x) for x in rng.integers(0, spec.vocab_size,
                                               size=max(p_len, 1))]
        out.append(WorkloadRequest(
            arrival_s=t, tenant=tenant.name, tier=tenant.tier,
            prompt=(prefix + suffix)[:max(p_len + len(prefix), 1)],
            max_new_tokens=_clamped_lognormal(
                rng, spec.output_len_mu, spec.output_len_sigma,
                spec.output_len_max),
            deadline_s=spec.deadline_s_by_tier.get(tenant.tier)))
    out.sort(key=lambda r: r.arrival_s)
    return out


# ------------------------------------------------------------- trace files

TRACE_VERSION = 1


def save_trace(path, requests: Sequence[WorkloadRequest],
               spec: Optional[WorkloadSpec] = None) -> Path:
    """Write the replayable JSON trace file. The generating spec rides
    along (when known) so a trace documents its own provenance."""
    doc = {"version": TRACE_VERSION,
           "spec": None if spec is None else {
               **asdict(spec),
               "deadline_s_by_tier": {
                   str(k): v for k, v in spec.deadline_s_by_tier.items()},
               "tenants": [asdict(t) for t in spec.tenants]},
           "requests": [asdict(r) for r in requests]}
    path = Path(path)
    with open(path, "w") as f:
        json.dump(doc, f)
        f.write("\n")
    return path


def load_trace(path) -> List[WorkloadRequest]:
    """Load a trace file written by `save_trace` (or hand-built to the
    same schema: a "requests" list of arrival_s/tenant/tier/prompt/
    max_new_tokens[/deadline_s] records)."""
    with open(path) as f:
        doc = json.load(f)
    if not isinstance(doc, dict) or "requests" not in doc:
        raise ValueError(f"{path}: not a workload trace (no 'requests')")
    version = doc.get("version", TRACE_VERSION)
    if version > TRACE_VERSION:
        raise ValueError(f"{path}: trace version {version} is newer than "
                         f"this reader ({TRACE_VERSION})")
    out = []
    for r in doc["requests"]:
        out.append(WorkloadRequest(
            arrival_s=float(r["arrival_s"]), tenant=str(r["tenant"]),
            tier=int(r["tier"]), prompt=[int(x) for x in r["prompt"]],
            max_new_tokens=int(r["max_new_tokens"]),
            deadline_s=(None if r.get("deadline_s") is None
                        else float(r["deadline_s"]))))
    out.sort(key=lambda r: r.arrival_s)
    return out


# ----------------------------------------------------------------- replay

def tier_priority(tier: int) -> int:
    """Queue priority for a tier (the TaskQueue serves higher numbers
    first; tiers count the other way — 0 is the premium tier)."""
    return -int(tier)


def replay(gateway, requests: Sequence[WorkloadRequest], *,
           time_scale: float = 1.0, sampling=None) -> list:
    """Paced replay against a gateway: submit each request when its
    (scaled) arrival offset passes, stepping the gateway in between so
    decode progresses while later arrivals are still pending — the
    open-loop shape real traffic has, not the all-at-once closed loop of
    the older benches. Returns the GatewayRequest handles in trace order.

    time_scale < 1 compresses the trace (arrivals come faster); deadlines
    are scaled the same way so shed behaviour is preserved."""
    reqs = sorted(requests, key=lambda r: r.arrival_s)
    handles = []
    t0 = time.perf_counter()
    i = 0
    while i < len(reqs):
        now = time.perf_counter() - t0
        due = reqs[i].arrival_s * time_scale
        if now < due:
            # keep decoding while we wait; only sleep when fully idle
            if gateway.step() == 0:
                time.sleep(min(due - now, 0.002))
            continue
        r = reqs[i]
        i += 1
        handles.append(gateway.submit(
            r.prompt, max_new_tokens=r.max_new_tokens,
            tenant=r.tenant, tier=r.tier, priority=tier_priority(r.tier),
            timeout_s=(None if r.deadline_s is None
                       else r.deadline_s * time_scale),
            sampling=sampling))
    gateway.run()
    return handles
